"""Colored per-module logging.

Capability parity with reference src/vllm_router/log.py (init_logger with
colored level names); implementation is our own formatter on stdlib logging.
"""

import logging
import os
import sys

_FORMAT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

_COLORS = {
    "DEBUG": "\033[36m",     # cyan
    "INFO": "\033[32m",      # green
    "WARNING": "\033[33m",   # yellow
    "ERROR": "\033[31m",     # red
    "CRITICAL": "\033[41m",  # red background
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool):
        super().__init__(_FORMAT, _DATEFMT)
        self._use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        if self._use_color:
            color = _COLORS.get(record.levelname)
            if color:
                record = logging.makeLogRecord(record.__dict__)
                record.levelname = f"{color}{record.levelname}{_RESET}"
        return super().format(record)


def _default_level() -> int:
    name = os.environ.get("TPU_STACK_LOG_LEVEL", "INFO").upper()
    return getattr(logging, name, logging.INFO)


def init_logger(name: str, level: "int | str | None" = None) -> logging.Logger:
    """Create (or fetch) a logger with a colored stream handler attached once."""
    logger = logging.getLogger(name)
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    logger.setLevel(level if level is not None else _default_level())
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter(sys.stderr.isatty()))
        logger.addHandler(handler)
        logger.propagate = False
    return logger
