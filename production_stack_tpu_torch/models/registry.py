"""Model registry: arch name -> (init_params, apply)."""

from __future__ import annotations

from typing import Callable, Tuple

from production_stack_tpu_torch.models.config import ModelConfig


def build_model(cfg: ModelConfig) -> Tuple[Callable, Callable]:
    """Return (init_params, apply) for ``cfg.arch``."""
    if cfg.arch == "llama":
        from production_stack_tpu_torch.models import llama as mod

        return mod.init_params, mod.apply
    if cfg.arch in ("opt", "mixtral"):
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported to the torch engine yet "
            f"(the other-architectures slice)")
    raise ValueError(f"Unknown arch {cfg.arch!r}")
