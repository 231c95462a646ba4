"""ASR engine server: OpenAI-compatible audio transcription over the
port's Whisper model.

The counterpart of ``production_stack_tpu/engine/asr_server.py``, on the
standard library (``http.server.ThreadingHTTPServer``, one thread a
connection; the multipart body parsed by hand). The router proxies
multipart audio to it, as it does to the reference's Whisper pods.
Routes, with the JAX server's bodies and status codes:

- ``POST /v1/audio/transcriptions``: multipart with ``file`` (WAV),
  ``model``, ``response_format`` (``json``, ``text`` or
  ``verbose_json``) and ``language``. 400 for a missing file, a model
  not served here, an unknown format or audio that does not decode; 413
  for a body over 64 MiB (the JAX server's ``client_max_size``).
- ``GET /v1/models`` (``"task": "transcription"``), so the router's
  discovery probe picks the model up.
- ``GET /health``, ``GET /is_sleeping`` and ``GET /metrics``
  (``tpu:asr_requests_total``, ``tpu:asr_audio_seconds_total``,
  ``vllm:num_requests_running`` (requests in flight) and
  ``vllm:num_requests_waiting``).

A preset name (``tiny-whisper``, ``whisper-small``) serves weights drawn
from ``--seed`` and decodes byte-tokenizer ids; a local HF checkpoint
directory serves its weights (``models/weights.py::
load_whisper_checkpoint``) under its own tokenizer and forced decoder
prefix (``generation_config.json``), read with ``local_files_only``.

Run: ``python -m production_stack_tpu_torch.engine.asr_server
whisper-small --port 8000`` (on the card; ``--device cpu`` for the
host).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from production_stack_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
)
from production_stack_tpu_torch.models.weights import (
    has_checkpoint,
    load_whisper_checkpoint,
)
from production_stack_tpu_torch.models.whisper import (
    SAMPLE_RATE,
    WhisperModel,
    decode_wav_bytes,
    get_whisper_config,
    params_to,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

MAX_BODY_BYTES = 64 * 1024 * 1024  # the JAX server's client_max_size
FORMATS = ("json", "text", "verbose_json")


class ASRServer:
    """The transcription engine behind the routes: the model, its decoding
    contract (prefix, EOT, suppressed ids, tokenizer) and the counters."""

    def __init__(self, model: str, seed: int = 0, max_tokens: int = 64,
                 device="cuda", dtype: Optional[str] = None,
                 params: Optional[Dict] = None):
        """``dtype`` overrides the configuration's (e.g. "float32");
        ``params`` (on ``device``) overrides both the seeded init and a
        checkpoint's weights."""
        self.model_name = model
        self.cfg = get_whisper_config(model)
        if dtype:
            self.cfg = dataclasses.replace(self.cfg, dtype=dtype)
        self.hf_tok = None
        # Preset (random-init) decoding contract: ByteTokenizer ids.
        self.tokenizer = ByteTokenizer(self.cfg.vocab_size)
        self.sot = [self.tokenizer.bos_token_id]
        self.eot = self.tokenizer.eos_token_id
        self.suppress: tuple = ()
        self.begin_suppress: tuple = ()
        if has_checkpoint(model):
            if params is None:
                params = params_to(load_whisper_checkpoint(self.cfg, model),
                                   device)
            self._load_hf_decoding(model)
        self.model = WhisperModel(self.cfg, seed=seed, params=params,
                                  device=device)
        self.max_tokens = max_tokens
        self.requests_total = 0
        self.audio_seconds_total = 0.0
        self.in_flight = 0
        self._lock = threading.Lock()
        self.started = time.time()

    def _load_hf_decoding(self, path: str) -> None:
        """A checkpoint: its tokenizer and the forced decoder prefix
        ([startoftranscript, language, task, notimestamps]) from
        generation_config.json (which wins over config.json)."""
        self.hf_tok = HFTokenizer(path).tok
        gen: dict = {}
        for fname in ("generation_config.json", "config.json"):
            fpath = os.path.join(path, fname)
            if os.path.exists(fpath):
                try:
                    with open(fpath) as f:
                        gen = {**json.load(f), **gen}
                except (OSError, ValueError):
                    pass
        start = gen.get("decoder_start_token_id")
        if start is None:
            start = self.hf_tok.convert_tokens_to_ids("<|startoftranscript|>")
        forced = gen.get("forced_decoder_ids") or []
        self.sot = [int(start)] + [
            int(tok) for _, tok in sorted(forced) if tok is not None]
        eot = gen.get("eos_token_id")
        self.eot = int(eot if eot is not None else self.hf_tok.eos_token_id)
        self.suppress = tuple(gen.get("suppress_tokens") or ())
        self.begin_suppress = tuple(gen.get("begin_suppress_tokens") or ())

    def transcribe(self, pcm: np.ndarray) -> str:
        tokens = self.model.transcribe_tokens(
            pcm, sot=self.sot, eot=self.eot, max_tokens=self.max_tokens,
            suppress=self.suppress, begin_suppress=self.begin_suppress)
        if self.hf_tok is not None:
            return self.hf_tok.decode(tokens, skip_special_tokens=True)
        return self.tokenizer.decode(tokens)

    def transcription(self, form: Dict[str, Tuple[Optional[str], bytes]]
                      ) -> Tuple[int, str, str]:
        """``POST /v1/audio/transcriptions`` over the parsed form (field ->
        (filename or None, bytes)): (status, content type, body)."""
        upload = form.get("file")
        if upload is None or upload[0] is None:
            return _json(400, {"error": "missing 'file' form field"})

        def field(name):
            value = form.get(name)
            return value[1].decode("utf-8", "replace") if value else ""

        model = field("model") or self.model_name
        if model not in (self.model_name, self.cfg.name):
            return _json(400, {"error": f"model {model!r} not served here"})
        response_format = field("response_format") or "json"
        if response_format not in FORMATS:
            return _json(400, {"error": f"unsupported response_format "
                                        f"{response_format!r}"})
        try:
            pcm = decode_wav_bytes(upload[1])
        except Exception as e:  # noqa: BLE001 - bad container/encoding
            return _json(400, {"error": f"could not decode audio (WAV/PCM "
                                        f"required, no ffmpeg in image): "
                                        f"{e}"})
        duration = len(pcm) / SAMPLE_RATE
        t0 = time.perf_counter()
        with self._lock:
            self.in_flight += 1
        try:
            text = self.transcribe(pcm)
        finally:
            with self._lock:
                self.in_flight -= 1
        with self._lock:
            self.requests_total += 1
            self.audio_seconds_total += duration
        logger.info("transcribed %.2fs audio in %.2fs", duration,
                    time.perf_counter() - t0)
        if response_format == "text":
            return 200, "text/plain; charset=utf-8", text
        body = {"text": text}
        if response_format == "verbose_json":
            body.update({
                "task": "transcribe",
                "language": field("language") or "en",
                "duration": round(duration, 3),
                "segments": [{"id": 0, "start": 0.0,
                              "end": round(duration, 3), "text": text}],
            })
        return _json(200, body)

    def models(self) -> dict:
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "created": int(self.started),
            "owned_by": "production-stack-tpu",
            "task": "transcription"}]}

    def metrics_text(self) -> str:
        labels = f'model_name="{self.model_name}"'
        lines = [
            # TYPE family names match the sample names (classic
            # exposition format): the samples carry the _total suffix.
            "# TYPE tpu:asr_requests_total counter",
            f"tpu:asr_requests_total{{{labels}}} {self.requests_total}",
            "# TYPE tpu:asr_audio_seconds_total counter",
            f"tpu:asr_audio_seconds_total{{{labels}}} "
            f"{self.audio_seconds_total:.3f}",
            # The scraper's generic gauges, so the router's engine-stats
            # loop (and queue-depth autoscaling) see in-flight ASR work.
            "# TYPE vllm:num_requests_running gauge",
            f"vllm:num_requests_running{{{labels}}} {self.in_flight}",
            "# TYPE vllm:num_requests_waiting gauge",
            f"vllm:num_requests_waiting{{{labels}}} 0",
        ]
        return "\n".join(lines) + "\n"


def _json(status: int, obj) -> Tuple[int, str, str]:
    return status, "application/json; charset=utf-8", json.dumps(obj)


def parse_multipart(body: bytes, content_type: str
                    ) -> Dict[str, Tuple[Optional[str], bytes]]:
    """A ``multipart/form-data`` body -> {field name: (filename or None,
    raw bytes)}; the first part of a name wins. Any other content type
    gives no fields."""
    ctype, _, params = content_type.partition(";")
    if ctype.strip().lower() != "multipart/form-data":
        return {}
    boundary = None
    for param in params.split(";"):
        key, _, value = param.strip().partition("=")
        if key.lower() == "boundary":
            boundary = value.strip().strip('"')
    if not boundary:
        return {}
    form: Dict[str, Tuple[Optional[str], bytes]] = {}
    delim = b"--" + boundary.encode("latin-1")
    for part in body.split(delim)[1:]:
        if part.startswith(b"--"):
            break  # the closing delimiter
        head, sep, data = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        if data.endswith(b"\r\n"):
            data = data[:-2]
        name = filename = None
        for line in head.decode("utf-8", "replace").split("\r\n"):
            key, _, value = line.partition(":")
            if key.strip().lower() != "content-disposition":
                continue
            for item in value.split(";"):
                k, _, v = item.strip().partition("=")
                v = v.strip().strip('"')
                if k.lower() == "name":
                    name = v
                elif k.lower() == "filename":
                    filename = v
        if name is not None and name not in form:
            form[name] = (filename, data)
    return form


class _Handler(BaseHTTPRequestHandler):
    server_version = "production-stack-tpu-torch-asr"
    protocol_version = "HTTP/1.1"
    asr: ASRServer

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send(self, status: int, content_type: str, body: str) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.partition("?")[0]
        if path == "/v1/models":
            self._send(*_json(200, self.asr.models()))
        elif path == "/health":
            self._send(*_json(200, {"status": "ok"}))
        elif path == "/is_sleeping":
            self._send(*_json(200, {"is_sleeping": False}))
        elif path == "/metrics":
            self._send(200, "text/plain; charset=utf-8",
                       self.asr.metrics_text())
        else:
            self._send(404, "text/plain; charset=utf-8", "404: Not Found")

    def do_POST(self):  # noqa: N802 - http.server API
        path = self.path.partition("?")[0]
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            # Read and drop the body (so the close does not reset the
            # connection under the answer), then refuse it.
            left = length
            while left > 0:
                got = self.rfile.read(min(left, 1 << 20))
                if not got:
                    break
                left -= len(got)
            self.close_connection = True
            self._send(413, "text/plain; charset=utf-8",
                       f"Maximum request body size {MAX_BODY_BYTES} "
                       f"exceeded, actual body size {length}")
            return
        body = self.rfile.read(length) if length else b""
        if path != "/v1/audio/transcriptions":
            self._send(404, "text/plain; charset=utf-8", "404: Not Found")
            return
        form = parse_multipart(body, self.headers.get("Content-Type", ""))
        self._send(*self.asr.transcription(form))


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True


def build_asr_server(asr: ASRServer, host: str = "0.0.0.0",
                     port: int = 8000) -> ThreadingHTTPServer:
    """Bind the routes of ``asr``; the caller runs ``serve_forever()``
    and, to stop, ``shutdown()`` and ``server_close()``."""
    handler = type("Handler", (_Handler,), {"asr": asr})
    return _HTTPServer((host, port), handler)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", nargs="?", default="tiny-whisper")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-tokens", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model ('cpu' to run on "
                             "the host)")
    parser.add_argument("--dtype", default=None,
                        help="override the configuration's dtype "
                             "(bfloat16, float32)")
    args = parser.parse_args(argv)
    asr = ASRServer(args.model, seed=args.seed, max_tokens=args.max_tokens,
                    device=args.device, dtype=args.dtype)
    httpd = build_asr_server(asr, args.host, args.port)
    logger.info("ASR server on %s:%d (model=%s, device %s)", args.host,
                httpd.server_address[1], args.model, args.device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
