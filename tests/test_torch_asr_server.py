"""The port's ASR server (``production_stack_tpu_torch/engine/
asr_server.py``) against the JAX one, on the CPU: both serve tiny-whisper
at float32 on one set of parameters (the JAX server is handed a float32
``WhisperModel``; the port's takes the same tree through
``whisper_params_from_numpy``), each on a thread, and each case sends the
same requests to both.

- ``json``, ``text`` and ``verbose_json`` transcriptions: the same status,
  content type and body;
- the 400 cases (no file, a model not served, an unknown format, audio
  that does not decode) and the 413 of a body over 64 MiB; ``/v1/models``,
  ``/health``, ``/is_sleeping``; ``/metrics`` names a superset of the JAX
  server's with the same counter values;
- the JAX router's multipart proxy to the port's ASR server;
- the port's text server answers 501 on ``/v1/audio/transcriptions``."""

import asyncio
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.asr_server import (
    ASRServer as JaxASRServer,
    run_asr_server,
)
from production_stack_tpu.models import whisper as jw
from production_stack_tpu_torch.engine.asr_server import (
    ASRServer,
    build_asr_server,
    parse_multipart,
)
from production_stack_tpu_torch.models import whisper as tw
from production_stack_tpu_torch.models.convert import (
    whisper_params_from_numpy,
)

torch.set_num_threads(1)

MODEL = "tiny-whisper"


def _wav_bytes(seconds: float, freq: float = 440.0, seed: int = 0) -> bytes:
    """A 16 kHz mono 16-bit WAV: a tone plus seeded noise."""
    n = int(tw.SAMPLE_RATE * seconds)
    t = np.arange(n) / tw.SAMPLE_RATE
    noise = np.random.default_rng(seed).normal(0, 0.05, n)
    pcm = ((0.3 * np.sin(2 * np.pi * freq * t) + noise)
           * 32767).clip(-32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(tw.SAMPLE_RATE)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _multipart(fields, boundary="torch-asr-test-boundary"):
    """(body, content type) of a multipart/form-data form: ``fields`` is
    a list of (name, value) or (name, value, filename)."""
    out = b""
    for name, value, *rest in fields:
        filename = rest[0] if rest else None
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        head = f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
        if filename:
            head += "Content-Type: audio/wav\r\n"
        data = value if isinstance(value, bytes) else value.encode()
        out += head.encode() + b"\r\n" + data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


def _post(base, path, fields):
    body, ctype = _multipart(fields)
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


class AsrPair:
    """The JAX ASR server (its aiohttp app on its own event loop) and the
    port's, on one float32 tiny-whisper tree."""

    def __init__(self, max_tokens=8):
        jcfg = dataclasses.replace(jw.WHISPER_PRESETS[MODEL],
                                   dtype="float32")
        params = jw.init_whisper_params(jcfg, 0)
        self.jax = JaxASRServer(MODEL, max_tokens=max_tokens)
        self.jax.model = jw.WhisperModel(jcfg, params=params)
        tcfg = dataclasses.replace(tw.WHISPER_PRESETS[MODEL],
                                   dtype="float32")
        self.port = ASRServer(
            MODEL, max_tokens=max_tokens, device="cpu", dtype="float32",
            params=whisper_params_from_numpy(
                jax.tree.map(np.asarray, params), tcfg, "cpu"))
        self.httpd = build_asr_server(self.port, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port_url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def serve():
            asyncio.set_event_loop(self.loop)
            self.runner = self.loop.run_until_complete(
                run_asr_server(self.jax, "127.0.0.1", 0))
            ready.set()
            self.loop.run_forever()

        self.jax_thread = threading.Thread(target=serve, daemon=True)
        self.jax_thread.start()
        assert ready.wait(60)
        sock = list(self.runner.sites)[0]._server.sockets[0]
        self.jax_url = f"http://127.0.0.1:{sock.getsockname()[1]}"

    def both(self, fn):
        return fn(self.port_url), fn(self.jax_url)

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.jax_thread.join(timeout=10)


@pytest.fixture(scope="module")
def pair():
    p = AsrPair()
    yield p
    p.stop()


@pytest.mark.parametrize("fmt", ["json", "text", "verbose_json"])
def test_transcription_bodies_equal_jax(pair, fmt):
    fields = [("file", _wav_bytes(0.5, seed=1), "a.wav"), ("model", MODEL),
              ("response_format", fmt), ("language", "de")]
    got, want = pair.both(lambda base: _post(
        base, "/v1/audio/transcriptions", fields))
    assert got == want
    assert got[0] == 200
    if fmt != "text":
        body = json.loads(got[2])
        assert body["text"]
        if fmt == "verbose_json":
            assert body["duration"] == 0.5 and body["language"] == "de"


def test_default_format_and_model_field_optional(pair):
    fields = [("file", _wav_bytes(1.25, freq=220.0, seed=2), "b.wav")]
    got, want = pair.both(lambda base: _post(
        base, "/v1/audio/transcriptions", fields))
    assert got == want and got[0] == 200


@pytest.mark.parametrize("case", ["no_file", "file_as_text", "model",
                                  "format", "audio"])
def test_refusals_equal_jax(pair, case):
    fields = {
        "no_file": [("model", MODEL)],
        "file_as_text": [("file", "not an upload", None)],
        "model": [("file", _wav_bytes(0.25), "a.wav"),
                  ("model", "whisper-large")],
        "format": [("file", _wav_bytes(0.25), "a.wav"),
                   ("response_format", "srt")],
        "audio": [("file", b"RIFF....not a wave file", "a.wav")],
    }[case]
    got, want = pair.both(lambda base: _post(
        base, "/v1/audio/transcriptions", fields))
    assert got[0] == want[0] == 400
    assert json.loads(got[2]) == json.loads(want[2])
    assert got[1] == want[1]


def test_body_over_64_mib_is_413(pair):
    big = [("file", b"\0" * (64 * 1024 * 1024 + 1), "big.wav")]
    got, want = pair.both(lambda base: _post(
        base, "/v1/audio/transcriptions", big))
    assert got[0] == want[0] == 413
    prefix = b"Maximum request body size 67108864 exceeded"
    assert got[2].startswith(prefix) and want[2].startswith(prefix)


def test_models_health_and_metrics(pair):
    for path in ("/health", "/is_sleeping"):
        got, want = pair.both(lambda base: _get(base, path))
        assert got == want
    got, want = pair.both(lambda base: json.loads(_get(base,
                                                       "/v1/models")[2]))
    for body in (got, want):
        body["data"][0].pop("created")
    assert got == want and got["data"][0]["task"] == "transcription"

    def names_values(base):
        text = _get(base, "/metrics")[2].decode()
        return {ln.rsplit(" ", 1)[0]: ln.rsplit(" ", 1)[1]
                for ln in text.splitlines() if ln and ln[0] != "#"}, text

    (port, port_text), (ref, ref_text) = pair.both(names_values)
    assert set(ref) <= set(port)
    for name, value in ref.items():
        assert port[name] == value, name
    assert "# TYPE tpu:asr_requests_total counter" in port_text
    assert int(port['tpu:asr_requests_total{model_name="tiny-whisper"}'])


def test_parse_multipart_keeps_binary_bytes():
    data = bytes(range(256)) * 3 + b"\r\n--not-the-boundary\r\n"
    body, ctype = _multipart([("file", data, "x.wav"), ("model", "m")])
    form = parse_multipart(body, ctype)
    assert form["file"] == ("x.wav", data)
    assert form["model"] == (None, b"m")
    assert parse_multipart(body, "application/json") == {}


def test_through_the_jax_router(pair):
    """The JAX router's multipart proxy (tests/test_asr.py) to the port's
    ASR server: the port's body, byte for byte."""
    import aiohttp
    from aiohttp import web

    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.parser import build_parser
    from production_stack_tpu.utils.misc import (
        SingletonABCMeta,
        SingletonMeta,
    )

    SingletonMeta._instances.clear()
    SingletonABCMeta._instances.clear()
    wav = _wav_bytes(0.25, seed=3)
    direct = _post(pair.port_url, "/v1/audio/transcriptions",
                   [("file", wav, "q.wav"), ("model", MODEL)])

    async def run():
        args = build_parser().parse_args([])
        args.static_backends = pair.port_url
        args.static_models = MODEL
        args.routing_logic = "roundrobin"
        runner = web.AppRunner(build_app(args))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            async with aiohttp.ClientSession() as s:
                form = aiohttp.FormData()
                form.add_field("file", wav, filename="q.wav",
                               content_type="audio/wav")
                form.add_field("model", MODEL)
                async with s.post(
                        f"http://127.0.0.1:{port}/v1/audio/transcriptions",
                        data=form) as resp:
                    return resp.status, await resp.read()
        finally:
            await runner.cleanup()

    status, body = asyncio.run(run())
    assert status == 200, body
    assert json.loads(body) == json.loads(direct[2])


def test_text_server_answers_501():
    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server(["tiny-llama", "--device", "cpu", "--host",
                                "127.0.0.1", "--port", "0", "--max-loras",
                                "0", "--dtype", "float32"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        status, _, body = _post(base, "/v1/audio/transcriptions",
                                [("file", _wav_bytes(0.25), "a.wav")])
        assert status == 501
        err = json.loads(body)["error"]
        assert err["type"] == "NotImplementedError"
        assert ("python -m production_stack_tpu_torch.engine.asr_server"
                in err["message"])
        # The connection is still good: the next request is served.
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            assert resp.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
        thread.join(timeout=10)
