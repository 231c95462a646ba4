"""``n > 1`` on the torch port's standard-library server, against the JAX
server (aiohttp) on the same weights: tiny-llama at float32, the port's
engine holding the JAX engine's parameters (``models/convert.py``).

The same seeded body gives the same choices, finish reasons and usage
from both servers, on completions and chat; streamed chunks carry each
choice's ``index``, and each index's text is its whole choice's; a prompt
past ``max_model_len`` answers 400 and leaves no request in the engine;
a client that goes away mid-stream aborts every choice."""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.server import (
    EngineServer as JaxEngineServer,
    run_engine_server,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.models.convert import params_from_numpy

from test_torch_engine import cfg_model

torch.set_num_threads(1)

CFG = dict(model="tiny-llama", max_model_len=256, max_num_seqs=4,
           block_size=8, num_blocks=64, max_loras=0, dtype="float32")


class ServerPair:
    """The JAX server on a thread of its own (its event loop) and the
    port's server on the JAX engine's weights, both with ``CFG`` and
    ``over``; ``post`` sends one body to both."""

    def __init__(self, **over):
        kwargs = dict(CFG, **over)
        self.jax = JaxEngineServer(JaxEngineConfig(**kwargs))
        tree = jax.tree.map(np.asarray, self.jax.core.params)
        cfg = EngineConfig(device="cpu", **kwargs)
        core = EngineCore(cfg, params=params_from_numpy(
            tree, cfg_model(cfg), "cpu"))
        self.httpd, self.core = build_server(
            ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1",
             "--port", "0"], core=core)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def serve():
            asyncio.set_event_loop(self.loop)
            self.runner = self.loop.run_until_complete(
                run_engine_server(self.jax, "127.0.0.1", 0))
            ready.set()
            self.loop.run_forever()

        self.jax_thread = threading.Thread(target=serve, daemon=True)
        self.jax_thread.start()
        assert ready.wait(60)
        sock = list(self.runner.sites)[0]._server.sockets[0]
        self.ref = f"http://127.0.0.1:{sock.getsockname()[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.core.stop()
        self.thread.join(timeout=10)
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.jax_thread.join(timeout=10)
        self.jax.core.stop()

    @staticmethod
    def request(base, path, body, raw=False):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            text = resp.read().decode()
        return text if raw else json.loads(text)

    def post(self, path, body, raw=False):
        """(port's reply, JAX server's reply)."""
        return (self.request(self.port, path, body, raw),
                self.request(self.ref, path, body, raw))


@pytest.fixture(scope="module")
def pair():
    p = ServerPair()
    yield p
    p.stop()


def events(text):
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def _choices(out):
    """The choices without their logprob values (the same tokens; the
    values from two frameworks' float32 arithmetic, compared apart)."""
    return [{k: v for k, v in c.items() if k != "logprobs"}
            for c in out["choices"]]


def _same_logprobs(got, want):
    for g, w in zip(got["choices"], want["choices"]):
        assert ("logprobs" in g) == ("logprobs" in w)
        if "logprobs" not in g:
            continue
        g, w = g["logprobs"], w["logprobs"]
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["token_logprobs"], w["token_logprobs"],
                                   atol=1e-4)


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "abc", "n": 3, "max_tokens": 6,
                         "temperature": 0.8, "seed": 7,
                         "ignore_eos": True}),
    ("/v1/completions", {"prompt": "stop here", "n": 2, "max_tokens": 12,
                         "temperature": 0.9, "seed": 3, "stop": ["e"],
                         "logprobs": 2}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "n": 3, "max_tokens": 6, "temperature": 0.8,
                              "seed": 7, "ignore_eos": True}),
])
def test_n_choices_equal_the_jax_server(pair, path, body):
    got, want = pair.post(path, body)
    assert len(got["choices"]) == body["n"]
    assert _choices(got) == _choices(want)
    _same_logprobs(got, want)
    assert got["usage"] == want["usage"]
    assert got["object"] == want["object"]
    texts = {c.get("text", c.get("message", {}).get("content"))
             for c in got["choices"]}
    assert len(texts) > 1  # seeds base + i: the choices differ


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "abc", "n": 3, "max_tokens": 6,
                         "temperature": 0.8, "seed": 7, "ignore_eos": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hi"}],
                              "n": 3, "max_tokens": 6, "temperature": 0.8,
                              "seed": 7, "ignore_eos": True})])
def test_n_streamed_chunks_are_index_tagged(pair, path, body):
    whole = pair.request(pair.port, path, body)
    got, want = pair.post(path, dict(body, stream=True), raw=True)
    per_index = {}
    for server_events in (events(got), events(want)):
        texts, finishes = {}, {}
        for e in server_events:
            c = e["choices"][0]
            piece = c.get("text")
            if piece is None:
                piece = c["delta"].get("content", "")
            texts[c["index"]] = texts.get(c["index"], "") + piece
            if c["finish_reason"]:
                finishes[c["index"]] = c["finish_reason"]
        per_index[len(per_index)] = (texts, finishes)
    (texts, finishes), (jtexts, jfinishes) = per_index[0], per_index[1]
    assert sorted(texts) == [0, 1, 2]
    assert texts == jtexts and finishes == jfinishes
    for c in whole["choices"]:
        assert texts[c["index"]] == c.get("text", c.get(
            "message", {}).get("content"))
        assert finishes[c["index"]] == c["finish_reason"]


def _engine_idle(core, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with core._lock:
            if not core.scheduler._requests and \
                    core.scheduler.num_running == 0:
                return True
        time.sleep(0.05)
    return False


def test_n_oversize_prompt_answers_400_and_leaves_nothing(pair):
    body = {"prompt": "x" * 300, "n": 3, "max_tokens": 4}
    for base in (pair.port, pair.ref):
        with pytest.raises(urllib.error.HTTPError) as err:
            pair.request(base, "/v1/completions", body)
        assert err.value.code == 400
    assert _engine_idle(pair.core)
    assert pair.core.stats()["num_requests_waiting"] == 0


def test_n_client_gone_mid_stream_aborts_every_choice(pair):
    """The client reads the first chunk and closes the connection: every
    choice leaves the engine (aborted, not run to its 200 tokens)."""
    host, port = pair.port[len("http://"):].split(":")
    before = pair.core.stats()["generation_tokens_total"]
    payload = json.dumps({
        "prompt": "abc", "n": 3, "max_tokens": 200, "temperature": 0.8,
        "seed": 1, "ignore_eos": True, "stream": True}).encode()
    with socket.create_connection((host, int(port)), timeout=60) as sock:
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(payload)
                     + payload)
        head = b""
        while b"data: " not in head:
            head += sock.recv(4096)
        assert head.startswith(b"HTTP/1.0 200")
    assert _engine_idle(pair.core, timeout=60)
    assert pair.core.stats()["generation_tokens_total"] - before < 3 * 199
