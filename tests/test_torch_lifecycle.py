"""The sleep/wake/drain lifecycle of the torch port against the JAX engine
and server:

- ``sleep`` / ``wake_up`` keep greedy and seeded streams equal to the
  JAX engine's (and to their own before the nap); while asleep
  ``params`` is None, ``embed`` raises and the stats say so;
- with a host tier, sleep spills every cached block: a prefix hit after
  the wake-up is restored from the tier, with the JAX engine's offload
  counters;
- over HTTP, against the JAX server: ``/sleep``, ``/is_sleeping``,
  ``/wake_up``, 503 for generation and embeddings while asleep,
  ``tpu:engine_sleeping``;
- ``/drain`` against a stub KV controller: the heartbeat stops first,
  then ``/kv/deregister`` is posted; the inference surface and
  ``/health`` answer 503 with the JAX server's bodies."""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import build_server

from test_torch_engine import Pair
from test_torch_engine_step import _both, _run, _sampled
from test_torch_n_sampling import ServerPair

torch.set_num_threads(1)

GREEDY = dict(temperature=0.0, max_tokens=16, ignore_eos=True)
OFFLOAD_KEYS = ("hits", "misses", "stored", "evicted", "blocks", "bytes")


def _both_engines(pair, fn):
    for eng in (pair.jax, pair.torch):
        fn(eng)


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-opt"])
def test_sleep_wake_keeps_streams(model):
    pair = Pair(model=model, prefill_chunk_size=16)
    try:
        prompts = [list(range(30, 62)), list(range(90, 101))]
        samplings = [GREEDY, _sampled(1, max_tokens=16)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        _both_engines(pair, lambda e: e.sleep(1))
        t = pair.torch
        assert t.is_sleeping and t.params is None and t.kv is None
        assert t.stats()["is_sleeping"]
        assert t.kv_mgr.allocator.prefix_map == {}
        assert t.kv_mgr.allocator.num_free == t.num_blocks
        with pytest.raises(RuntimeError, match="sleeping"):
            t.embed([1, 2, 3])
        assert not t.unload_lora_adapter("nothing")
        assert not t.load_lora_adapter("while-asleep")
        t.sleep(1)  # a no-op when asleep
        _both_engines(pair, lambda e: e.wake_up())
        assert not t.is_sleeping and t.params is not None
        again_want, again_got = _both(pair, prompts, samplings)
        assert again_got == again_want == want
    finally:
        pair.stop()


def test_requests_in_flight_sleep_and_resume():
    """A request running when sleep arrives is preempted and finishes
    after the wake-up with the stream it would have had."""
    pair = Pair()
    try:
        prompt = list(range(10, 30))
        sp = dict(GREEDY, max_tokens=96)
        (want,) = _run(pair.torch, [prompt], [SamplingParams(**sp)])
        out = {}

        def serve():
            out["got"] = _run(pair.torch, [prompt], [SamplingParams(**sp)])

        th = threading.Thread(target=serve)
        th.start()
        deadline = time.time() + 60
        while pair.torch.generation_tokens_total <= 96 and \
                time.time() < deadline:
            time.sleep(0.0005)
        pair.torch.sleep()
        assert pair.torch.scheduler.num_preempted_total == 1
        assert pair.torch.scheduler.num_running == 0
        time.sleep(0.2)
        assert th.is_alive()  # waits for the wake-up
        pair.torch.wake_up()
        th.join(timeout=120)
        assert out["got"] == [want]
        (jwant,) = _run(pair.jax, [prompt], [JaxSamplingParams(**sp)])
        assert jwant == want
    finally:
        pair.stop()


def test_prefix_hit_after_wake_is_restored_from_the_tier():
    pair = Pair(num_blocks=24, kv_offload_bytes=1 << 30,
                prefill_chunk_size=16)
    try:
        prompt = list(range(100, 130))  # seven full 4-token blocks
        want, got = _both(pair, [prompt], [GREEDY])
        assert got == want
        _both_engines(pair, lambda e: e.sleep(1))
        _both_engines(pair, lambda e: e.wake_up())
        cached = pair.torch.cached_tokens_total
        want, got = _both(pair, [prompt + [7]], [GREEDY])
        assert got == want
        tstats = pair.torch.stats()["offload"]
        jstats = pair.jax.stats()["offload"]
        assert tstats["stored"] >= 7 and tstats["hits"] >= 7
        assert pair.torch.cached_tokens_total - cached >= 28
        assert {k: tstats[k] for k in OFFLOAD_KEYS} == {
            k: jstats[k] for k in OFFLOAD_KEYS}
    finally:
        pair.stop()


def _call(base, path, body=None):
    """(status, JSON or text body, headers)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw, status, headers = resp.read().decode(), resp.status, \
                resp.headers
    except urllib.error.HTTPError as e:
        raw, status, headers = e.read().decode(), e.code, e.headers
    try:
        return status, json.loads(raw), headers
    except ValueError:
        return status, raw, headers


def _both_http(servers, path, body=None):
    got = _call(servers.port, path, body)
    want = _call(servers.ref, path, body)
    return got[:2], want[:2]


def _sleeping_line(metrics):
    return [line for line in metrics.splitlines()
            if "engine_sleeping" in line]


def test_http_sleep_wake_equals_the_jax_server():
    servers = ServerPair()
    try:
        body = {"prompt": "sleepy", "max_tokens": 6, "temperature": 0}
        before, _ = _both_http(servers, "/v1/completions", body)
        got, want = _both_http(servers, "/is_sleeping")
        assert got == want == (200, {"is_sleeping": False})
        got, want = _both_http(servers, "/sleep?level=2", {})
        assert got == want == (200, {"status": "sleeping", "level": 2})
        got, want = _both_http(servers, "/is_sleeping")
        assert got == want == (200, {"is_sleeping": True})
        for path, req in (("/v1/completions", body),
                          ("/v1/chat/completions", {
                              "messages": [{"role": "user",
                                            "content": "x"}]}),
                          ("/v1/embeddings", {"input": "x"}),
                          ("/v1/score", {"text_1": "a", "text_2": "b"}),
                          ("/v1/rerank", {"query": "a",
                                          "documents": ["b"]})):
            got, want = _both_http(servers, path, req)
            assert got == want
            assert got[0] == 503
        mine = _call(servers.port, "/metrics")[1]
        ref = _call(servers.ref, "/metrics")[1]
        assert _sleeping_line(mine) == _sleeping_line(ref) == [
            "# TYPE tpu:engine_sleeping gauge",
            'tpu:engine_sleeping{model_name="tiny-llama"} 1']
        got, want = _both_http(servers, "/wake_up", {})
        assert got == want == (200, {"status": "awake"})
        after, _ = _both_http(servers, "/v1/completions", body)
        assert after[1]["choices"] == before[1]["choices"]
        got, want = _both_http(servers, "/version")
        assert got == want
        for path, req in (("/tokenize", {"prompt": "héllo"}),
                          ("/tokenize", {"messages": [
                              {"role": "user", "content": "hi"}]}),
                          ("/detokenize", {"tokens": [104, 105, 33]})):
            got, want = _both_http(servers, path, req)
            assert got == want and got[0] == 200
    finally:
        servers.stop()


class _StubController:
    """A stdlib KV controller that records every POST path in order and
    answers heartbeats as a known instance."""

    def __init__(self):
        self.paths = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                stub.paths.append((self.path, body))
                data = json.dumps({"known": True, "match": True}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_drain_stops_leases_then_deregisters():
    stub = _StubController()
    httpd, core = build_server([
        "tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
        "0", "--max-model-len", "128", "--block-size", "4", "--num-blocks",
        "64", "--max-loras", "0", "--dtype", "float32",
        "--kv-controller-url", stub.url, "--instance-id", "eng-1",
        "--kv-heartbeat-interval", "0.05", "--kv-resync-interval", "0.05",
        "--no-warmup"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        deadline = time.time() + 30
        while not any(p == "/kv/heartbeat" for p, _ in stub.paths) and \
                time.time() < deadline:
            time.sleep(0.01)
        assert _call(base, "/v1/completions",
                     {"prompt": "hello", "max_tokens": 3})[0] == 200
        status, out, _ = _call(base, "/drain?timeout_s=5", {})
        assert (status, out) == (200, {"status": "drained", "in_flight": 0})
        leases = [th for th in threading.enumerate()
                  if th.name in ("kv-heartbeat", "kv-resync")]
        assert not any(th.is_alive() for th in leases)
        paths = [p for p, _ in stub.paths]
        dereg = paths.index("/kv/deregister")
        assert stub.paths[dereg][1] == {"instance_id": "eng-1"}
        time.sleep(0.3)  # no lease traffic after the deregistration
        assert not [p for p in paths[dereg + 1:]
                    if p in ("/kv/heartbeat", "/kv/register", "/kv/resync")]
        assert [p for p, _ in stub.paths][dereg + 1:] == paths[dereg + 1:]
        status, out, headers = _call(base, "/v1/completions",
                                     {"prompt": "x"})
        assert status == 503 and headers["Retry-After"] == "1"
        assert out == {"error": {"message": "engine is draining",
                                 "type": "ServiceUnavailable"}}
        status, out, _ = _call(base, "/health")
        assert (status, out) == (503, {"status": "draining",
                                       "in_flight": 0})
        assert _call(base, "/metrics")[0] == 200  # stays open
        again = _call(base, "/drain", {})
        assert again[:2] == (200, {"status": "drained", "in_flight": 0})
        assert [p for p, _ in stub.paths].count("/kv/deregister") == 1
        assert _call(base, "/drain?timeout_s=x", {})[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
        stub.stop()


def test_drain_bodies_equal_the_jax_server():
    servers = ServerPair()
    try:
        got, want = _both_http(servers, "/drain?timeout_s=1", {})
        assert got == want == (200, {"status": "drained", "in_flight": 0})
        got, want = _both_http(servers, "/health")
        assert got == want
        got, want = _both_http(servers, "/v1/completions", {"prompt": "x"})
        assert got == want and got[0] == 503
        got, want = _both_http(servers, "/tokenize", {"prompt": "x"})
        assert got == want and got[0] == 503
    finally:
        servers.stop()
