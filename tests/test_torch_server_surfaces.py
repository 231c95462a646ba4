"""The torch port's server surfaces against the JAX server, on the CPU:
both servers keyed with one deployment key, tiny-llama at float32, the
port's engine holding the JAX engine's weights. Each case sends the same
requests to both and compares what comes back.

- the API-key gate: the JAX package's own auth cases
  (``tests/test_api_key_auth.py``) against both servers, and every
  ``/debug`` route of each (the same set) 401 without the key;
- the router's headers: ``X-Priority: batch`` makes the batch request the
  preemption victim (same victim, same ``preempted_by_priority``, same
  streams), ``X-Request-Id`` is adopted and echoed;
- KV-capacity refusals: 503 with ``Retry-After: 1`` for a prompt past
  the pool (the pre-check) and for a scheduler rejection (blocks pinned
  below the prompt's footprint), with the same ``rejected_total``;
- ``/metrics`` names: the port's are a superset of the JAX server's, less
  the loop-monitor and fused-step series;
- the KV-pool shrink ladder: rungs, pool size and counter against the
  JAX engine's ladder on the same failures;
- ``/debug/traces`` (the ``traceparent`` join, stage spans that add up),
  ``/debug/profile`` and its artifacts, ``/healthz``;
- the port's own outbound calls carry the key (a pull from the keyed JAX
  server, the KV-controller reports)."""

import asyncio
import json
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.server import (
    EngineServer as JaxEngineServer,
    run_engine_server,
)
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.models.convert import params_from_numpy

from test_torch_engine import cfg_model

torch.set_num_threads(1)

KEY = "sk-test-123"
AUTH = {"Authorization": f"Bearer {KEY}"}
# A 20-block pool of 4-token blocks: two 48-token sequences overflow it
# (preemption), an 80-token prompt never fits it (the pre-check).
CFG = dict(model="tiny-llama", max_model_len=128, max_num_seqs=2,
           block_size=4, num_blocks=20, max_loras=0, dtype="float32")
# Series the port does not export: the JAX event-loop monitor (the port's
# server has no event loop) and the fused step (refused by the port).
NOT_PORTED = re.compile(r"^tpu:(event_loop_|loop_stalls|fused_steps)")


class KeyedPair:
    """The JAX server (its own event loop on a thread) and the port's
    server on the JAX engine's weights, both with ``api_key=KEY``."""

    def __init__(self, port_args=()):
        self.jax = JaxEngineServer(JaxEngineConfig(**CFG), api_key=KEY)
        tree = jax.tree.map(np.asarray, self.jax.core.params)
        cfg = EngineConfig(device="cpu", **CFG)
        core = EngineCore(cfg, params=params_from_numpy(
            tree, cfg_model(cfg), "cpu"))
        self.httpd, self.core = build_server(
            ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1",
             "--port", "0", "--api-key", KEY, *port_args], core=core)
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

    @property
    def bases(self):
        """(base URL, engine core) of the port's server and the JAX's."""
        return ((self.port, self.core), (self.ref, self.jax.core))

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


@pytest.fixture(scope="module")
def pair():
    p = KeyedPair()
    yield p
    p.stop()


def call(base, path, body=None, headers=None, method=None):
    """(status, body text, headers) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def metric(text, name, **labels):
    """The value of one sample of ``/metrics`` text (labels beside the
    model name), or None."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for line in text.splitlines():
        if line.startswith(name + "{") and all(w in line for w in want):
            return float(line.rsplit(" ", 1)[1])
    return None


@pytest.mark.parametrize("side", ["port", "jax"])
def test_engine_requires_bearer_key(pair, side):
    """The JAX package's test_engine_requires_bearer_key, against each
    server."""
    base = pair.port if side == "port" else pair.ref
    body = {"model": "tiny-llama", "prompt": "ab", "max_tokens": 2,
            "ignore_eos": True}
    status, text, _ = call(base, "/v1/completions", body)
    assert status == 401
    assert json.loads(text)["error"]["type"] == "AuthenticationError"
    assert call(base, "/v1/completions", body,
                {"Authorization": "Bearer nope"})[0] == 401
    assert call(base, "/v1/load_lora_adapter", {"lora_name": "x"})[0] == 401
    assert call(base, "/v1/models")[0] == 401
    for path in ("/health", "/metrics", "/is_sleeping", "/version"):
        assert call(base, path)[0] == 200, path
    for path in ("/debug/traces", "/debug/traces/rid", "/debug/steps"):
        assert call(base, path)[0] == 401, path
    for path in ("/debug/traces", "/debug/steps"):
        assert call(base, path, headers=AUTH)[0] == 200, path
    # Every /kv route takes the key on an engine (raw cache pages).
    assert call(base, "/kv/extract", {"prompt": "ab"})[0] == 401
    status, text, _ = call(base, "/v1/completions", body, AUTH)
    assert status == 200, text


def _jax_debug_routes(server):
    seen = set()
    for route in server.make_app().router.routes():
        method = route.method.upper()
        canonical = route.resource.canonical
        if method in ("HEAD", "OPTIONS", "*") or not canonical.startswith(
                "/debug/"):
            continue
        seen.add((method, re.sub(r"{[^}]+}", "x", canonical)))
    return seen


def test_every_debug_route_requires_key(pair):
    """The port serves the JAX engine's debug routes, and each answers
    401 without the key or with a wrong one, on both servers."""
    port_routes = {(m, re.sub(r"{[^}]+}", "x", p))
                   for m, p in tserver.DEBUG_ROUTES}
    jax_routes = _jax_debug_routes(pair.jax)
    assert port_routes == jax_routes
    for base in (pair.port, pair.ref):
        for method, path in sorted(jax_routes):
            body = {} if method == "POST" else None
            assert call(base, path, body, method=method)[0] == 401, (
                base, method, path)
            assert call(base, path, body, {"Authorization": "Bearer nope"},
                        method=method)[0] == 401, (base, method, path)


def _hold(core):
    """Stop the engine loop from taking work (it waits while the
    scheduler reports none); returns the release function."""
    sched = core.scheduler
    sched.has_work = lambda: False

    def release():
        del sched.has_work
        with core._lock:
            core._lock.notify_all()
    return release


def _wait(cond, timeout=60):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline
        time.sleep(0.01)


def test_batch_request_is_the_preemption_victim(pair):
    """An interactive and a batch request that together overflow the
    pool, queued before the engine steps: both servers preempt the batch
    one, count it under its class, and stream the same tokens."""
    body = {"prompt": [int(t) for t in range(10, 18)], "max_tokens": 40,
            "temperature": 0, "ignore_eos": True}
    results = {}
    for base, core in pair.bases:
        release = _hold(core)
        before = core.stats()["preempted_by_priority"]
        out = {}

        def send(name, headers):
            out[name] = call(base, "/v1/completions", body,
                             dict(AUTH, **headers))

        threads = []
        for name, prio, n in (("inter", "interactive", 1),
                              ("batch", "batch", 2)):
            rid = f"prio-{name}-{base[-5:]}"
            th = threading.Thread(target=send, args=(
                name, {"X-Priority": prio, "X-Request-Id": rid}))
            th.start()
            threads.append(th)
            _wait(lambda: core.scheduler.num_waiting == n)
        release()
        for th in threads:
            th.join(120)
        after = core.stats()["preempted_by_priority"]
        preempted = {k: after[k] - before.get(k, 0) for k in after}
        texts = {k: json.loads(v[1])["choices"][0]["text"]
                 for k, v in out.items()}
        spans = {}
        for name in ("inter", "batch"):
            status, text, _ = call(
                base, f"/debug/traces/prio-{name}-{base[-5:]}",
                headers=AUTH)
            assert status == 200, text
            prefill = [s for s in json.loads(text)["spans"]
                       if s["name"] == "engine.prefill"]
            spans[name] = prefill[0]["attributes"]["preemptions"]
        results[base] = (preempted, texts, spans)
    port, ref = results[pair.port], results[pair.ref]
    assert port == ref
    assert port[0] == {"interactive": 0, "batch": 1}
    assert port[2] == {"inter": 0, "batch": 1}
    for base, _ in pair.bases:
        text = call(base, "/metrics")[1]
        assert metric(text, "tpu:preempted_requests_total",
                      priority="batch") >= 1
        assert metric(text, "tpu:preempted_requests_total",
                      priority="interactive") is not None


@pytest.mark.parametrize("stream", [False, True])
def test_request_id_is_adopted_and_echoed(pair, stream):
    rid = f"router-rid-{int(stream)}"
    body = {"prompt": "hello", "max_tokens": 3, "temperature": 0,
            "stream": stream}
    for base, _ in pair.bases:
        status, text, headers = call(base, "/v1/completions", body,
                                     dict(AUTH, **{"X-Request-Id": rid}))
        assert status == 200, text
        assert headers["X-Request-Id"] == rid
        if stream:
            events = [json.loads(ln[6:]) for ln in text.splitlines()
                      if ln.startswith("data: {")]
            assert events and all(e["id"] == rid for e in events)
        else:
            assert json.loads(text)["id"] == rid
        assert call(base, f"/debug/traces/{rid}", headers=AUTH)[0] == 200


def test_kv_capacity_refusals(pair):
    """503 + Retry-After on the pre-check (an 80-token prompt needs 21 of
    the 20 blocks) and on a scheduler rejection (16 blocks pinned, a
    30-token prompt's 8 no longer fit), each counted as kv_capacity."""
    counts = {}
    for base, core in pair.bases:
        before = core.stats()["rejected_requests"]["kv_capacity"]
        status, text, headers = call(base, "/v1/completions", {
            "prompt": [7] * 80, "max_tokens": 2},
            dict(AUTH, **{"X-Request-Id": "refused-1"}))
        assert status == 503, text
        assert headers["Retry-After"] == "1"
        assert json.loads(text)["error"]["type"] == "ServiceUnavailable"
        # The refusal's timeline is kept, as the JAX server keeps it.
        status, text, _ = call(base, "/debug/traces/refused-1", headers=AUTH)
        assert status == 200, text
        assert [s["name"] for s in json.loads(text)["spans"]] == [
            "engine.request", "engine.queue"]
        with core._lock:
            pinned = [core.kv_mgr.allocator.allocate() for _ in range(16)]
        assert None not in pinned
        try:
            streams = [False, True] if core is pair.core else [False]
            for stream in streams:
                status, text, headers = call(base, "/v1/completions", {
                    "prompt": [9] * 30, "max_tokens": 2, "stream": stream},
                    AUTH)
                assert status == 503, (stream, text)
                assert headers["Retry-After"] == "1"
                assert "KV cache capacity" in json.loads(
                    text)["error"]["message"]
        finally:
            with core._lock:
                for bid in pinned:
                    core.kv_mgr.allocator.release(bid)
        after = core.stats()["rejected_requests"]["kv_capacity"]
        counts[base] = after - before
        metrics = call(base, "/metrics")[1]
        assert metric(metrics, "tpu:rejected_requests_total",
                      reason="kv_capacity") == after
    # The port also answers the streamed form: one rejection more.
    assert counts[pair.port] == counts[pair.ref] + 1 == 3


def _names(text):
    return {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
            if ln and not ln.startswith("#")}


def test_metrics_names_are_a_superset_of_the_jax_server(pair):
    for base, _ in pair.bases:
        status, text, _ = call(base, "/v1/completions", {
            "prompt": "warm", "max_tokens": 2}, AUTH)
        assert status == 200, text
    port = _names(call(pair.port, "/metrics")[1])
    ref = {n for n in _names(call(pair.ref, "/metrics")[1])
           if not NOT_PORTED.match(n)}
    assert ref - port == set()
    text = call(pair.port, "/metrics")[1]
    assert metric(text, "tpu:prefill_attention_dispatch_total",
                  path="xla") == 0
    assert metric(text, "tpu:pool_shrink_retries_total") == 0
    assert metric(text, "tpu:queue_time_seconds_count") >= 1


def test_traces_join_traceparent_and_stage_times_add_up(pair):
    trace_id, parent = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    rid = "traced-1"
    for base, _ in pair.bases:
        status, text, _ = call(base, "/v1/completions", {
            "prompt": "trace me", "max_tokens": 4, "temperature": 0},
            dict(AUTH, **{"X-Request-Id": rid,
                          "traceparent": f"00-{trace_id}-{parent}-01"}))
        assert status == 200, text
    docs = []
    for base, _ in pair.bases:
        status, text, _ = call(base, f"/debug/traces/{rid}", headers=AUTH)
        assert status == 200, text
        doc = json.loads(text)
        assert doc["trace_id"] == trace_id
        assert doc["remote_parent_span_id"] == parent
        spans = {s["name"]: s for s in doc["spans"]}
        root = spans["engine.request"]
        assert root["parent_span_id"] == parent
        assert root["attributes"]["tokens"] == 4
        stages = sum(spans[n]["duration_s"] for n in (
            "engine.queue", "engine.prefill", "engine.decode"))
        assert 0 < stages <= root["duration_s"] + 1e-5
        listing = json.loads(call(base, "/debug/traces?limit=500",
                                  headers=AUTH)[1])
        assert rid in [t["request_id"] for t in listing["traces"]]
        assert call(base, "/debug/traces?limit=x", headers=AUTH)[0] == 400
        assert call(base, "/debug/traces/nope", headers=AUTH)[0] == 404
        otlp = json.loads(call(base, f"/debug/traces/{rid}?format=otlp",
                               headers=AUTH)[1])
        assert otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
        docs.append([s["name"] for s in doc["spans"]])
    assert docs[0] == docs[1] == ["engine.request", "engine.queue",
                                  "engine.prefill", "engine.decode"]


def test_healthz_and_profile_capture(pair):
    assert call(pair.ref, "/health")[:2] == call(pair.port, "/health")[:2]
    assert call(pair.port, "/healthz")[:2] == call(pair.port, "/health")[:2]
    status, text, _ = call(pair.port, "/debug/profile", {"duration_s": 0.2},
                           AUTH)
    assert status == 200, text
    run = json.loads(text)
    assert run["ok"] and run["files"], run
    listing = json.loads(call(pair.port, "/debug/profile/artifacts",
                              headers=AUTH)[1])
    assert set(run["files"]) <= set(listing["files"])
    status, data, _ = call(pair.port,
                           f"/debug/profile/artifacts/{run['files'][0]}",
                           headers=AUTH)
    assert status == 200 and json.loads(data)
    assert call(pair.port, "/debug/profile/artifacts/..%2F..%2Fetc%2Fpasswd",
                headers=AUTH)[0] == 400
    assert call(pair.port, "/debug/profile/artifacts/none.json",
                headers=AUTH)[0] == 404
    assert call(pair.port, "/debug/profile", {"duration_s": "x"},
                AUTH)[0] == 400


def test_pull_from_keyed_jax_server_carries_the_key(pair):
    """The port's /kv/pull fetches the JAX server's /kv/extract with the
    key: without it the JAX server would answer 401 and the pull would
    miss."""
    prompt = "a prompt long enough for several cached blocks."
    assert call(pair.ref, "/v1/completions", {
        "prompt": prompt, "max_tokens": 1}, AUTH)[0] == 200
    status, text, _ = call(pair.port, "/kv/pull", {
        "source_url": pair.ref, "request": {"prompt": prompt},
        "kv_path": "host"}, AUTH)
    assert status == 200, text
    out = json.loads(text)
    assert out["status"] == "ok" and out["injected_blocks"] > 0, out
    listing = json.loads(call(pair.port, "/debug/traces", headers=AUTH)[1])
    assert any(t["root"] == "engine.kv_transfer"
               for t in listing["traces"])


class _Controller(BaseHTTPRequestHandler):
    seen: list

    def do_POST(self):  # noqa: N802 - http.server API
        length = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(length)
        self.seen.append((self.path, self.headers.get("Authorization")))
        data = b'{"known": true}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def test_controller_reports_carry_the_key():
    seen = []
    handler = type("Stub", (_Controller,), {"seen": seen})
    stub = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    core = EngineCore(EngineConfig(device="cpu", **CFG))
    httpd, core = build_server(
        ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
         "0", "--api-key", KEY, "--kv-controller-url",
         f"http://127.0.0.1:{stub.server_address[1]}",
         "--kv-heartbeat-interval", "0", "--kv-resync-interval", "0"],
        core=core)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert call(base, "/v1/completions", {
            "prompt": "report this prompt", "max_tokens": 1},
            AUTH)[0] == 200
        _wait(lambda: any(p == "/kv/admit" for p, _ in seen))
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
        stub.shutdown()
        stub.server_close()
    assert {p for p, _ in seen} >= {"/kv/register", "/kv/admit"}
    assert all(a == f"Bearer {KEY}" for _, a in seen)


def _jax_ladder(monkeypatch, fails: int):
    calls = {"n": 0}
    real = JaxEngineCore._alloc_kv

    def alloc(self):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory (test)")
        return real(self)

    monkeypatch.setattr(JaxEngineCore, "_alloc_kv", alloc)
    core = JaxEngineCore(JaxEngineConfig(**LADDER),
                         devices=jax.devices()[:1])
    return core.num_blocks, core.stats()["pool_shrink_retries_total"]


def _port_ladder(monkeypatch, fails: int):
    calls = {"n": 0}
    real = EngineCore._alloc_pages

    def alloc(self):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise torch.cuda.OutOfMemoryError("out of memory (test)")
        return real(self)

    monkeypatch.setattr(EngineCore, "_alloc_pages", alloc)
    core = EngineCore(EngineConfig(device="cpu", **LADDER))
    return core.num_blocks, core.stats()["pool_shrink_retries_total"]


# max_blocks_per_seq = 32, so the ladder's floor is 64 blocks.
LADDER = dict(CFG, num_blocks=96, pool_shrink_retries=4,
              pool_shrink_step=0.15)


@pytest.mark.parametrize("fails", [0, 1, 2, 3])
def test_pool_shrink_ladder_matches_jax(monkeypatch, fails):
    """Each out-of-memory error at the pool's allocation takes one rung:
    96 -> 81 -> 68 -> 64 blocks (the floor), and at the floor the error
    is raised; the same pool sizes and counters as the JAX ladder."""
    outcomes = []
    for ladder in (_jax_ladder, _port_ladder):
        with monkeypatch.context() as m:
            outcomes.append(ladder(m, fails))
    assert outcomes[0] == outcomes[1]
    want = {0: (96, 0), 1: (81, 1), 2: (68, 2), 3: (64, 3)}[fails]
    assert outcomes[1] == want


def test_pool_shrink_ladder_stops_at_the_floor_and_other_errors(
        monkeypatch):
    for fails in (4, 9):
        for ladder, err in ((_jax_ladder, RuntimeError),
                            (_port_ladder, torch.cuda.OutOfMemoryError)):
            with monkeypatch.context() as m, pytest.raises(err):
                ladder(m, fails)

    def boom(self):
        raise RuntimeError("not an allocation failure")

    monkeypatch.setattr(EngineCore, "_alloc_pages", boom)
    with pytest.raises(RuntimeError, match="not an allocation"):
        EngineCore(EngineConfig(device="cpu", **LADDER))
