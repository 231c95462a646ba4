"""KV-aware routing with the port's server behind the JAX router
(``--routing-logic kvaware`` and its in-process KV controller), as
tests/test_kvaware_e2e.py drives the JAX server:

- after one served request the controller's ``/kv/lookup`` returns the
  port server's instance id, and same-prefix requests from other users
  route to it;
- without an offload tier, an eviction is reported and the claim goes;
- with one, the claim stays (the prefix is still served, by a restore)."""

import json
import threading
import time
import urllib.request

import pytest
import torch

from production_stack_tpu.router import routing_logic as rl
from production_stack_tpu.router.app import build_app
from production_stack_tpu.router.engine_stats import EngineStatsScraper
from production_stack_tpu.router.parser import build_parser
from production_stack_tpu.router.request_stats import RequestStatsMonitor
from production_stack_tpu.utils.misc import SingletonABCMeta, SingletonMeta
from production_stack_tpu_torch.engine.server import build_server
from test_torch_kv_offload import AioThread

torch.set_num_threads(1)

ENGINE = ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
          "0", "--max-model-len", "512", "--max-num-seqs", "2",
          "--block-size", "8", "--max-loras", "0", "--dtype", "float32",
          "--no-warmup"]


@pytest.fixture(autouse=True)
def _reset_singletons():
    classes = (rl.RoundRobinRouter, rl.SessionRouter, rl.PrefixAwareRouter,
               rl.KvawareRouter, rl.DisaggregatedPrefillRouter)

    def reset():
        for cls in classes:
            SingletonABCMeta._reset_instance(cls)
        SingletonMeta._reset_instance(RequestStatsMonitor)
        SingletonMeta._reset_instance(EngineStatsScraper)

    reset()
    yield
    reset()


def _router(backends: str, models: str) -> AioThread:
    args = build_parser().parse_args([])
    args.static_backends = backends
    args.static_models = models
    args.routing_logic = "kvaware"
    args.session_key = "x-user-id"
    args.engine_stats_interval = 5
    return AioThread(lambda: build_app(args))


class _Engine:
    def __init__(self, *extra):
        self.httpd, self.core = build_server(ENGINE + list(extra))
        self.server = self.httpd.engine
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.core.stop()


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def _lookup(router: AioThread, text: str) -> dict:
    return _post(router.url + "/kv/lookup", {"text": text})


def _settle(engine: _Engine, timeout: float = 10.0) -> None:
    """Wait until the engine's queued controller reports have been sent."""
    deadline = time.time() + timeout
    while time.time() < deadline and engine.server._reports.unfinished_tasks:
        time.sleep(0.05)
    time.sleep(0.2)


def _served(engine: _Engine, prompt: str):
    return _post(engine.url + "/v1/completions", {
        "prompt": prompt, "max_tokens": 2, "temperature": 0.0})


def test_kvaware_routes_to_the_reporting_port_engine():
    engines = [_Engine(), _Engine()]
    router = _router(",".join(e.url for e in engines), "tiny-llama,tiny-llama")
    for e in engines:
        # Report to the live router (retried lazily on admission).
        e.server.kv_controller_url = router.url
        e.server.start_kv_reporting("127.0.0.1", e.httpd.server_address[1])
    shared = ("context " * 50).strip()  # 399 chars: three full chunks
    try:
        def completion(user, suffix):
            return _post(router.url + "/v1/completions", {
                "model": "tiny-llama", "prompt": shared + " " + suffix,
                "max_tokens": 2, "temperature": 0.0, "ignore_eos": True},
                {"x-user-id": user})

        completion("alice", "first question")
        for e in engines:
            _settle(e)
        served = [i for i, e in enumerate(engines)
                  if e.core.prompt_tokens_total > 0]
        assert len(served) == 1
        target = engines[served[0]]
        assert _lookup(router, shared)["instance_id"] == \
            target.server.instance_id
        for user in ("bob", "carol", "dave"):
            completion(user, f"question from {user}")
            _settle(target)
        other = engines[1 - served[0]]
        assert other.core.prompt_tokens_total == 0, (
            "kv-aware routing sent a same-prefix request to the cold engine")
        assert target.core.cached_tokens_total > 0
    finally:
        router.stop()
        for e in engines:
            e.stop()


@pytest.mark.parametrize("tier", [False, True])
def test_eviction_report_and_the_offload_tier(tier):
    """96 blocks of 8 tokens; a 300-character prompt is three controller
    chunks and ~38 blocks, so four other prompts evict it."""
    router = _router("http://placeholder", "tiny-llama")
    extra = ["--num-blocks", "96", "--kv-controller-url", router.url]
    if tier:
        extra += ["--kv-offload-gb", "1"]
    engine = _Engine(*extra)
    prompt_a = "alpha " * 50
    try:
        _served(engine, prompt_a)
        _settle(engine)
        body = _lookup(router, prompt_a)
        assert body["matched"] > 0
        assert body["instance_id"] == engine.server.instance_id
        for i in range(4):
            _served(engine, f"bravo{i} " * 42)
        _settle(engine)
        stats = engine.core.stats()
        body = _lookup(router, prompt_a)
        if tier:
            # Spilled, not dropped: the claim stays and nothing reported.
            assert stats["offload"]["stored"] > 0
            assert stats["prefix_evicts_total"] == 0
            assert body["instance_id"] == engine.server.instance_id
        else:
            assert stats["prefix_evicts_total"] > 0
            assert stats["evict_listener_errors_total"] == 0
            assert body["matched"] == 0, body  # A's claim is gone
    finally:
        engine.stop()
        router.stop()
    # The reporting threads stop with the server.
    assert not any(th.is_alive() for th in engine.server._kv_threads)
