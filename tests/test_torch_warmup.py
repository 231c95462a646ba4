"""The torch port's engine warm-up against the JAX engine's, on the CPU.

- ``EngineCore.warmup`` runs the JAX engine's set of serving shapes: its
  ``warmup_variants`` (prefill, decode, spec-verify and draft counts)
  equal the JAX engine's in each configuration of
  ``tests/test_engine_core.py``'s, ``tests/test_kv_quant.py``'s and
  ``tests/test_prefill_kernel.py``'s compile-budget cases, at a small
  size, and every port pool (bf16 or int8 pages, the drafter's too) is
  bit for bit what it was (int8 weights run the int8 products);
- nothing serving-facing moves: with the JAX engine's weights carried
  across, a served port engine's pool, allocator, ``stats()``,
  ``/metrics`` and ``/debug/steps`` are unchanged by a warm-up, and its
  greedy and seeded streams after it equal the JAX engine's after its
  own;
- the server: ``--no-warmup`` parses to the same ``args.warmup`` on both
  servers; a default port server warms before its socket is bound, so
  ``/health`` first answers a warm engine, and a warm-up that fails
  stops the start-up.

The ranks' warm-up (tp 2, pp 2) is held in ``tests/test_torch_tp.py`` and
``tests/test_torch_pp.py``, on their module-scoped groups of ranks."""

import json
import queue
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import server as jserver
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

from test_torch_engine import cfg_model

torch.set_num_threads(1)

# Table widths 4 and 8, buckets 32 and 64: every doubling loop of the
# warm-up runs twice. The EngineConfig defaults (prefill_batch 4, chunks
# of 1,024) otherwise.
DEFAULTS = dict(model="tiny-llama", max_model_len=64, max_num_seqs=2,
                block_size=8, num_blocks=32, max_loras=0, dtype="float32")
# One table width and one bucket, the servers' prefill_batch of 1: each
# JAX program costs a compile, so the other cases stay this small.
SMALL = dict(DEFAULTS, max_model_len=32, prefill_batch=1)
CASES = {
    "defaults": DEFAULTS,
    "prefill_batch_4_chunked": dict(
        SMALL, prefill_batch=4, prefill_chunk_size=16, min_prefill_bucket=16,
        enable_chunked_prefill=True, max_num_batched_tokens=16),
    "decode_steps_pressure": dict(SMALL, decode_steps_pressure=2),
    "speculative": dict(SMALL, speculative_num_tokens=4),
    "draft_model": dict(SMALL, speculative_num_tokens=4,
                        speculative_draft_model="tiny-llama"),
    "int8_kv_and_weights": dict(SMALL, kv_cache_dtype="int8",
                                quantization="int8"),
    "fused_step": dict(SMALL, fused_step=True, enable_chunked_prefill=True,
                       max_num_batched_tokens=32),
}
PROMPT = [int(t) for t in np.random.default_rng(3).integers(0, 500, 21)]
REQUESTS = [(PROMPT, dict(temperature=0.0, max_tokens=8, ignore_eos=True)),
            (PROMPT[:13], dict(temperature=0.8, top_p=0.9, seed=7,
                               max_tokens=8, ignore_eos=True))]
# Served before the warm-up so that the pool holds pages (no prefix of it
# is shared with REQUESTS).
FIRST = list(range(100, 120))


def _jax_warm(case: str, serve: bool = False):
    """The JAX engine of ``case`` after its warm-up: (warmup_variants,
    its weights as numpy, the streams of REQUESTS served after it)."""
    core = JaxEngineCore(JaxEngineConfig(**CASES[case]),
                         devices=jax.devices()[:1])
    try:
        if serve:
            core.start()
        core.warmup()
        streams = _serve(core, REQUESTS, JaxSamplingParams) if serve else None
        return (dict(core.warmup_variants),
                jax.tree.map(np.asarray, core.params), streams)
    finally:
        core.stop()


@pytest.fixture(scope="module")
def jax_defaults():
    return _jax_warm("defaults", serve=True)


def _serve(core, requests, sampling_cls):
    """Each request served alone: its tokens and finish reason."""
    out = []
    for i, (prompt, sampling) in enumerate(requests):
        q: "queue.Queue" = queue.Queue()
        core.add_request(f"w{i}-{len(prompt)}", prompt,
                         sampling_cls(**sampling),
                         lambda t, f: q.put((t, f)))
        toks = []
        while True:
            t, f = q.get(timeout=120)
            if t is not None:
                toks.append(int(t if isinstance(t, int) else t[0]))
            if f is not None:
                out.append((toks, f))
                break
    return out


def _quiesce(core, timeout=60.0):
    """Wait until the engine's last step is done and nothing of it is in
    flight: a request finishes inside a step (its last tokens are read
    back while the next burst runs), whose counters move after that."""
    deadline = time.monotonic() + timeout
    while True:
        with core.between_steps():
            if core._pending_burst is None and not core._pending_prefills:
                return
        assert time.monotonic() < deadline, "the engine never went idle"
        time.sleep(0.01)


def _pools(core):
    """Copies of every page tensor of the engine (the drafter's too)."""
    sides = list(core.kv) + (list(core._draft.kv) if core._draft else [])
    return [t.clone() for s in sides
            for t in (s if isinstance(s, tuple) else (s,))]


def _serving_stats(core) -> dict:
    """stats() less the warm-up's own keys and the bandwidth share (a
    rate over a wall-clock window, which moves as time passes)."""
    s = core.stats()
    for k in ("warmup_variants", "warmup_seconds",
              "model_bandwidth_utilization"):
        s.pop(k)
    return s


@pytest.mark.parametrize("case", sorted(CASES))
def test_warmup_variants_equal_the_jax_engine(case, jax_defaults):
    want = (jax_defaults[0] if case == "defaults" else _jax_warm(case)[0])
    core = EngineCore(EngineConfig(device="cpu", **CASES[case]))
    pools, stats = _pools(core), _serving_stats(core)
    free = core.kv_mgr.allocator.num_free
    assert core.stats()["warmup_variants"] == {}
    core.warmup()
    assert core.warmup_variants == want
    assert core.stats()["warmup_variants"] == want
    assert core.stats()["warmup_seconds"] > 0
    # Every dummy slot is -1: no page of any pool (int8 pages and their
    # scales, the drafter's) was written.
    for a, b in zip(pools, _pools(core)):
        assert torch.equal(a, b)
    assert core.kv_mgr.allocator.num_free == free
    assert _serving_stats(core) == stats
    assert core.warmup_launches == {
        "paged_attention": 0, "paged_attention_int8": 0,
        "cached_prefill_attention": 0,
        "cached_prefill_attention_int8": 0}  # the CPU runs no kernel


def _get(base: str, path: str) -> str:
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.read().decode()


def _metrics(base: str) -> list:
    return [ln for ln in _get(base, "/metrics").splitlines()
            if not ln.startswith("tpu:model_bandwidth_utilization")]


def test_warmup_moves_nothing_serving_facing(jax_defaults):
    """A served engine holding the JAX engine's weights: its pool,
    allocator, serving counters, /metrics and /debug/steps are the same
    after a warm-up, its follow-on streams the JAX engine's after its own
    warm-up, and its sampling keys' counts and feedback tokens are put
    back."""
    _, tree, want = jax_defaults
    cfg = EngineConfig(device="cpu", **DEFAULTS)
    core = EngineCore(cfg, params=params_from_numpy(tree, cfg_model(cfg),
                                                    "cpu"))
    httpd, core = tserver.build_server(
        ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
         "0", "--no-warmup"], core=core)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert core.warmup_seconds is None  # --no-warmup
        _serve(core, [(FIRST, dict(temperature=0.0, max_tokens=5))],
               SamplingParams)
        _quiesce(core)
        pools, stats = _pools(core), _serving_stats(core)
        free = core.kv_mgr.allocator.num_free
        counts = core._token_counts.clone()
        feedback = core._last_burst_tokens
        metrics, steps = _metrics(base), _get(base, "/debug/steps")
        assert any(pool.any() for pool in pools)  # pages were written
        core.warmup()
        assert core.warmup_variants == jax_defaults[0]
        for a, b in zip(pools, _pools(core)):
            assert torch.equal(a, b)
        assert core.kv_mgr.allocator.num_free == free
        assert torch.equal(core._token_counts, counts)
        assert core._last_burst_tokens is feedback
        assert core._pending_burst is None and not core._pending_prefills
        assert _serving_stats(core) == stats
        assert _metrics(base) == metrics
        assert _get(base, "/debug/steps") == steps
        got = _serve(core, REQUESTS, SamplingParams)
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    assert got == want


@pytest.mark.parametrize("argv,warm", [([], True), (["--no-warmup"], False)])
def test_no_warmup_parses_alike_on_both_servers(argv, warm):
    jargs = jserver.build_arg_parser().parse_args(["tiny-llama"] + argv)
    targs = tserver.build_arg_parser().parse_args(["tiny-llama"] + argv)
    assert jargs.warmup is targs.warmup is warm


def test_default_server_warms_before_health_answers(monkeypatch):
    """The warm-up runs before the socket is bound: the first /health
    answers a warm engine."""
    events = []
    bind = tserver._HTTPServer.server_bind

    def server_bind(self):
        events.append("bind")
        bind(self)

    monkeypatch.setattr(tserver._HTTPServer, "server_bind", server_bind)
    core = EngineCore(EngineConfig(device="cpu", **SMALL))
    warm = core.warmup

    def warmup():
        warm()
        events.append("warmup")

    core.warmup = warmup
    httpd, core = tserver.build_server(
        ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
         "0"], core=core)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert events == ["warmup", "bind"]
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            assert resp.status == 200
        assert core.stats()["warmup_variants"] == {
            "prefill": 2, "decode": 1, "spec": 0, "draft": 0}
        out = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/v1/completions",
            data=json.dumps({"prompt": "warm", "max_tokens": 3,
                             "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"}),
            timeout=60).read())
        assert out["choices"][0]["finish_reason"] in ("length", "stop")
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()


def test_a_failed_warmup_stops_the_start_up():
    core = EngineCore(EngineConfig(device="cpu", **SMALL))

    def warmup():
        raise RuntimeError("no kernel library")

    core.warmup = warmup
    with pytest.raises(RuntimeError, match="no kernel library"):
        tserver.build_server(["tiny-llama", "--device", "cpu", "--port",
                              "0"], core=core)
    assert core._thread.ident is None  # never started
