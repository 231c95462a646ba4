"""The fused step (``fused_step``: a prefill step plan and a decode burst
launched as ONE dispatch) in the torch port, against the port's
alternating schedule and the JAX engine's fused step, on the CPU at
float32 (tiny-llama, the ``make_engine`` configuration of
tests/test_engine_core.py with chunked prefill at a 32-token budget).

- the ``_run_mixed`` traffic of tests/test_prefill_kernel.py (three
  greedy prompts and a structured request): the port's fused streams
  equal its alternating ones and the JAX fused engine's, with
  ``fused_steps_total >= 1`` and the step recorder's ``"fused"`` count
  equal to it; seeded threefry-sampled streams likewise, and an int8
  pool's fused streams equal its alternating ones and the JAX fused
  engine's;
- speculative decoding and a host-tier spill mid-capture degrade the
  step to alternating dispatches, with streams equal to the alternating
  engine's and the JAX fused engine's;
- a fused dispatch that raises finishes its requests with ``"error"``
  and the engine serves the next request;
- at tp 2 (two gloo ranks, the ``Ranks`` harness of
  tests/test_torch_tp.py) the fused streams equal tp 1's, which equal
  the JAX fused engine's on the same weights, and every op the
  followers replayed sampled the leader's tokens;
- ``dispatch_count_total``: one dispatch a fused pair, two a pair of the
  alternating schedule."""

import queue
import time

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine import core as tcore
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

from test_torch_engine import MAKE_ENGINE, cfg_model
from test_torch_tp import Ranks

torch.set_num_threads(1)

CHUNKED = dict(enable_chunked_prefill=True, max_num_batched_tokens=32)
TIMEOUT = 240


def _greedy(n):
    return dict(temperature=0.0, max_tokens=n, ignore_eos=True)


# The _run_mixed traffic: three greedy prompts at once, then a structured
# request alone.
MIXED = [(list(range(1, 60)), _greedy(12)), (list(range(7, 19)), _greedy(12)),
         (list(range(101, 140)), _greedy(12))]
STRUCTURED = (list(range(31, 72)), {"temperature": 0, "max_tokens": 8,
                                    "guided_regex": "[ab]{4}"})
SAMPLED = [(list(range(1, 50)), dict(temperature=0.8, top_p=0.9, seed=11,
                                     max_tokens=12, ignore_eos=True)),
           (list(range(9, 17)), dict(temperature=1.0, top_k=20, seed=5,
                                     max_tokens=16, ignore_eos=True)),
           (list(range(60, 100)), dict(temperature=0.7, seed=3,
                                       max_tokens=10, ignore_eos=True))]


def _run(engine, reqs, sampling_cls, prefix="r"):
    """Add every request under the engine's lock (both engines then take
    the same steps) and collect each stream: (tokens, finish)."""
    queues = []
    with engine._lock:
        for i, (prompt, sampling) in enumerate(reqs):
            q: "queue.Queue" = queue.Queue()
            sp = (sampling_cls.from_request(sampling)
                  if "guided_regex" in sampling else sampling_cls(**sampling))
            engine.add_request(f"{prefix}{i}", list(prompt), sp,
                               lambda t, f, q=q: q.put((t, f)))
            queues.append(q)
    out = []
    for q in queues:
        tokens, deadline = [], time.time() + TIMEOUT
        while True:
            t, f = q.get(timeout=max(deadline - time.time(), 1))
            if t is not None:
                tokens.append(t if isinstance(t, int) else t[0])
            if f is not None:
                out.append((tokens, f))
                break
    return out


def _mixed(engine, sampling_cls):
    return (_run(engine, MIXED, sampling_cls)
            + _run(engine, [STRUCTURED], sampling_cls, prefix="s"))


def _port(tree=None, **over):
    """A started port engine (CHUNKED over MAKE_ENGINE, then ``over``);
    with ``tree``, on the JAX engine's weights."""
    cfg = EngineConfig(device="cpu", **dict(MAKE_ENGINE, **CHUNKED, **over))
    eng = EngineCore(cfg, params=None if tree is None else params_from_numpy(
        tree, cfg_model(cfg), "cpu"))
    eng.start()
    return eng


def _jax_fused(**over):
    """A started JAX fused engine (CHUNKED over MAKE_ENGINE, then
    ``over``) and its weights as a numpy tree."""
    eng = JaxEngineCore(
        JaxEngineConfig(**dict(MAKE_ENGINE, **CHUNKED, **over,
                               fused_step=True)),
        devices=jax.devices()[:1])
    eng.start()
    return eng, jax.tree.map(np.asarray, eng.params)


@pytest.fixture(scope="module")
def engines():
    """The JAX fused engine, and the port's fused and alternating engines
    on its weights."""
    jax_eng = JaxEngineCore(
        JaxEngineConfig(**dict(MAKE_ENGINE, **CHUNKED, fused_step=True)),
        devices=jax.devices()[:1])
    tree = jax.tree.map(np.asarray, jax_eng.params)
    out = {"jax": jax_eng}
    for name, fused in (("fused", True), ("alternating", False)):
        cfg = EngineConfig(device="cpu", fused_step=fused,
                           **dict(MAKE_ENGINE, **CHUNKED))
        out[name] = EngineCore(cfg, params=params_from_numpy(
            tree, cfg_model(cfg), "cpu"))
    for eng in out.values():
        eng.start()
    yield out
    for eng in out.values():
        eng.stop()


def _fused_recorded(eng) -> int:
    return eng.stats()["step_kind_stats"].get("fused", {}).get("count", 0)


def test_fused_streams_equal_alternating_and_jax(engines):
    port, alt = engines["fused"], engines["alternating"]
    before = port.fused_steps_total
    got = _mixed(port, SamplingParams)
    assert port.fused_steps_total - before >= 1
    assert _fused_recorded(port) == port.fused_steps_total
    assert port.stats()["fused_steps_total"] == port.fused_steps_total
    want = _mixed(alt, SamplingParams)
    assert alt.fused_steps_total == 0 and _fused_recorded(alt) == 0
    assert got == want
    assert got == _mixed(engines["jax"], JaxSamplingParams)
    assert all(f == "length" for _, f in got[:3])


def test_fused_sampled_streams_equal(engines):
    """Seeded threefry draws: each row keys on its own seed and step, so
    the fused schedule samples the alternating schedule's tokens (and
    the JAX fused engine's)."""
    port = engines["fused"]
    before = port.fused_steps_total
    got = _run(port, SAMPLED, SamplingParams)
    assert port.fused_steps_total > before
    assert got == _run(engines["alternating"], SAMPLED, SamplingParams)
    assert got == _run(engines["jax"], SAMPLED, JaxSamplingParams)


def test_fused_int8_pool_streams_equal():
    """An int8 pool: the port's fused streams equal its alternating ones
    and the JAX fused engine's on the same weights."""
    jax_eng, tree = _jax_fused(kv_cache_dtype="int8")
    try:
        want = _mixed(jax_eng, JaxSamplingParams)
        assert jax_eng.fused_steps_total >= 1
    finally:
        jax_eng.stop()
    streams = {}
    for fused in (True, False):
        eng = _port(tree, fused_step=fused, kv_cache_dtype="int8")
        try:
            streams[fused] = _mixed(eng, SamplingParams)
            assert (eng.fused_steps_total >= 1) == fused
        finally:
            eng.stop()
    assert streams[True] == streams[False]
    assert streams[True] == want


def test_fused_spec_decode_degrades_with_equal_streams():
    """Speculative bursts cannot ride the fused dispatch (drafting needs
    the emitted tokens): the capture ends and the step degrades; the
    streams equal the alternating engine's and the JAX fused engine's."""
    # Repetitive prompts: prompt lookup drafts for both rows.
    prompts = [([5, 6, 7, 8] * 9, _greedy(16)), ([9, 10, 11] * 13,
                                                 _greedy(16))]
    over = dict(speculative_num_tokens=4)
    streams = {}
    for fused in (True, False):
        eng = _port(fused_step=fused, **over)
        calls = []
        do_fused = eng._do_fused
        eng._do_fused = lambda plan: calls.append(plan) or do_fused(plan)
        try:
            streams[fused] = _run(eng, prompts, SamplingParams)
            assert eng.spec_verify_bursts_total > 0
            # Every fused action the scheduler took degraded.
            assert bool(calls) == fused and eng.fused_steps_total == 0
        finally:
            eng.stop()
    assert streams[True] == streams[False]
    jax_eng, tree = _jax_fused(**over)
    port = _port(tree, fused_step=True, **over)
    try:
        assert (_run(port, prompts, SamplingParams)
                == _run(jax_eng, prompts, JaxSamplingParams))
    finally:
        port.stop()
        jax_eng.stop()


def test_fused_spill_mid_capture_degrades():
    """A 24-block pool with a host tier: a finished prompt's cached pages
    are evicted while a later step plan's chunk is already captured, so
    the spill (an ``offload_blocks`` op) launches the captured prefill
    first and the step degrades; the streams equal the alternating
    engine's and the JAX fused engine's on the same weights."""
    over = dict(num_blocks=24, kv_offload_bytes=1 << 20, max_loras=0)

    def traffic(eng, sampling_cls):
        first = _run(eng, [(list(range(200, 240)), _greedy(4))],
                     sampling_cls, prefix="a")
        return first + _run(eng, [(list(range(1, 9)), _greedy(24)),
                                  (list(range(300, 348)), _greedy(4))],
                            sampling_cls)

    jax_eng, tree = _jax_fused(**over)
    try:
        want = traffic(jax_eng, JaxSamplingParams)
    finally:
        jax_eng.stop()
    streams, drained = {}, {}
    for fused in (True, False):
        eng = _port(tree, fused_step=fused, **over)
        seen = []
        drain = eng._drain_captured

        def spy(cap, drain=drain, seen=seen):
            seen.append([name for name, *_rest, ph in cap if not ph.ready])
            return drain(cap)

        eng._drain_captured = spy
        try:
            streams[fused] = traffic(eng, SamplingParams)
            assert eng.stats()["offload"]["stored"] > 0
            assert eng.scheduler.num_preempted_total == 0
        finally:
            eng.stop()
        drained[fused] = [names for names in seen if names]
    assert ["prefill"] in drained[True]
    assert drained[False] == []
    assert streams[True] == streams[False]
    assert streams[True] == want


def test_fused_dispatch_failure_fails_its_requests():
    eng = _port(fused_step=True, max_loras=0)
    exec_op = eng._exec_op
    failed = []

    def boom(name, static, arrays):
        if name == "fused" and not failed:
            failed.append(static["names"])
            raise RuntimeError("injected fused dispatch failure")
        return exec_op(name, static, arrays)

    eng._exec_op = boom
    try:
        out = _run(eng, MIXED, SamplingParams)
        assert failed and failed[0][-1] == "decode"
        assert "error" in {f for _, f in out}
        assert eng.fused_steps_total == 0
        # Nothing is left behind: the next request is served whole.
        (tokens, finish), = _run(eng, [(list(range(5, 20)), _greedy(6))],
                                 SamplingParams, prefix="n")
        assert finish == "length" and len(tokens) == 6
        assert eng.scheduler.num_running == 0
    finally:
        eng.stop()


def _step(eng):
    """One scheduler action of an engine whose thread is not started, run
    as the loop runs it: (action, dispatches it launched)."""
    with eng._lock:
        action, req = eng.scheduler.next_action()
    before = eng.dispatch_count_total
    with eng._step_lock, torch.inference_mode():
        if action == "fused":
            eng._do_fused(req)
        elif action == "prefill_step":
            eng._do_prefill_step(req)
        elif action == "decode":
            eng._do_decode()
        else:
            eng._flush_pending_prefills()
            eng._flush_pending_burst()
    return action, eng.dispatch_count_total - before


def test_one_dispatch_a_fused_pair_two_alternating():
    """A short prompt decodes while a 100-token prompt prefills in four
    32-token step plans: fused, each plan and its decode burst take one
    dispatch; alternating, a plan's dispatch and a burst's."""
    assert tcore._unsupported(EngineConfig(fused_step=True)) == []
    steps = {}
    for fused in (True, False):
        eng = EngineCore(EngineConfig(
            device="cpu", fused_step=fused,
            **dict(MAKE_ENGINE, **CHUNKED, max_loras=0,
                   max_consecutive_prefills=1)))
        eng.add_request("short", list(range(1, 9)),
                        SamplingParams(**_greedy(40)), lambda t, f: None)
        assert _step(eng) == ("prefill_step", 1)
        eng.add_request("long", list(range(20, 120)),
                        SamplingParams(**_greedy(4)), lambda t, f: None)
        steps[fused] = [_step(eng) for _ in range(9)]
        eng.stop()
    fused = [n for action, n in steps[True] if action == "fused"]
    assert fused == [1, 1, 1, 1]  # the four plans, a dispatch each
    alternating = steps[False]
    first = next(i for i, (a, _) in enumerate(alternating)
                 if a == "prefill_step")
    window = alternating[first:first + 8]
    assert window == [("prefill_step", 1), ("decode", 1)] * 4


# -- tp 2 --------------------------------------------------------------------

_WORKER = r"""
import base64, pickle, queue, sys, traceback
import torch
torch.set_num_threads(1)
from production_stack_tpu_torch.parallel import multihost

env = multihost.initialize_from_env()
ctx = multihost.maybe_context()


def engine_job(job):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    core = EngineCore(EngineConfig(**job["config"]), params=job["tree"],
                      multihost=ctx)
    core.sampled_log = []
    if env["process_id"] != 0:
        core.run_follower()
        return {"log": core.sampled_log}
    core.start()
    queues = []
    try:
        with core._lock:
            for i, (prompt, sampling) in enumerate(job["requests"]):
                q = queue.Queue()
                core.add_request("r%d" % i, prompt,
                                 SamplingParams(**sampling),
                                 lambda t, f, q=q: q.put((t, f)))
                queues.append(q)
        streams = []
        for q in queues:
            toks = []
            while True:
                t, f = q.get(timeout=60)
                if t is not None:
                    toks.append(int(t))
                if f is not None:
                    streams.append((toks, f))
                    break
        stats = core.stats()
    finally:
        core.stop()
    return {"streams": streams, "log": core.sampled_log, "stats": stats}


for line in sys.stdin:
    job = pickle.loads(base64.b64decode(line))
    if job is None:
        break
    try:
        out = {"ok": engine_job(job)}
    except BaseException:
        out = {"error": traceback.format_exc()}
    sys.stdout.write("RESULT " + base64.b64encode(pickle.dumps(out)).decode()
                     + "\n")
    sys.stdout.flush()
multihost.shutdown(ctx)
"""


def test_fused_at_tp2_equals_tp1():
    """Each fused pair is one op-channel message: the followers replay its
    constituent ops through ``_exec_op`` and sample the leader's tokens.
    On the JAX fused engine's weights, the tp 1 streams equal the JAX
    engine's and the tp 2 streams equal tp 1's."""
    over = dict(max_loras=0, seed=0)
    reqs = MIXED + [SAMPLED[1]]
    jax_eng, tree = _jax_fused(**over)
    try:
        jax_want = _run(jax_eng, reqs, JaxSamplingParams)
    finally:
        jax_eng.stop()
    tp1 = _port(tree, fused_step=True, **over)
    try:
        want = _run(tp1, reqs, SamplingParams)
        assert tp1.fused_steps_total >= 1
    finally:
        tp1.stop()
    assert want == jax_want
    config = dict(MAKE_ENGINE, **CHUNKED, **over, device="cpu",
                  fused_step=True, tensor_parallel_size=2)
    ranks = Ranks(2, _WORKER)
    try:
        leader, follower = ranks.run(dict(config=config, tree=tree,
                                          requests=reqs))
    finally:
        ranks.close()
    assert leader["streams"] == want
    assert leader["stats"]["fused_steps_total"] >= 1
    assert leader["stats"]["tensor_parallel"]["size"] == 2
    assert len(follower["log"]) == len(leader["log"]) > 0
    for (n0, a0), (n1, a1) in zip(leader["log"], follower["log"]):
        assert n0 == n1
        np.testing.assert_array_equal(a0, a1)


def test_fused_placeholder_readback_waits_for_its_dispatch():
    """A readback of a captured op is not ready until the fused dispatch
    fills its placeholder, and raises the dispatch's error."""
    ph = tcore._FusedPlaceholder()
    rb = tcore._Readback(ph)
    assert not rb.ready
    ph.settle((torch.tensor([3]), torch.tensor([0.5])))
    assert rb.ready and [a.tolist() for a in rb.get()] == [[3], [0.5]]
    bad = tcore._FusedPlaceholder()
    rb = tcore._Readback(bad)
    bad.settle(error=RuntimeError("lost"))
    with pytest.raises(RuntimeError, match="lost"):
        rb.get()
