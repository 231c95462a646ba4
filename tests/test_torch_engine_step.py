"""The JAX engine's default serving step in the torch ``EngineCore``,
against the JAX engine: threefry-keyed sampled streams, storm-scoped
prefill batching, chunked-prefill step plans, ``decode_steps_pressure``
and the pipelined decode bursts, at tiny-llama float32 with the JAX
engine's weights (``tests/test_torch_engine.py``'s ``Pair``).

Every scenario hands all its requests to an engine in one critical
section (under the engine's lock), so both engines see the same queue
and take the same steps: seeded sampled streams must then be token-
identical, since every draw's key depends on the request seed, its
position and, in a batched prefill, the batch-mates' lengths."""

import queue
import time

import pytest
import torch

from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine.sampling import SamplingParams

from test_torch_engine import Pair

torch.set_num_threads(1)

_ids = iter(range(10 ** 9))


def _run(engine, prompts, samplings, timeout=240):
    """Streams (tokens, finish) of ``prompts``, all added to ``engine`` in
    one critical section."""
    queues = []
    with engine._lock:
        for prompt, sp in zip(prompts, samplings):
            q: "queue.Queue" = queue.Queue()
            engine.add_request(f"st{next(_ids)}", prompt, sp,
                               lambda t, f, q=q: q.put((t, f)))
            queues.append(q)
    out = []
    deadline = time.time() + timeout
    for q in queues:
        tokens = []
        while True:
            t, f = q.get(timeout=max(deadline - time.time(), 1))
            if t is not None:
                tokens.append(t if isinstance(t, int) else t[0])
            if f is not None:
                out.append((tokens, f))
                break
    return out


def _both(pair, prompts, samplings):
    """Streams of both engines; ``samplings`` are SamplingParams kwargs."""
    want = _run(pair.jax, prompts,
                [JaxSamplingParams(**s) for s in samplings])
    got = _run(pair.torch, prompts, [SamplingParams(**s) for s in samplings])
    return want, got


def _sampled(i, **over):
    return dict(dict(temperature=0.8, top_k=[0, 20, 0, 8][i % 4],
                     top_p=[1.0, 1.0, 0.9, 0.95][i % 4], seed=1000 + 17 * i,
                     max_tokens=24, ignore_eos=True), **over)


def test_sampled_streams_with_batching_preemption_and_prefix_hit():
    """Four seeded sampled prompts arrive together: short chunks make
    them a storm (one batched prefill), a 24-block pool preempts and
    resumes some of them, and a follow-up prompt hits the prefix cache."""
    pair = Pair(prefill_chunk_size=16, num_blocks=24)
    try:
        prompts = [list(range(300 + 10 * i, 310 + 10 * i)) for i in range(4)]
        samplings = [_sampled(i) for i in range(4)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        for eng in (pair.jax, pair.torch):
            assert eng.scheduler.num_preempted_total > 0
            assert eng.prefill_group_count > 0
        assert (pair.torch.prefill_group_rows, pair.torch.prefill_group_count
                ) == (pair.jax.prefill_group_rows, pair.jax.prefill_group_count)
        base = list(range(200, 216))
        want, got = _both(pair, [base], [_sampled(5, max_tokens=4)])
        assert got == want
        cached = pair.torch.cached_tokens_total
        want, got = _both(pair, [base + [7, 8, 9]],
                          [_sampled(6, max_tokens=10)])
        assert got == want
        assert pair.torch.cached_tokens_total - cached >= 12
        # Ids past the 512-token vocabulary: the JAX gather clamps them.
        want, got = _both(pair, [list(range(505, 521))],
                          [_sampled(7, max_tokens=6)])
        assert got == want and got[0][1] == "length"
    finally:
        pair.stop()


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_storm_batches_in_both_engines(kv_cache_dtype):
    """Six 40-token prompts (three 16-token chunks each) against four
    slots: the storm gate opens, groups of up to prefill_batch rows share
    each chunk's dispatch (padding rows drop their page writes, in both
    page encodings), and both engines batch alike."""
    pair = Pair(prefill_chunk_size=16, max_model_len=96, num_blocks=160,
                kv_cache_dtype=kv_cache_dtype)
    try:
        prompts = [list(range(100 + 40 * i, 140 + 40 * i)) for i in range(6)]
        samplings = [_sampled(i, max_tokens=6 + i) for i in range(6)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        t, j = pair.torch, pair.jax
        assert t.prefill_group_count > 0
        assert t.prefill_batched_dispatch_total >= 3
        assert (t.prefill_group_count, t.prefill_group_rows) == (
            j.prefill_group_count, j.prefill_group_rows)
    finally:
        pair.stop()


def test_chunked_step_plans_equal_jax():
    """Chunked prefill under a 32-token budget (the prompts of
    tests/test_chunked_prefill.py::test_chunked_streams_equal_unchunked):
    step plans batch rows, defer tokens, and stream as the JAX engine."""
    pair = Pair(enable_chunked_prefill=True, max_num_batched_tokens=32)
    try:
        prompts = [list(range(1, 60)), list(range(7, 19)),
                   list(range(101, 140))]
        samplings = [_sampled(i, max_tokens=12) for i in range(3)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        assert pair.torch.prefill_chunks_total >= 4
        assert pair.torch.deferred_prefill_tokens_total > 0
        assert pair.torch.prefill_chunks_total == pair.jax.prefill_chunks_total
    finally:
        pair.stop()


def test_chunked_preempt_resume_and_pressure_equal_jax():
    """Chunked prefill over a 30-block pool, a decode forced after every
    prefill step (max_consecutive_prefills=1) and decode_steps_pressure=2.
    First the case of tests/test_chunked_prefill.py::
    test_chunked_preempt_resume_equals_ample_reference: 44 blocks of
    demand preempt the younger request, which resumes through a chunked
    re-prefill of its generated tokens. Then four prompts arrive while
    slots are free: the forced bursts shrink to 2 steps while an
    admissible prompt waits, in both engines."""
    pair = Pair(num_blocks=30, enable_chunked_prefill=True,
                max_num_batched_tokens=16, max_consecutive_prefills=1,
                decode_steps_pressure=2)
    try:
        prompts = [list(range(1, 9)), list(range(11, 59))]
        samplings = [_sampled(i, max_tokens=60) for i in range(2)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        assert pair.torch.scheduler.num_preempted_total >= 1
        prompts = [list(range(40 + 30 * i, 60 + 30 * i)) for i in range(4)]
        samplings = [_sampled(i, max_tokens=14) for i in range(4)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        bursts = [r["forwards"] for r in pair.torch.step_recorder.snapshot(
            kind="decode_burst")]
        assert 2 in bursts and 8 in bursts
        assert (pair.torch.decode_forward_steps_total
                == pair.jax.decode_forward_steps_total)
    finally:
        pair.stop()
