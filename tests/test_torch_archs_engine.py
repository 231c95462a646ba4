"""OPT and Mixtral through the torch ``EngineCore`` against the JAX
engine: tiny-opt and tiny-mixtral in float32 with the JAX engine's own
weights (``tests/test_torch_engine.py``'s ``Pair``), greedy and seeded
sampled streams token-identical through a prefix hit, chunked prefill,
storm batching, preemption and int8 KV pages, prompt-lookup speculation,
structured output and an offload tier's restore; and the architecture
gating of both engines (int8 weights for the Llama family only; LoRA
slots only in a Llama model)."""

import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.structured import api as jax_api
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.structured import api

from test_torch_engine import MAKE_ENGINE, Pair
from test_torch_engine_step import _both, _run, _sampled

torch.set_num_threads(1)

ARCHS = ["tiny-opt", "tiny-mixtral"]


def _greedy(max_tokens, **over):
    return dict(dict(temperature=0.0, max_tokens=max_tokens,
                     ignore_eos=True), **over)


@pytest.mark.parametrize("model", ARCHS)
@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_streams_with_prefix_hit_chunks_and_preemption(model,
                                                       kv_cache_dtype):
    """Greedy and seeded sampled prompts arrive together: 16-token chunks
    make a storm of the long ones (a batched prefill), a 24-block pool
    preempts and resumes some of them; then a prompt hits the prefix
    cache of an earlier one. Both page encodings."""
    pair = Pair(model=model, prefill_chunk_size=16, num_blocks=24,
                kv_cache_dtype=kv_cache_dtype)
    try:
        assert "lora" not in pair.torch.params
        prompts = [list(range(300 + 10 * i, 330 + 10 * i)) for i in range(4)]
        samplings = [_sampled(i) if i % 2 else _greedy(20)
                     for i in range(4)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        for eng in (pair.jax, pair.torch):
            assert eng.scheduler.num_preempted_total > 0
            assert eng.prefill_group_count > 0
        base = list(range(200, 224))
        want, got = _both(pair, [base], [_greedy(4)])
        assert got == want
        cached = pair.torch.cached_tokens_total
        want, got = _both(pair, [base + [7, 8, 9]],
                          [_sampled(6, max_tokens=10)])
        assert got == want
        assert pair.torch.cached_tokens_total - cached >= 20
        assert pair.torch.cached_tokens_total == pair.jax.cached_tokens_total
    finally:
        pair.stop()


@pytest.mark.parametrize("model", ARCHS)
def test_chunked_step_plans_equal_jax(model):
    """Chunked prefill under a 32-token budget: step plans batch rows and
    defer tokens, and the streams equal the JAX engine's."""
    pair = Pair(model=model, enable_chunked_prefill=True,
                max_num_batched_tokens=32)
    try:
        prompts = [list(range(1, 60)), list(range(7, 19)),
                   list(range(101, 140))]
        samplings = [_sampled(i, max_tokens=12) for i in range(3)]
        want, got = _both(pair, prompts, samplings)
        assert got == want
        assert pair.torch.deferred_prefill_tokens_total > 0
        assert pair.torch.prefill_chunks_total == pair.jax.prefill_chunks_total
    finally:
        pair.stop()


@pytest.mark.parametrize("model", ARCHS)
def test_prompt_lookup_speculation_equals_jax(model):
    """Prompt-lookup speculation serves both archs, as in the JAX
    engine: a repetitive prompt's greedy stream and its verify counters
    equal the JAX engine's."""
    pair = Pair(model=model, speculative_num_tokens=3)
    try:
        prompts = [[5, 6, 7, 8] * 6]
        want, got = _both(pair, prompts, [_greedy(16)])
        assert got == want
        assert (pair.torch.spec_verify_bursts_total
                == pair.jax.spec_verify_bursts_total)
    finally:
        pair.stop()


@pytest.mark.parametrize("model", ARCHS)
def test_structured_output_equals_jax(model):
    """Grammar rows beside an unconstrained one: every sampling site
    masked, streams and violations equal to the JAX engine's."""
    pair = Pair(model=model)
    try:
        bodies = [{"guided_regex": "[ab]{3}"},
                  {"guided_json": {"type": "object", "properties": {
                      "n": {"type": "integer"}}, "required": ["n"]}}]
        prompts = [list(range(20, 40)), list(range(60, 75)),
                   list(range(90, 99))]
        want = _run(pair.jax, prompts, [
            JaxSamplingParams(**_greedy(24),
                              structured=jax_api.parse_structured(b))
            for b in bodies] + [JaxSamplingParams(**_greedy(8))])
        got = _run(pair.torch, prompts, [
            SamplingParams(**_greedy(24), structured=api.parse_structured(b))
            for b in bodies] + [SamplingParams(**_greedy(8))])
        assert got == want
        assert (pair.torch.structured_violations_total
                == pair.jax.structured_violations_total)
    finally:
        pair.stop()


@pytest.mark.parametrize("model", ARCHS)
def test_offload_restore_equals_jax(model):
    """A prompt's blocks evicted by fillers into a host tier and restored
    on its repeat: the stream of the prefix hit, the JAX engine's
    offload counters."""
    pair = Pair(model=model, num_blocks=24, kv_offload_bytes=1 << 30,
                prefill_chunk_size=16)
    try:
        prompt = list(range(100, 130))
        want, got = _both(pair, [prompt], [_greedy(4)])
        hit_want, hit_got = _both(pair, [prompt], [_greedy(4)])
        assert (got, hit_got) == (want, hit_want)
        for i in range(4):  # fillers that evict the prompt's blocks
            want, got = _both(pair, [list(range(200 + 50 * i,
                                                240 + 50 * i))],
                              [_greedy(4)])
            assert got == want
        again_want, again_got = _both(pair, [prompt], [_greedy(4)])
        assert again_got == again_want == hit_got
        keys = ("hits", "misses", "stored", "evicted", "blocks")
        tstats, jstats = (pair.torch.stats()["offload"],
                          pair.jax.stats()["offload"])
        assert tstats["hits"] >= 7
        assert {k: tstats[k] for k in keys} == {k: jstats[k] for k in keys}
    finally:
        pair.stop()


@pytest.mark.parametrize("model", ARCHS)
def test_int8_weights_are_refused_as_in_jax(model):
    """``quantization="int8"`` on a non-Llama arch: the JAX engine's
    ValueError, with its message, in both engines."""
    kwargs = dict(MAKE_ENGINE, model=model, quantization="int8")
    with pytest.raises(ValueError) as jerr:
        JaxEngineCore(JaxEngineConfig(**kwargs))
    with pytest.raises(ValueError) as terr:
        EngineCore(EngineConfig(device="cpu", **kwargs))
    assert str(terr.value) == str(jerr.value)
    assert "llama family" in str(terr.value)


@pytest.mark.parametrize("model", ARCHS)
def test_no_lora_slots_outside_the_llama_family(model):
    eng = EngineCore(EngineConfig(device="cpu", **dict(MAKE_ENGINE,
                                                       model=model)))
    assert "lora" not in eng.params
    assert eng.load_lora_adapter("ad") is False
    assert eng.lora_slots == {}
