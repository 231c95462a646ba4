"""Structured output under speculative decoding in the torch port,
against the JAX engine.

Both proposers (prompt lookup; a draft model, its FSM-constrained
drafting under ``speculative_draft_constrain`` on and off) on tiny-llama
at float32, the port holding the JAX engine's target and drafter weights
(``tests/test_torch_spec_decode.py``'s ``SpecPair``); each scenario's
requests go to both engines in one critical section. Streams and the
``spec_*`` and ``structured_*`` counters equal the JAX engine's. The case
of ``tests/test_structured_output.py::test_engine_spec_decode_structured_parity``
(whose speculative stream differs from the JAX engine's plain one) is
held to the JAX engine's actual speculative output. The FSM-constrained
draft step's rows must ascend over the whole bucket (the cached-prefill
kernel takes a query tile's key range from its last position)."""

import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as jax_sampling
from production_stack_tpu.structured import api as jax_api
from production_stack_tpu_torch.engine import sampling
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.structured import api

from test_torch_spec_decode import COUNTERS as SPEC_COUNTERS
from test_torch_spec_decode import DRAFT, SPEC_CFG, SpecPair, _run

torch.set_num_threads(1)

COUNTERS = SPEC_COUNTERS + (
    "structured_requests_total", "structured_mask_states_total",
    "structured_violations_total", "structured_cache_entries")
NSCHEMA = {"type": "object", "properties": {"n": {"type": "integer"}},
           "required": ["n"]}
ENUM = {"enum": ["red", "green", "blue"]}
# (prompt, structured body, SamplingParams kwargs): structured rows beside
# an unconstrained one, greedy and seeded sampled.
REQS = [
    ([5, 6, 7, 8] * 6, {"guided_json": NSCHEMA},
     dict(max_tokens=16, temperature=0.0)),
    ([31, 7, 2, 19, 44, 3, 28, 11], {"guided_regex": "[ab]{3}"},
     dict(max_tokens=16, temperature=0.0)),
    ([9, 10, 11] * 8, {}, dict(max_tokens=24, temperature=0.0,
                               ignore_eos=True)),
    ([3, 4] * 10, {"response_format": {"type": "json_object"}},
     dict(max_tokens=20, temperature=0.8, seed=5)),
]
# Sampled rows whose prompts hold their grammar's text, so that prompt
# lookup finds drafts in every row at once.
SAMPLED = [
    ([97, 98] * 10, {"guided_regex": "(ab)+"},
     dict(max_tokens=12, temperature=0.8, seed=11)),
    ([97, 98, 99] * 7, {"guided_regex": "(abc)+"},
     dict(max_tokens=24, temperature=0.8, seed=12, top_k=20)),
    (list(b'{"n":12}' * 4), {"response_format": {
        "type": "json_schema", "json_schema": {"schema": NSCHEMA}}},
     dict(max_tokens=24, temperature=0.8, seed=13, top_p=0.9)),
]
CONFIGS = {
    "ngram": {},
    "draft": DRAFT,
    "draft_unconstrained": dict(DRAFT, speculative_draft_constrain=False),
    "draft_tight_chunked": dict(DRAFT, enable_chunked_prefill=True,
                                max_num_batched_tokens=32, num_blocks=8),
}


def _reqs(reqs, parse):
    return [(p, dict(kw, structured=parse(b))) for p, b, kw in reqs]


def _stats(engine):
    s = engine.stats()
    return {k: s[k] for k in COUNTERS}


@pytest.mark.parametrize("requests", ["greedy", "sampled"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_spec_structured_streams_equal_jax(config, requests):
    reqs = REQS if requests == "greedy" else SAMPLED
    pair = SpecPair(**CONFIGS[config])
    try:
        want = _run(pair.jax, _reqs(reqs, jax_api.parse_structured),
                    jax_sampling.SamplingParams)
        got = _run(pair.torch, _reqs(reqs, api.parse_structured),
                   sampling.SamplingParams)
        assert got == want
        ts = _stats(pair.torch)
        assert ts == _stats(pair.jax)
        assert ts["spec_verify_bursts_total"] >= 1
        if config.startswith("draft"):
            assert ts["spec_draft_forward_steps_total"] > 0
        if config == "draft_tight_chunked" and requests == "greedy":
            assert ts["num_preempted_total"] >= 1
    finally:
        pair.stop()


def test_reference_spec_structured_case_equals_jax():
    """The JAX reference test's own case (its engine configuration, its
    guided_json body, greedy, prompt lookup) at float32: the port's
    speculative stream and counters equal the JAX engine's speculative
    ones (a length cap mid-structure counts a violation in both)."""
    cfg = dict(model="tiny-llama", max_model_len=128, max_num_seqs=4,
               block_size=4, num_blocks=96, min_prefill_bucket=16,
               max_loras=0, dtype="float32", speculative_num_tokens=4)
    pair = SpecPair(**cfg)
    try:
        body = {"temperature": 0, "max_tokens": 16, "guided_json": NSCHEMA}
        prompt = pair.torch.tokenizer.encode("spec parity")
        want = _run(pair.jax, [(prompt, jax_sampling.SamplingParams
                                .from_request(body).__dict__)],
                    jax_sampling.SamplingParams)
        got = _run(pair.torch, [(prompt, sampling.SamplingParams
                                 .from_request(body).__dict__)],
                   sampling.SamplingParams)
        assert got == want
        assert _stats(pair.torch) == _stats(pair.jax)
        assert pair.torch.stats()["spec_verify_bursts_total"] >= 1
    finally:
        pair.stop()


def test_constrained_draft_positions_ascend_over_the_bucket():
    """Every drafter forward, the FSM-constrained steps' ``[B, W0]`` rows
    with one live token among them, carries positions that ascend over
    the whole bucket; the greedy self-drafter under a grammar has every
    draft accepted."""
    eng = EngineCore(EngineConfig(device="cpu", **dict(SPEC_CFG, **DRAFT)))
    seen = []
    forward = eng._draft.forward

    def spy(tokens, positions, slot_mapping, tables, ctx, sl, bits, on):
        seen.append((positions.copy(), sl.copy(), on.copy()))
        return forward(tokens, positions, slot_mapping, tables, ctx, sl,
                       bits, on)

    eng._draft.forward = spy
    eng.start()
    try:
        _run(eng, _reqs(REQS[:3], api.parse_structured),
             sampling.SamplingParams)
    finally:
        eng.stop()
    steps = [(p, sl, on) for p, sl, on in seen
             if p.shape[1] == eng._draft.buckets()[0] and on.any()
             and (sl == 1).all()]
    assert steps, "no FSM-constrained draft step ran"
    for pos, _sl, _on in seen:
        assert (np.diff(pos, axis=1) >= 0).all()
    live = [pos[b] for pos, _sl, on in steps for b in np.flatnonzero(on)]
    assert all(row[0] > 0 and (np.diff(row) == 1).all() for row in live)
    s = eng.stats()
    assert (s["spec_accepted_by_source"]["draft_model"]
            == s["spec_proposed_by_source"]["draft_model"] > 0)
