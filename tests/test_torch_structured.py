"""Structured output in the torch port, against the JAX package.

- The port's own copies of the compiler (``structured/``): on every case
  of the corpus and on both request surfaces (the ``guided_*`` fields and
  ``response_format``), the parsed spec, the lowered regex and the
  byte-level DFA (state count, transitions, accepting set) equal JAX's;
  a constraint that does not compile raises the same ``StructuredError``.
- ``TokenFSM`` mask rows of the port byte-equal to JAX's on the states a
  member of each case's language visits, at tiny-llama's vocabulary.
- The engine: tiny-llama at float32 with the JAX engine's weights
  (``tests/test_torch_engine.py``'s ``Pair``), every scenario's requests
  handed to both engines in one critical section. Token streams and the
  ``structured_*`` counters equal the JAX engine's, for ``guided_json``,
  ``guided_regex`` and ``response_format`` (``json_schema``,
  ``json_object``), greedy and seeded sampled, through a storm-batched
  prefill with a padding row, a prefix hit, chunked step plans,
  preemption, int8 pages and a request that ends by length
  mid-structure."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.engine.tokenizer import (
    build_tokenizer as jax_build_tokenizer,
)
from production_stack_tpu.structured import api as jax_api
from production_stack_tpu.structured import corpus as jax_corpus
from production_stack_tpu.structured import regex_dfa as jax_regex_dfa
from production_stack_tpu.structured import schema as jax_schema
from production_stack_tpu.structured import tokenfsm as jax_tokenfsm
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.tokenizer import build_tokenizer
from production_stack_tpu_torch.structured import api, corpus, regex_dfa
from production_stack_tpu_torch.structured import schema, tokenfsm

from test_torch_engine import Pair
from test_torch_engine_step import _run

torch.set_num_threads(1)

CASES = {c["name"]: c for c in corpus.load_corpus()}
COUNTERS = ("structured_requests_total", "structured_mask_states_total",
            "structured_violations_total", "structured_cache_entries",
            "generation_tokens_total", "decode_forward_steps_total",
            "num_preempted_total")


def test_corpus_copy_equals_jax():
    with open(jax_corpus.CORPUS_PATH, "rb") as f:
        want = f.read()
    with open(corpus.CORPUS_PATH, "rb") as f:
        assert f.read() == want
    assert len(CASES) == 30


def _spec(s):
    return None if s is None else (s.kind, s.spec)


@pytest.mark.parametrize("surface", ["guided", "response_format"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_compiler_copy_equals_jax(name, surface):
    case = CASES[name]
    body = corpus.case_request_fields(case, surface)
    assert body == jax_corpus.case_request_fields(case, surface)
    got, want = api.parse_structured(body), jax_api.parse_structured(body)
    assert _spec(got) == _spec(want) == _spec(corpus.case_spec(case))
    assert api.spec_regex(got) == jax_api.spec_regex(want)
    dfa = regex_dfa.compile_regex(api.spec_regex(got))
    jdfa = jax_regex_dfa.compile_regex(jax_api.spec_regex(want))
    assert dataclasses.asdict(dfa) == dataclasses.asdict(jdfa)
    for text in case["positive"]:
        assert dfa.fullmatch(text)
        if case["kind"] == "json_schema":
            assert schema.validate_instance(case["spec"], json.loads(text))
    for text in case["negative"]:
        assert not dfa.fullmatch(text)


_BAD = [
    ("regex", r"(a)\1"), ("regex", r"(?=a)b"), ("regex", r"a{2,1}"),
    ("regex", r"*a"), ("regex", r"[z-a]"),
    ("regex", r"a{%d}" % (regex_dfa.MAX_REPEAT + 1)), ("regex", r"(a"),
    ("schema", {"allOf": [{"type": "string"}]}),
    ("schema", {"not": {"type": "string"}}), ("schema", {"$ref": "#/d/x"}),
    ("schema", {"type": "object", "patternProperties": {".*": {}}}),
    ("schema", {"type": "object",
                "properties": {"opt": {"type": "boolean"},
                               "req": {"type": "integer"}},
                "required": ["req"]}),
    ("body", {"guided_regex": ""}), ("body", {"guided_json": "not json"}),
    ("body", {"guided_json": [1]}),
    ("body", {"response_format": {"type": "yaml"}}),
    ("body", {"response_format": {"type": "json_schema"}}),
    ("body", {"guided_regex": "[ab]+", "guided_json": {"type": "null"}}),
]


@pytest.mark.parametrize("i", range(len(_BAD)))
def test_uncompilable_raise_the_jax_error(i):
    kind, arg = _BAD[i]
    calls = {"regex": (regex_dfa.compile_regex, jax_regex_dfa.compile_regex),
             "schema": (schema.schema_to_regex, jax_schema.schema_to_regex),
             "body": (api.parse_structured, jax_api.parse_structured)}[kind]
    with pytest.raises(jax_regex_dfa.StructuredError) as want:
        calls[1](arg)
    with pytest.raises(regex_dfa.StructuredError) as got:
        calls[0](arg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mask_rows_byte_equal_to_jax(name):
    """Every state a member of the case's language walks through (its
    first positive example, byte by byte, and the end state), at
    tiny-llama's 512-token vocabulary with the engines' own tokenizers."""
    case = CASES[name]
    vocab = 512
    tok, jtok = build_tokenizer("tiny-llama", vocab), jax_build_tokenizer(
        "tiny-llama", vocab)
    table = tokenfsm.token_byte_table(tok, vocab)
    assert table == jax_tokenfsm.token_byte_table(jtok, vocab)
    spec = corpus.case_spec(case)
    fsm = tokenfsm.TokenFSM(api.compile_char_dfa(spec), table,
                            tok.eos_token_id, vocab)
    jfsm = jax_tokenfsm.TokenFSM(jax_api.compile_char_dfa(
        jax_corpus.case_spec(case)), table, jtok.eos_token_id, vocab)
    state = fsm.start
    for byte in case["positive"][0].encode("utf-8"):
        row, jrow = fsm.mask_row(state), jfsm.mask_row(state)
        assert row.dtype == jrow.dtype == np.uint8
        assert row.tobytes() == jrow.tobytes()
        assert len(row) == tokenfsm.mask_row_bytes(vocab)
        assert (row[byte // 8] >> (byte % 8)) & 1  # the next byte is allowed
        nxt = fsm.advance(state, byte)
        assert nxt == jfsm.advance(state, byte) >= 0
        state = nxt
    assert fsm.is_accepting(state)
    assert fsm.mask_row(state).tobytes() == jfsm.mask_row(state).tobytes()
    assert fsm.states_materialized == jfsm.states_materialized


def _body(structured, **kw):
    """SamplingParams kwargs with a request body's structured spec for
    each package."""
    return (dict(kw, structured=api.parse_structured(structured)),
            dict(kw, structured=jax_api.parse_structured(structured)))


BOOL = {"type": "object", "properties": {"ok": {"type": "boolean"}},
        "required": ["ok"]}
ENUM = {"enum": ["red", "green", "blue"]}
_RF_SCHEMA = {"response_format": {"type": "json_schema", "json_schema": {
    "name": "out", "schema": CASES["schema-object-one-required"]["spec"]}}}
# One request of every kind: (structured body, SamplingParams kwargs).
KINDS = [
    ({"guided_regex": "[ab]{3}"}, dict(max_tokens=16, temperature=0.0)),
    ({"guided_json": BOOL}, dict(max_tokens=32, temperature=0.0)),
    (_RF_SCHEMA, dict(max_tokens=24, temperature=0.8, seed=11)),
    ({"response_format": {"type": "json_object"}},
     dict(max_tokens=12, temperature=0.8, seed=3)),
    ({"guided_json": ENUM}, dict(max_tokens=16, temperature=0.8, seed=5,
                                 top_k=20)),
    # Ends by length mid-structure: one violation.
    ({"guided_regex": "[ab]{6}"}, dict(max_tokens=2, temperature=0.0)),
    ({}, dict(max_tokens=10, temperature=0.0, ignore_eos=True)),
]


def _both(pair, prompts, kinds):
    want = _run(pair.jax, prompts,
                [JaxSamplingParams(**_body(b, **kw)[1]) for b, kw in kinds])
    got = _run(pair.torch, prompts,
               [SamplingParams(**_body(b, **kw)[0]) for b, kw in kinds])
    return want, got


def _counters(engine):
    s = engine.stats()
    return {k: s[k] for k in COUNTERS}


def _check_grammar(pair, got, kinds):
    """Streams ending with "stop" are members of their language."""
    eos = pair.torch.tokenizer.eos_token_id
    for (tokens, finish), (body, _) in zip(got, kinds):
        spec = api.parse_structured(body)
        if spec is None or finish != "stop":
            continue
        text = pair.torch.tokenizer.decode([t for t in tokens if t != eos])
        assert api.compile_char_dfa(spec).fullmatch(text), (body, text)


def test_structured_streams_equal_jax_with_storm_and_prefix_hit():
    """Seven requests of every kind arrive together: 20-token prompts over
    16-token chunks make a storm (batched prefills of 4 rows, the last
    group with a padding row), then a structured follow-up hits the
    prefix cache."""
    pair = Pair(prefill_chunk_size=16, max_num_seqs=8)
    try:
        prompts = [list(range(300 + 10 * i, 320 + 10 * i))
                   for i in range(len(KINDS))]
        want, got = _both(pair, prompts, KINDS)
        assert got == want
        _check_grammar(pair, got, KINDS)
        assert pair.torch.prefill_group_count > 0
        assert (pair.torch.prefill_group_rows % 4) != 0  # a padding row
        c = _counters(pair.torch)
        assert c == _counters(pair.jax)
        assert c["structured_requests_total"] == 6
        assert c["structured_violations_total"] >= 1
        cached = pair.torch.cached_tokens_total
        want, got = _both(pair, [prompts[0] + [7, 8, 9]], [KINDS[1]])
        assert got == want
        assert pair.torch.cached_tokens_total - cached >= 16
        assert _counters(pair.torch) == _counters(pair.jax)
    finally:
        pair.stop()


def test_structured_streams_equal_jax_with_chunked_plans_and_preemption():
    """Chunked step plans (32-token budget) over 40-token prompts and a
    14-block pool: structured rows are prefilled in chunks, preempted and
    re-prefilled with their automaton where their outputs left it."""
    pair = Pair(enable_chunked_prefill=True, max_num_batched_tokens=32,
                num_blocks=14)
    try:
        kinds = [KINDS[1], KINDS[2], KINDS[3], KINDS[6]]
        prompts = [list(range(100 + 40 * i, 140 + 40 * i)) for i in range(4)]
        want, got = _both(pair, prompts, kinds)
        assert got == want
        _check_grammar(pair, got, kinds)
        assert pair.torch.prefill_chunks_total >= 8
        assert pair.torch.scheduler.num_preempted_total > 0
        assert _counters(pair.torch) == _counters(pair.jax)
    finally:
        pair.stop()


def test_structured_streams_equal_jax_on_int8_pages():
    pair = Pair(kv_cache_dtype="int8")
    try:
        prompts = [list(range(50 + 7 * i, 62 + 7 * i)) for i in range(4)]
        kinds = [KINDS[0], KINDS[4], KINDS[2], KINDS[5]]
        want, got = _both(pair, prompts, kinds)
        assert got == want
        _check_grammar(pair, got, kinds)
        assert _counters(pair.torch) == _counters(pair.jax)
    finally:
        pair.stop()
