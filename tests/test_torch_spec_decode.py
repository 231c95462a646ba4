"""Speculative decoding in the torch ``EngineCore``, against the JAX one.

Each scenario of ``tests/test_spec_decode.py`` runs on a JAX engine and on
the port (``device="cpu"``, tiny-llama at float32, the reference's
``SPEC_CFG``), the port holding the JAX engine's target weights and, with
a draft model, the JAX drafter's weights (``models/convert.py``). Both
engines get the same requests in one critical section, so they take the
same steps: the port's token streams must equal the JAX engine's, and so
must its ``spec_*`` counters. The mispredicting drafter is tiny-llama
with weights from another seed in both packages (tiny-mixtral is not
ported).

Also: ``accepted_prefix_len`` and ``apply_fsm_mask`` against the JAX
functions, and the ``tpu:spec_*`` series of the port's HTTP server under
the JAX names."""

import json
import queue
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as jax_sampling
from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.models import build_model as jax_build_model
from production_stack_tpu_torch.engine import sampling
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.models.convert import (
    draft_params_from_numpy,
    params_from_numpy,
)
from production_stack_tpu_torch.structured.tokenfsm import mask_row_bytes

from test_spec_decode import SPEC_CFG as REFERENCE_SPEC_CFG
from test_spec_decode import de_bruijn
from test_torch_engine import cfg_model

torch.set_num_threads(1)

# The reference's configuration with make_engine's other settings, at
# float32 (bf16 greedy streams part at near-ties of random weights).
SPEC_CFG = dict(REFERENCE_SPEC_CFG, model="tiny-llama", min_prefill_bucket=16,
                dtype="float32", speculative_num_tokens=4)
DRAFT = dict(speculative_draft_model="tiny-llama")
CHUNKED = dict(enable_chunked_prefill=True, max_num_batched_tokens=32)
COUNTERS = ("spec_proposed_tokens_total", "spec_accepted_tokens_total",
            "spec_proposed_by_source", "spec_accepted_by_source",
            "spec_draft_forward_steps_total", "spec_disabled_requests_total",
            "spec_verify_bursts_total", "decode_forward_steps_total",
            "generation_tokens_total", "num_preempted_total")


def _greedy(n):
    return dict(max_tokens=n, temperature=0.0, ignore_eos=True)


def _sampled(n, seed, temperature=0.8, **over):
    return dict(dict(max_tokens=n, temperature=temperature, seed=seed,
                     ignore_eos=True), **over)


_ALPHABET = [21, 22, 23, 24]
_ADVERSARIAL = (de_bruijn(_ALPHABET, 3),
                _sampled(32, 7, temperature=1.0,
                         logit_bias={t: 100.0 for t in _ALPHABET}))
_REPETITIVE = [([5, 6, 7, 8] * 6, _greedy(24)),
               ([9, 10, 11] * 8, _greedy(24)),
               ([3, 4] * 10, _greedy(24))]
# Sampled rows whose biases keep them on two tokens, so that prompt
# lookup finds drafts and about half of each is accepted, and a row with
# no repeats (plain bursts while it runs without a draft).
_SAMPLED = [([5, 6] * 10, _sampled(24, 11, logit_bias={5: 100.0,
                                                       6: 100.0})),
            ([7, 8, 9] * 6, _sampled(24, 12, top_k=20,
                                     logit_bias={7: 100.0, 8: 100.0})),
            ([31, 7, 2, 19, 44, 3, 28, 11], _sampled(24, 13, top_p=0.9))]
_TIGHT = [([5, 6, 7, 8] * 2, _greedy(60)),
          ([9, 10, 11, 12] * 12, _greedy(60))]
_CHUNKED_REQS = [([5, 6, 7, 8] * 15, _greedy(16)),
                 ([9, 10, 11] * 4, _greedy(16)),
                 ([3, 4] * 8, _greedy(16))]

# Engine configurations over SPEC_CFG (name -> (overrides, the seed the
# drafter's weights are redrawn from, None for the JAX engine's own)).
# Scenarios of one configuration share a pair of engines, one after the
# other.
TIGHT_CHUNKED = dict(CHUNKED, num_blocks=16)
CONFIGS = {
    "ngram": (dict(speculative_accept_window=6), None),
    "ngram_tight_chunked": (TIGHT_CHUNKED, None),
    "draft": (DRAFT, None),
    "draft_tight_chunked": (dict(DRAFT, **TIGHT_CHUNKED), None),
    "draft_mispredicting": (dict(DRAFT, speculative_accept_window=6,
                                 speculative_draft_probation=3), 1),
}
# scenario -> (configuration, requests, what the run must show beyond
# equal streams and counters).
CASES = {
    "ngram_greedy": ("ngram", _REPETITIVE, "verify"),
    "ngram_sampled": ("ngram", _SAMPLED, "verify"),
    "ngram_adversarial_latch": ("ngram", [_ADVERSARIAL], "latch"),
    "ngram_preempt_resume": ("ngram_tight_chunked", _TIGHT, "preempt"),
    "ngram_chunked_prefill": ("ngram_tight_chunked", _CHUNKED_REQS,
                              "chunked"),
    "draft_identical_greedy": (
        "draft", [([5, 6, 7, 8] * 6, _greedy(24)),
                  ([31, 7, 2, 19, 44, 3, 28, 11], _greedy(24))],
        "all_accepted"),
    "draft_sampled": ("draft", _SAMPLED, "verify"),
    "draft_preempt_resume": ("draft_tight_chunked", _TIGHT, "preempt"),
    "draft_chunked_prefill": ("draft_tight_chunked", _CHUNKED_REQS[:2],
                              "chunked"),
    "draft_mispredicting_latch_probation": (
        "draft_mispredicting", [_ADVERSARIAL], "relatch"),
}


class SpecPair:
    """A JAX engine and a torch engine with the JAX engine's weights (and
    its drafter's, optionally redrawn from ``draft_seed`` in both)."""

    def __init__(self, draft_seed=None, **over):
        kwargs = dict(SPEC_CFG, **over)
        self.jax = JaxEngineCore(JaxEngineConfig(**kwargs),
                                 devices=jax.devices()[:1])
        cfg = EngineConfig(device="cpu", **kwargs)
        draft_params = None
        jdraft = self.jax._draft
        if jdraft is not None:
            if draft_seed is not None:
                init_fn, _ = jax_build_model(jdraft.model_config)
                jdraft.params = init_fn(jdraft.model_config,
                                        jax.random.key(draft_seed))
            draft_params = draft_params_from_numpy(
                jax.tree.map(np.asarray, jdraft.params), cfg, "cpu")
        tree = jax.tree.map(np.asarray, self.jax.params)
        self.torch = EngineCore(
            cfg, params=params_from_numpy(tree, cfg_model(cfg), "cpu"),
            draft_params=draft_params)
        self.jax.start()
        self.torch.start()

    def stop(self):
        self.jax.stop()
        self.torch.stop()


_ids = iter(range(10 ** 9))


def _run(engine, reqs, sampling_cls, timeout=240):
    """Streams (tokens, finish) of ``reqs`` [(prompt, SamplingParams
    kwargs)], all added to ``engine`` in one critical section."""
    queues = []
    with engine._lock:
        for prompt, sp in reqs:
            q: "queue.Queue" = queue.Queue()
            engine.add_request(f"sp{next(_ids)}", list(prompt),
                               sampling_cls(**sp),
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


class _Pairs:
    """The engines of one configuration at a time: asking for another
    stops the open ones."""

    def __init__(self):
        self.name, self.pair = None, None

    def get(self, config: str) -> SpecPair:
        if config != self.name:
            self.close()
            over, draft_seed = CONFIGS[config]
            self.name, self.pair = config, SpecPair(draft_seed=draft_seed,
                                                    **over)
        return self.pair

    def close(self):
        if self.pair is not None:
            self.pair.stop()
        self.name, self.pair = None, None


@pytest.fixture(scope="module")
def pairs():
    holder = _Pairs()
    yield holder
    holder.close()


def _delta(now: dict, before: dict, key: str, source=None):
    if source is not None:
        return now[key][source] - before[key][source]
    return now[key] - before[key]


@pytest.mark.parametrize("case", list(CASES))
def test_spec_streams_and_counters_equal_jax(pairs, case):
    config, reqs, shows = CASES[case]
    pair = pairs.get(config)
    port = pair.torch
    before = port.stats()
    chunks_before = port.prefill_chunks_total
    want = _run(pair.jax, reqs, jax_sampling.SamplingParams)
    got = _run(port, reqs, sampling.SamplingParams)
    js, ts = pair.jax.stats(), port.stats()
    assert got == want
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert _delta(ts, before, "spec_verify_bursts_total") >= 1
    source = "draft_model" if config.startswith("draft") else "ngram"
    other = "ngram" if source == "draft_model" else "draft_model"
    assert _delta(ts, before, "spec_proposed_by_source", source) > 0
    assert ts["spec_proposed_by_source"][other] == 0
    if shows == "preempt":
        assert _delta(ts, before, "num_preempted_total") >= 1
    elif shows == "chunked":
        assert port.prefill_chunks_total - chunks_before >= 2
    elif shows == "latch":
        assert _delta(ts, before, "spec_disabled_requests_total") >= 1
    elif shows == "relatch":
        # Probation lifted the latch and a wrong drafter latched again.
        assert _delta(ts, before, "spec_disabled_requests_total") >= 2
    elif shows == "all_accepted":
        assert (_delta(ts, before, "spec_accepted_by_source", source)
                == _delta(ts, before, "spec_proposed_by_source", source))
        assert _delta(ts, before, "spec_draft_forward_steps_total") > 0
    if source == "draft_model":
        # The drafter's pages went with every finished request.
        assert port._draft.kv_mgr.seqs == {}
        assert port._draft.computed == {}


def test_spec_verify_steps_are_recorded():
    """The step recorder keeps the verify bursts as ``spec_verify``
    records: one forward each, the rows' scheduled tokens."""
    eng = EngineCore(EngineConfig(device="cpu", **SPEC_CFG))
    eng.start()
    try:
        _run(eng, _REPETITIVE[:2], sampling.SamplingParams)
    finally:
        eng.stop()
    kinds = eng.step_recorder.kind_stats()
    assert kinds["spec_verify"]["count"] == eng.spec_verify_bursts_total > 0
    recs = eng.step_recorder.snapshot(limit=1000, kind="spec_verify")
    assert all(r["forwards"] == 1 and 2 <= r["tokens"] <= 2 * 4
               for r in recs)


def test_draft_catch_up_positions_ascend_over_the_bucket():
    """The cached-prefill kernel takes a query tile's key range from the
    tile's last position, so every row the drafter's catch-up sends must
    ascend over the whole bucket, padding columns included (a padding row
    is all zeros)."""
    eng = EngineCore(EngineConfig(device="cpu", **dict(SPEC_CFG, **DRAFT)))
    seen = []
    forward = eng._draft.forward

    def spy(tokens, positions, *rest):
        seen.append(positions.copy())
        return forward(tokens, positions, *rest)

    eng._draft.forward = spy
    eng.start()
    try:
        _run(eng, [([5, 6, 7, 8] * 6, _greedy(12)),
                   ([31, 7, 2, 19, 44], _greedy(12))],
             sampling.SamplingParams)
    finally:
        eng.stop()
    assert len(seen) >= 2 and any(p.shape[1] > 16 for p in seen)
    for pos in seen:
        assert (np.diff(pos, axis=1) >= 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_accepted_prefix_len_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 5))
        draft = [int(x) for x in rng.integers(0, 3, size=n)]
        row = rng.integers(0, 3, size=n + 1)
        assert (sampling.accepted_prefix_len(draft, torch.from_numpy(row))
                == jax_sampling.accepted_prefix_len(draft, row))


@pytest.mark.parametrize("vocab", [8, 13, 512])
def test_apply_fsm_mask_matches_jax(vocab):
    rng = np.random.default_rng(vocab)
    B = 5
    logits = rng.standard_normal((B, vocab)).astype(np.float32)
    bits = rng.integers(0, 256, size=(B, mask_row_bytes(vocab)),
                        dtype=np.uint8)
    on = np.array([True, False, True, True, False])
    want = np.asarray(jax_sampling.apply_fsm_mask(
        jnp.asarray(logits), jnp.asarray(bits), jnp.asarray(on)))
    got = sampling.apply_fsm_mask(torch.from_numpy(logits),
                                  torch.from_numpy(bits),
                                  torch.from_numpy(on)).numpy()
    np.testing.assert_array_equal(got, want)
    # The packed layout is numpy's little bit order.
    allowed = np.unpackbits(bits, axis=1, bitorder="little")[:, :vocab]
    assert np.array_equal(got[0] == sampling.FSM_MASK_NEG, allowed[0] == 0)


def test_spec_metrics_over_http_under_the_jax_names():
    """The port's server with ``--speculative-num-tokens 4``: a repetitive
    completion runs verify bursts, and ``/metrics`` carries the JAX
    server's ``tpu:spec_*`` series (both source labels always present)
    with the engine's counts."""
    httpd, core = build_server([
        "tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
        "0", "--max-model-len", "128", "--max-num-seqs", "2",
        "--block-size", "8", "--num-blocks", "32", "--dtype", "float32",
        "--max-loras", "0", "--speculative-num-tokens", "4",
        "--speculative-ngram-size", "2"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps({
                "prompt": "hello hello hello hello hello", "max_tokens": 16,
                "temperature": 0, "logit_bias": {"104": 100}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            text = resp.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
        thread.join(timeout=10)
    s = core.stats()
    assert core.config.speculative_ngram_size == 2
    assert s["spec_verify_bursts_total"] >= 1
    values = {}
    for line in text.splitlines():
        if line.startswith("tpu:spec_"):
            name, value = line.rsplit(" ", 1)
            values[name] = float(value)
    label = 'model_name="tiny-llama"'
    rate = s["spec_accepted_tokens_total"] / s["spec_proposed_tokens_total"]
    assert values == {
        f'tpu:spec_proposed_tokens_total{{{label},source="ngram"}}':
            s["spec_proposed_by_source"]["ngram"],
        f'tpu:spec_proposed_tokens_total{{{label},source="draft_model"}}':
            0,
        f'tpu:spec_accepted_tokens_total{{{label},source="ngram"}}':
            s["spec_accepted_by_source"]["ngram"],
        f'tpu:spec_accepted_tokens_total{{{label},source="draft_model"}}':
            0,
        f"tpu:spec_acceptance_rate{{{label}}}": round(rate, 6),
        f"tpu:spec_disabled_requests_total{{{label}}}":
            s["spec_disabled_requests_total"],
        f"tpu:spec_verify_bursts_total{{{label}}}":
            s["spec_verify_bursts_total"],
        f"tpu:spec_draft_forward_steps_total{{{label}}}": 0,
    }
    for family in ("tpu:spec_proposed_tokens counter",
                   "tpu:spec_acceptance_rate gauge",
                   "tpu:spec_verify_bursts counter"):
        assert f"# TYPE {family}" in text
