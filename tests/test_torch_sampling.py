"""Sampling of the torch port against the JAX package: greedy ids, the
logit shaping of the serving programs, logprobs and the top-k/top-p
keep-set. The keyed draws themselves are compared draw for draw in
tests/test_torch_prng.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as jsamp
from production_stack_tpu_torch.engine import sampling as tsamp

torch.set_num_threads(1)

B, V, K = 4, 97, 16


def _logits(seed=0):
    return np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32)


def test_greedy_ids_match_jax():
    logits = _logits()
    temp = np.zeros((B,), np.float32)
    keys = jax.vmap(lambda i: jax.random.key_data(jax.random.key(i)))(
        jnp.arange(B))
    want = jsamp.sample_tokens(
        jnp.asarray(logits), keys, jnp.asarray(temp),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32), max_top_k=K)
    got = tsamp.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(np.asarray(keys)),
        torch.from_numpy(temp), torch.zeros((B,), dtype=torch.long),
        torch.ones((B,)), max_top_k=K)
    assert got.tolist() == np.asarray(want).tolist()


def _jax_shaped(logits, counts, pres, freq, bias_ids, bias_vals, suppress,
                stop_ids, stop_valid, eos_id):
    """The decode program's logit shaping as JAX evaluates it
    (production_stack_tpu/engine/core.py:959-978)."""
    raw = jnp.asarray(logits)
    Bn = raw.shape[0]
    counts = jnp.asarray(counts)
    penalized = (raw - jnp.asarray(freq)[:, None] * counts
                 - jnp.asarray(pres)[:, None] * (counts > 0))
    penalized = penalized.at[jnp.arange(Bn)[:, None],
                             jnp.asarray(bias_ids)].add(jnp.asarray(bias_vals))
    suppress = jnp.asarray(suppress)
    penalized = jnp.where(
        suppress[:, None] & (jnp.arange(penalized.shape[1])[None, :]
                             == eos_id), -jnp.inf, penalized)
    return penalized.at[jnp.arange(Bn)[:, None], jnp.asarray(stop_ids)].add(
        -1e30 * jnp.asarray(stop_valid)
        * suppress.astype(jnp.float32)[:, None])


def test_shaped_logits_match_jax():
    rng = np.random.default_rng(1)
    logits = _logits(1)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    pres = np.asarray([0.0, 0.5, 1.0, 0.0], np.float32)
    freq = np.asarray([0.0, 0.25, 0.0, 2.0], np.float32)
    bias_ids = np.zeros((B, tsamp.MAX_LOGIT_BIAS), np.int64)
    bias_vals = np.zeros((B, tsamp.MAX_LOGIT_BIAS), np.float32)
    bias_ids[1, :3], bias_vals[1, :3] = [5, 9, 96], [3.0, -2.0, 100.0]
    stop_ids = np.zeros((B, tsamp.MAX_STOP_IDS), np.int64)
    stop_valid = np.zeros((B, tsamp.MAX_STOP_IDS), np.float32)
    stop_ids[2, :2], stop_valid[2, :2] = [7, 11], 1.0
    stop_ids[3, :1], stop_valid[3, :1] = [7], 1.0
    suppress = np.asarray([False, True, True, False])
    eos_id = 4
    want = _jax_shaped(logits, counts, pres, freq, bias_ids, bias_vals,
                       suppress, stop_ids, stop_valid, eos_id)
    t = torch.from_numpy
    got = tsamp.shape_logits(
        t(logits), bias_ids=t(bias_ids), bias_vals=t(bias_vals),
        suppress=t(suppress), stop_ids=t(stop_ids), stop_valid=t(stop_valid),
        eos_id=eos_id, counts=t(counts), presence_penalty=t(pres),
        frequency_penalty=t(freq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # The masks really bit: EOS and stop ids of suppressed rows.
    assert got[1, eos_id] == -np.inf and got[2, 7] < -1e29
    assert got[3, 7] == logits[3, 7] - 2.0 * counts[3, 7]


def test_logprobs_match_jax():
    logits = _logits(2)
    sampled = np.asarray([3, 0, 96, 50])
    want = jsamp.logprob_outputs(jnp.asarray(logits), jnp.asarray(sampled))
    got = tsamp.logprob_outputs(torch.from_numpy(logits),
                                torch.from_numpy(sampled))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.5), (5, 0.7),
                                         (1, 1.0)])
def test_keep_set_matches_jax_draws(top_k, top_p):
    """Every id JAX samples lies in the port's keep set, and over many
    draws JAX samples every id of it (the kept candidates are made
    near-equally likely so each one shows up)."""
    rng = np.random.default_rng(3)
    row = rng.normal(size=(V,)).astype(np.float32) * 0.05
    row[rng.permutation(V)[:8]] += np.linspace(3.0, 2.6, 8)
    n = 512
    logits = np.tile(row, (n, 1))
    keys = jax.vmap(lambda i: jax.random.key_data(jax.random.key(i)))(
        jnp.arange(n))
    drawn = set(np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits), keys, jnp.full((n,), 1.0, jnp.float32),
        jnp.full((n,), top_k, jnp.int32), jnp.full((n,), top_p, jnp.float32),
        max_top_k=K)).tolist())
    top_idx, masked = tsamp.keep_candidates(
        torch.from_numpy(row[None]), torch.ones((1,)),
        torch.tensor([top_k]), torch.tensor([top_p]), max_top_k=K)
    kept = set(top_idx[0][torch.isfinite(masked[0])].tolist())
    assert drawn == kept


def test_seeded_draws_repeat_and_stay_in_the_keep_set():
    logits = torch.from_numpy(_logits(4))
    temp = torch.full((B,), 0.8)
    top_k = torch.tensor([0, 2, 5, 0])
    top_p = torch.tensor([0.9, 1.0, 1.0, 0.3])
    seeds = torch.tensor([11, 12, 13, 14])
    a = tsamp.sample_tokens(logits, tsamp.make_rng_keys(0, 5, seeds), temp,
                            top_k, top_p, max_top_k=K)
    b = tsamp.sample_tokens(logits, tsamp.make_rng_keys(0, 5, seeds), temp,
                            top_k, top_p, max_top_k=K)
    assert torch.equal(a, b)
    top_idx, masked = tsamp.keep_candidates(logits, temp, top_k, top_p, K)
    for i in range(B):
        assert a[i].item() in top_idx[i][torch.isfinite(masked[i])].tolist()
    draws = {tuple(tsamp.sample_tokens(
        logits, tsamp.make_rng_keys(0, 5, seeds + 100 * j), temp, top_k,
        top_p, max_top_k=K).tolist())
        for j in range(20)}
    assert len(draws) > 1  # the seed really drives the draw
