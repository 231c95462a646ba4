"""The port's threefry (``engine/prng.py``) against ``jax.random``: key data,
the 32-bit bits and the float32 uniforms bit for bit, the Gumbel noise to
float32 rounding, ``categorical`` draws and the engine's ``sample_tokens``
over mixed greedy, top-k and top-p rows draw for draw. Also writes the
golden values ``chip_smoke.py`` holds the card's draws to, and checks
that they are the ones in the script."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as jsamp
from production_stack_tpu_torch.engine import prng
from production_stack_tpu_torch.engine import sampling as tsamp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = float(np.finfo(np.float32).tiny)
# Seeds past int32, negative and at the uint32 edge: JAX takes them mod
# 2^32 (64-bit types off), and so must the port.
SEEDS = np.asarray([0, 5, 7, 2**31 - 1, 2**31 + 9, 2**32 - 1, 2**33 + 5,
                    -1, -2**35, 123456789], np.int64)


def _jax_keys(seed, step, seeds):
    return np.asarray(jsamp.make_rng_keys(seed, step, seeds)).astype(np.int64)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (17, 1000),
                                       (2**31 + 1, 2**32 - 7), (-3, 1)])
def test_make_rng_keys_bit_equal(seed, step):
    got = tsamp.make_rng_keys(seed, step, torch.from_numpy(SEEDS))
    assert np.array_equal(got.numpy(), _jax_keys(seed, step, SEEDS))


def test_key_and_fold_in_bit_equal():
    for seed in SEEDS.tolist():
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert prng.key(seed).tolist() == want.astype(np.int64).tolist()
    base = jax.random.key(11)
    for data in (0, 1, 2**31 - 1, 2**32 - 1, 77):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(base, data)))
        got = prng.fold_in(prng.key(11), data)
        assert got.tolist() == want.astype(np.int64).tolist()


def test_random_bits_and_uniform_bit_equal():
    keys = _jax_keys(0, 3, SEEDS)
    jkeys = jnp.asarray(keys.astype(np.uint32))

    def jbits(k):
        return jax.random.bits(jax.random.wrap_key_data(k), (64,))

    def juniform(k):
        return jax.random.uniform(jax.random.wrap_key_data(k), (64,),
                                  minval=TINY)

    tkeys = torch.from_numpy(keys)
    want_bits = np.asarray(jax.vmap(jbits)(jkeys)).astype(np.int64)
    assert np.array_equal(prng.random_bits(tkeys, 64).numpy(), want_bits)
    want_u = np.asarray(jax.vmap(juniform)(jkeys))
    got_u = prng.uniform(tkeys, 64, minval=TINY).numpy()
    assert got_u.dtype == np.float32
    assert np.array_equal(got_u.view(np.int32), want_u.view(np.int32))


def test_gumbel_matches_to_float32_rounding():
    keys = _jax_keys(9, 1, SEEDS)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        jax.random.wrap_key_data(k), (64,)))(jnp.asarray(keys, jnp.uint32)))
    got = prng.gumbel(torch.from_numpy(keys), 64).numpy()
    # Same uniforms bit for bit; the two logs may round differently.
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=4e-7)


def test_categorical_draws_equal_over_many_keys_and_rows():
    n, V = 2048, 64
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(n, V)).astype(np.float32) * 2.0
    logits[rng.random((n, V)) < 0.3] = -np.inf  # masked candidates
    logits[:, 0] = np.maximum(logits[:, 0], 0.0)  # every row keeps one
    keys = _jax_keys(3, 5, np.arange(n, dtype=np.int64) * 7919)
    want = np.asarray(jax.vmap(lambda k, row: jax.random.categorical(
        jax.random.wrap_key_data(k), row))(
        jnp.asarray(keys, jnp.uint32), jnp.asarray(logits)))
    got = prng.categorical(torch.from_numpy(keys), torch.from_numpy(logits))
    assert got.tolist() == want.tolist()
    assert len(set(want.tolist())) > 32  # the keys really drive the draws


def test_sample_tokens_mixed_rows_equal_jax():
    """Greedy, temperature-only, top-k, top-p and top-k + top-p rows, each
    over many keys: the port's sample_tokens gives JAX's token ids."""
    B, V, K = 320, 257, 64
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3.0
    kinds = np.arange(B) % 5
    temp = np.where(kinds == 0, 0.0, 0.7 + 0.1 * (np.arange(B) % 4))
    top_k = np.where(np.isin(kinds, (2, 4)), 1 + np.arange(B) % 20, 0)
    top_p = np.where(np.isin(kinds, (3, 4)), 0.5 + 0.01 * (np.arange(B) % 45),
                     1.0)
    keys = _jax_keys(0, 12, np.arange(B, dtype=np.int64) + 1000)
    want = np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys, jnp.uint32),
        jnp.asarray(temp, jnp.float32), jnp.asarray(top_k, jnp.int32),
        jnp.asarray(top_p, jnp.float32), max_top_k=K))
    got = tsamp.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(keys),
        torch.from_numpy(temp.astype(np.float32)), torch.from_numpy(top_k),
        torch.from_numpy(top_p.astype(np.float32)), max_top_k=K)
    assert got.tolist() == want.tolist()


# -- the golden values of chip_smoke.py's threefry check --------------------

def golden():
    """What chip_smoke.py holds the card's threefry to, computed by JAX:
    key data of make_rng_keys(0, 3, GOLDEN_SEEDS), the first 8 bits of
    each key, and categorical draws of each key over the rows of
    golden_logits (float32, from numpy seed 0)."""
    smoke = _chip_smoke()
    seeds = np.asarray(smoke.GOLDEN_SEEDS, np.int64)
    keys = _jax_keys(0, 3, seeds)
    jkeys = jnp.asarray(keys, jnp.uint32)
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(
        jax.random.wrap_key_data(k), (8,)))(jkeys)).astype(np.int64)
    logits = smoke.golden_logits(len(seeds))
    draws = np.asarray(jax.vmap(lambda k, row: jax.random.categorical(
        jax.random.wrap_key_data(k), row))(jkeys, jnp.asarray(logits)))
    return {"keys": keys.tolist(), "bits": bits.tolist(),
            "draws": draws.tolist()}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_golden_values_are_jax_and_the_port_gives_them():
    smoke = _chip_smoke()
    want = golden()
    assert smoke.GOLDEN == want, (
        "chip_smoke.GOLDEN is stale; it should read " + repr(want))
    # The port's own draws on the CPU, as the script checks them on the
    # card.
    assert smoke.threefry_check("cpu") == want
