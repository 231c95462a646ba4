"""The torch OPT forward against the JAX one: tiny-opt with the same
weights (the JAX init carried over by ``params_from_numpy``, biases and
norms made non-trivial) and the same token ids. Logits and the written
KV pages agree in prefill, prefill_cached and decode modes at 1e-4 in
float32 and at 6e-2 in bfloat16 (the bars of tests/test_models.py).
Also: positions past the table clamp as the JAX gather clamps them, the
LayerNorm takes the population variance, and the converter carries the
OPT tree across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import opt as jopt
from production_stack_tpu_torch.models import build_model, convert
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.models import opt as topt

torch.set_num_threads(1)

TOLS = {"float32": 1e-4, "bfloat16": 6e-2}
BS, NB = 4, 16


def _tree(dtype):
    jcfg = jax_model_config("tiny-opt").replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, jopt.init_params(jcfg, jax.random.key(0)))
    # Non-zero biases and non-unit norms, so every leaf is exercised.
    rng = np.random.default_rng(5)
    for name, leaf in tree["layers"].items():
        if name.endswith("_b") or name.startswith("ln"):
            base = 1.0 if name.endswith("_w") else 0.0
            tree["layers"][name] = (
                base + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
    return jcfg, tree


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dtype = request.param
    jcfg, tree = _tree(dtype)
    tcfg = get_model_config("tiny-opt").replace(dtype=dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _slots(tables, positions, take):
    slots = np.full(positions.shape, -1, np.int64)
    for b, n in enumerate(take):
        pos = positions[b, :n]
        slots[b, :n] = tables[b, pos // BS] * BS + pos % BS
    return slots


def _as_np(x):
    x = x.float() if isinstance(x, torch.Tensor) else x
    return np.asarray(x, np.float32)


def _step(models, state, *, tokens, positions, slots, tables, context,
          seq_lens, mode, last_token=None):
    jcfg, tcfg, jparams, tparams = models
    tol = TOLS[tcfg.dtype]
    jlogits, jkv = jopt.apply(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        state["jax_kv"], jnp.asarray(slots), jnp.asarray(tables),
        jnp.asarray(context), jnp.asarray(seq_lens), mode=mode,
        last_token=None if last_token is None else jnp.asarray(last_token))
    t = torch.from_numpy
    tlogits, tkv = topt.apply(
        tparams, tcfg, t(tokens), t(positions), state["torch_kv"], t(slots),
        t(tables), t(context), t(seq_lens), mode=mode,
        last_token=None if last_token is None else t(last_token))
    assert tkv[0] is state["torch_kv"][0]  # pages updated in place
    state["jax_kv"] = jkv
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    for got, want in zip(tkv, jkv):
        np.testing.assert_allclose(_as_np(got), _as_np(want), rtol=tol,
                                   atol=tol)
    return tlogits


def test_three_modes_match_jax(models):
    jcfg, tcfg = models[0], models[1]
    shape = (jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
    state = {"jax_kv": (jnp.zeros(shape, jcfg.jnp_dtype),
                        jnp.zeros(shape, jcfg.jnp_dtype)),
             "torch_kv": (torch.zeros(shape, dtype=tcfg.torch_dtype),
                          torch.zeros(shape, dtype=tcfg.torch_dtype))}
    rng = np.random.default_rng(1)
    tables = np.stack([np.arange(8), np.arange(8, 16)]).astype(np.int32)

    # Prefill: a 16-token bucket, row 1 padded after 11 tokens.
    T = 16
    take = np.asarray([16, 11], np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, T)).astype(np.int32)
    logits = _step(models, state, tokens=tokens, positions=positions,
                   slots=_slots(tables, positions, take), tables=tables,
                   context=take, seq_lens=take, mode="prefill")
    assert logits.shape == (2, T, jcfg.vocab_size)

    # Cached prefill: an 8-token chunk over each row's prefix, sliced to
    # each row's last real token.
    T2 = 8
    take2 = np.asarray([8, 5], np.int32)
    positions2 = (take[:, None] + np.arange(T2)[None, :]).astype(np.int32)
    tokens2 = rng.integers(0, jcfg.vocab_size, size=(2, T2)).astype(np.int32)
    logits2 = _step(models, state, tokens=tokens2, positions=positions2,
                    slots=_slots(tables, positions2, take2), tables=tables,
                    context=take + take2, seq_lens=take2,
                    mode="prefill_cached", last_token=take2 - 1)
    assert logits2.shape == (2, 1, jcfg.vocab_size)

    # Decode: one token a row over the pages (the context includes it).
    pos3 = (take + take2)[:, None].astype(np.int32)
    tokens3 = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    _step(models, state, tokens=tokens3, positions=pos3,
          slots=_slots(tables, pos3, [1, 1]), tables=tables,
          context=(pos3[:, 0] + 1).astype(np.int32),
          seq_lens=np.ones((2,), np.int32), mode="decode")


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_positions_past_the_table_clamp_as_jax(models, mode):
    """Padding columns filled with ascending positions run past
    ``max_position + POS_OFFSET``: the JAX gather clamps them to the last
    row, and so does the port (torch indexing would raise)."""
    jcfg, tcfg, jparams, tparams = models
    tol = TOLS[tcfg.dtype]
    top = jcfg.max_position + jopt.POS_OFFSET
    T = 1 if mode == "decode" else 6
    positions = np.asarray([np.arange(top - 3, top - 3 + T),
                            np.arange(top + 40, top + 40 + T)], np.int32)
    tokens = np.asarray([[5] * T, [7] * T], np.int32)
    # Ids past the vocabulary read its last row too.
    tokens[1, 0] = jcfg.vocab_size + 3
    shape = (jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.head_dim)
    slots = np.full((2, T), -1, np.int64)
    tables = np.zeros((2, 2), np.int32)
    ones = np.ones((2,), np.int32)
    jlogits, _ = jopt.apply(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        (jnp.zeros(shape, jcfg.jnp_dtype), jnp.zeros(shape, jcfg.jnp_dtype)),
        jnp.asarray(slots), jnp.asarray(tables), jnp.asarray(ones),
        jnp.asarray(ones * T), mode="prefill")
    t = torch.from_numpy
    tlogits, _ = topt.apply(
        tparams, tcfg, t(tokens), t(positions),
        (torch.zeros(shape, dtype=tcfg.torch_dtype),
         torch.zeros(shape, dtype=tcfg.torch_dtype)),
        t(slots), t(tables), t(ones), t(ones * T), mode="prefill")
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)


def test_layer_norm_takes_the_population_variance():
    rng = np.random.default_rng(2)
    x = (3.0 + rng.normal(size=(3, 4, 16))).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jopt.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)))
    got = topt.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The unbiased estimator would be off by far more than that bar.
    x_t = torch.from_numpy(x)
    mu = x_t.mean(-1, keepdim=True)
    unbiased = (x_t - mu) * torch.rsqrt(x_t.var(-1, keepdim=True) + 1e-5)
    assert (unbiased * torch.from_numpy(w) + torch.from_numpy(b)
            - torch.from_numpy(want)).abs().max() > 1e-3


def test_params_from_numpy_carries_the_opt_tree():
    jcfg, tree = _tree("float32")
    tcfg = get_model_config("tiny-opt").replace(dtype="float32")
    params = convert.params_from_numpy(tree, tcfg, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    with pytest.raises(ValueError, match="Unknown arch"):
        convert.params_from_numpy(tree, tcfg.replace(arch="gpt2"), "cpu")


def test_init_params_shapes_match_jax():
    jcfg = jax_model_config("tiny-opt")
    tcfg = get_model_config("tiny-opt")
    jshapes = jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)),
        jax.eval_shape(lambda: jopt.init_params(jcfg, jax.random.key(0))))
    init_fn, apply_fn = build_model(tcfg)
    assert init_fn is topt.init_params and apply_fn is topt.apply
    tparams = init_fn(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), str(node.dtype).replace("torch.", ""))

    assert shapes(tparams) == jshapes
    fc1 = tparams["layers"]["fc1"].float()
    assert abs(fc1.std().item() - tcfg.hidden_size ** -0.5) < 0.01
    assert torch.all(tparams["layers"]["ln1_w"] == 1)
    assert torch.all(tparams["layers"]["wq_b"] == 0)
