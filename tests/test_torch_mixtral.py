"""The torch Mixtral forward against the JAX one: tiny-mixtral with the
same weights (the JAX init carried over by ``params_from_numpy``) and the
same token ids. The dense all-expert MLP agrees with JAX ``moe_mlp`` at
1e-5 in float32, rows with tied router logits included (the top k takes
the lower expert index, as ``jax.lax.top_k`` does); logits and written
KV pages agree in prefill, prefill_cached and decode modes at 1e-4 in
float32 and at 6e-2 in bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import mixtral as jmix
from production_stack_tpu_torch.models import build_model, convert
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.models import mixtral as tmix

torch.set_num_threads(1)

TOLS = {"float32": 1e-4, "bfloat16": 6e-2}
BS, NB = 4, 16


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dtype = request.param
    jcfg = jax_model_config("tiny-mixtral").replace(dtype=dtype)
    tcfg = get_model_config("tiny-mixtral").replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, jmix.init_params(jcfg, jax.random.key(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


def test_moe_mlp_matches_jax_with_forced_ties():
    jcfg = jax_model_config("tiny-mixtral").replace(dtype="float32")
    tcfg = get_model_config("tiny-mixtral").replace(dtype="float32")
    E, Hd = jcfg.num_experts, jcfg.hidden_size
    tree = jax.tree.map(np.asarray, jmix.init_params(jcfg, jax.random.key(3)))
    p = {k: np.array(v) for k, v in _layer0(tree).items()}
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 5, Hd)).astype(np.float32)
    # Rows 0 and 1 of the first sequence read one router row each: a tie
    # for the second place between experts 2 and 3, and a four-way tie.
    router = p["router"]
    router[0] = [0.1, 0.5, 0.3, 0.3]
    router[1] = [0.2, 0.2, 0.2, 0.2]
    h[0, 0] = np.eye(Hd, dtype=np.float32)[0]
    h[0, 1] = np.eye(Hd, dtype=np.float32)[1]
    want = np.asarray(jmix.moe_mlp(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tmix.moe_mlp(tcfg, tp, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    logits = torch.from_numpy(h[0, :2] @ router)
    _, idx = tmix.top_k_lower_index(logits, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    assert idx.tolist() == [[1, 2], [0, 1]] == np.asarray(jidx).tolist()


def test_top_k_breaks_every_tie_toward_the_lower_index():
    rng = np.random.default_rng(4)
    # Logits drawn from a few values: ties at every rank.
    x = rng.integers(0, 3, size=(64, 8)).astype(np.float32)
    vals, idx = tmix.top_k_lower_index(torch.from_numpy(x), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


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
    jlogits, jkv = jmix.apply(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        state["jax_kv"], jnp.asarray(slots), jnp.asarray(tables),
        jnp.asarray(context), jnp.asarray(seq_lens), mode=mode,
        last_token=None if last_token is None else jnp.asarray(last_token))
    t = torch.from_numpy
    tlogits, tkv = tmix.apply(
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

    T = 16
    take = np.asarray([16, 11], np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, T)).astype(np.int32)
    logits = _step(models, state, tokens=tokens, positions=positions,
                   slots=_slots(tables, positions, take), tables=tables,
                   context=take, seq_lens=take, mode="prefill")
    assert logits.shape == (2, T, jcfg.vocab_size)

    T2 = 8
    take2 = np.asarray([8, 5], np.int32)
    positions2 = (take[:, None] + np.arange(T2)[None, :]).astype(np.int32)
    tokens2 = rng.integers(0, jcfg.vocab_size, size=(2, T2)).astype(np.int32)
    logits2 = _step(models, state, tokens=tokens2, positions=positions2,
                    slots=_slots(tables, positions2, take2), tables=tables,
                    context=take + take2, seq_lens=take2,
                    mode="prefill_cached", last_token=take2 - 1)
    assert logits2.shape == (2, 1, jcfg.vocab_size)

    pos3 = (take + take2)[:, None].astype(np.int32)
    tokens3 = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    _step(models, state, tokens=tokens3, positions=pos3,
          slots=_slots(tables, pos3, [1, 1]), tables=tables,
          context=(pos3[:, 0] + 1).astype(np.int32),
          seq_lens=np.ones((2,), np.int32), mode="decode")


def test_init_params_shapes_match_jax():
    jcfg = jax_model_config("tiny-mixtral")
    tcfg = get_model_config("tiny-mixtral")
    jshapes = jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)),
        jax.eval_shape(lambda: jmix.init_params(jcfg, jax.random.key(0))))
    init_fn, apply_fn = build_model(tcfg)
    assert init_fn is tmix.init_params and apply_fn is tmix.apply
    tparams = init_fn(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), str(node.dtype).replace("torch.", ""))

    assert shapes(tparams) == jshapes
    # Drawn a layer at a time: each layer's slice has its own values and
    # the fan-in scale.
    w_gate = tparams["layers"]["w_gate"].float()
    assert not torch.equal(w_gate[0], w_gate[1])
    assert abs(w_gate.std().item() - tcfg.hidden_size ** -0.5) < 0.01
    assert abs(tparams["embed"].float().std().item() - 0.02) < 0.002
    again = init_fn(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["w_down"],
                       tparams["layers"]["w_down"])
