"""The torch Llama forward against the JAX one: tiny-llama in float32,
the same weights (JAX init carried over by ``params_from_numpy``) with
NON-zero LoRA adapters selected per row, the same token ids — logits and
the written KV pages agree at 1e-4 in prefill, prefill_cached and decode
modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import llama as jllama
from production_stack_tpu_torch.models import convert
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

TOL = 1e-4
L_SLOTS, RANK = 4, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jax_model_config("tiny-llama").replace(dtype="float32")
    tcfg = get_model_config("tiny-llama").replace(dtype="float32")
    params = jllama.init_params(jcfg, jax.random.key(0),
                                lora_slots=L_SLOTS, lora_rank=RANK)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    for name in ("wq_a", "wq_b", "wv_a", "wv_b"):
        shape = tree["lora"][name].shape
        tree["lora"][name] = (0.2 * rng.normal(size=shape)).astype(np.float32)
    tree["lora"]["scaling"] = np.asarray([0.0, 0.5, 1.0, 2.0], np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _pages(cfg, NB=16, bs=4):
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads, cfg.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def _slots(tables, positions, take, bs=4):
    slots = np.full(positions.shape, -1, np.int64)
    for b, n in enumerate(take):
        pos = positions[b, :n]
        slots[b, :n] = tables[b, pos // bs] * bs + pos % bs
    return slots


def _step(models, state, *, tokens, positions, slots, tables, context,
          seq_lens, mode, last_token=None):
    jcfg, tcfg, jparams, tparams = models
    adapters = np.asarray([1, 3], np.int32)
    jlogits, jkv = jllama.apply(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        state["jax_kv"], jnp.asarray(slots), jnp.asarray(tables),
        jnp.asarray(context), jnp.asarray(seq_lens), mode=mode,
        adapter_ids=jnp.asarray(adapters),
        last_token=None if last_token is None else jnp.asarray(last_token))
    t = torch.from_numpy
    tlogits, tkv = tllama.apply(
        tparams, tcfg, t(tokens), t(positions), state["torch_kv"], t(slots),
        t(tables), t(context), t(seq_lens), mode=mode,
        adapter_ids=t(adapters.astype(np.int64)),
        last_token=None if last_token is None else t(last_token))
    assert tkv[0] is state["torch_kv"][0]  # pages updated in place
    state["jax_kv"] = jkv
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for got, want in zip(tkv, jkv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    return tlogits


def test_three_modes_match_jax_with_lora(models):
    jcfg = models[0]
    k0, v0 = _pages(jcfg)
    state = {"jax_kv": (jnp.asarray(k0), jnp.asarray(v0)),
             "torch_kv": (torch.from_numpy(k0.copy()),
                          torch.from_numpy(v0.copy()))}
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

    # Cached prefill: an 8-token chunk over each row's prefix, logits
    # sliced to each row's last real token.
    T2 = 8
    take2 = np.asarray([8, 5], np.int32)
    positions2 = (take[:, None] + np.arange(T2)[None, :]).astype(np.int32)
    tokens2 = rng.integers(0, jcfg.vocab_size, size=(2, T2)).astype(np.int32)
    logits2 = _step(models, state, tokens=tokens2, positions=positions2,
                    slots=_slots(tables, positions2, take2), tables=tables,
                    context=take + take2, seq_lens=take2,
                    mode="prefill_cached", last_token=take2 - 1)
    assert logits2.shape == (2, 1, jcfg.vocab_size)

    # Decode: one token per row over the pages (context includes it).
    pos3 = (take + take2)[:, None].astype(np.int32)
    tokens3 = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    _step(models, state, tokens=tokens3, positions=pos3,
          slots=_slots(tables, pos3, [1, 1]), tables=tables,
          context=(pos3[:, 0] + 1).astype(np.int32),
          seq_lens=np.ones((2,), np.int32), mode="decode")


def test_lora_delta_is_really_compared(models):
    """Selecting other adapters changes the logits: the LoRA path is live
    in the comparison above, not a zero delta."""
    _, tcfg, _, tparams = models
    k0, v0 = _pages(tcfg)
    tokens = torch.arange(8)[None].repeat(2, 1)
    pos = torch.arange(8)[None].repeat(2, 1)
    slots = torch.full((2, 8), -1)
    out = []
    for adapters in ([0, 0], [1, 3]):
        logits, _ = tllama.apply(
            tparams, tcfg, tokens, pos,
            (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())),
            slots, torch.zeros((2, 2), dtype=torch.int32),
            torch.tensor([8, 8]), torch.tensor([8, 8]), mode="prefill",
            adapter_ids=torch.tensor(adapters))
        out.append(logits)
    assert (out[0] - out[1]).abs().max() > 1e-2


def test_init_params_shapes_match_jax():
    jcfg = jax_model_config("tiny-llama")
    tcfg = get_model_config("tiny-llama")
    jshapes = jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)),
        jax.eval_shape(lambda: jllama.init_params(
            jcfg, jax.random.key(0), lora_slots=2, lora_rank=4)))
    gen = torch.Generator().manual_seed(0)
    tparams = tllama.init_params(tcfg, gen, "cpu", lora_slots=2, lora_rank=4)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), str(node.dtype).replace("torch.", ""))

    assert shapes(tparams) == jshapes
    # Scales: normal / sqrt(fan_in), unit norms, zero LoRA.
    wq = tparams["layers"]["wq"].float()
    assert abs(wq.std().item() - tcfg.hidden_size ** -0.5) < 0.01
    assert torch.all(tparams["layers"]["attn_norm"] == 1)
    assert torch.all(tparams["lora"]["wq_b"] == 0)
    again = tllama.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], tparams["embed"])


def test_int8_weights_match_jax(models):
    """An int8 weight leaf (JAX-quantized) in the projection: h @ W in h's
    dtype, the per-output-channel scale on the result, as JAX computes it
    (whole quantized models in tests/test_torch_quantize.py)."""
    from production_stack_tpu.models.quantize import quantize_loaded

    jcfg, tcfg, jparams, _ = models
    tree = quantize_loaded(
        {"layers": {"wq": np.asarray(jparams["layers"]["wq"])}}, "llama")
    h = np.random.default_rng(3).normal(
        size=(2, 3, tcfg.hidden_size)).astype(np.float32)
    want = jllama._proj(jnp.asarray(h), {k: jnp.asarray(v[0]) for k, v in
                                         tree["layers"].items()}, "wq")
    p = {k: torch.from_numpy(v[0]) for k, v in tree["layers"].items()}
    assert p["wq"].dtype == torch.int8
    got = tllama._proj(torch.from_numpy(h), p, "wq")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_and_rms_norm_match_jax(theta):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    want = jllama.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    w = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)


def test_bf16_leaves_cross_over_bit_exact():
    """JAX bf16 arrays reach numpy as the ml_dtypes extension type; the
    converter keeps every bit and the dtype."""
    x = jnp.asarray(np.random.default_rng(2).normal(size=(3, 5)),
                    jnp.bfloat16)
    tree = {"a": np.asarray(x), "b": {"c": np.arange(4, dtype=np.int32)}}
    got = convert.params_from_numpy(
        tree, get_model_config("tiny-llama"), "cpu")
    assert got["a"].dtype is torch.bfloat16
    assert got["b"]["c"].dtype is torch.int32
    np.testing.assert_array_equal(
        got["a"].view(torch.int16).numpy(),
        np.asarray(x).view(np.int16))
