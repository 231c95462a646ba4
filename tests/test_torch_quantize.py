"""Weight-only int8 quantization of the torch port against the JAX
package, on the CPU: the port's ``models/quantize.py`` against JAX
``quantize_loaded`` (numpy) and ``quantize_tree`` (XLA), the int8 init,
and the logits of a quantized tiny-llama (embeddings quantized or not,
tied and untied head) against JAX ``apply`` at 1e-4 in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import quantize as jquant
from production_stack_tpu_torch.models import convert
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import quantize as tquant

torch.set_num_threads(1)

TOL = 1e-4
# XLA computes amax / 127 as a multiply by the rounded reciprocal, so its
# scales may sit one float32 ulp (2^-23 relative, 1.19e-7) from the IEEE
# quotient that numpy, the JAX quantize_loaded and this port compute.
XLA_SCALE_RTOL = 2.0 ** -23


def _jax_tree(tie: bool, seed: int = 0):
    cfg = jax_model_config("tiny-llama").replace(
        dtype="float32", tie_word_embeddings=tie)
    return cfg, jax.tree.map(np.asarray,
                             jllama.init_params(cfg, jax.random.key(seed)))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _assert_codes_close(got, want, what):
    """int8 codes equal but for a flip by one at a rounding tie, which
    XLA's and IEEE division may break apart (the JAX module says so)."""
    diff = np.asarray(got).astype(np.int32) - np.asarray(want).astype(
        np.int32)
    assert np.abs(diff).max() <= 1, what
    assert (diff != 0).mean() <= 1e-3, (what, (diff != 0).sum())


@pytest.mark.parametrize("quantize_embeddings", [False, True])
def test_quantize_loaded_matches_jax(quantize_embeddings):
    _, tree = _jax_tree(tie=False)
    want = jquant.quantize_loaded(tree, "llama",
                                  quantize_embeddings=quantize_embeddings)
    got = tquant.quantize_loaded(tree, "llama",
                                 quantize_embeddings=quantize_embeddings)
    want_flat, got_flat = dict(_flat(want)), dict(_flat(got))
    assert sorted(got_flat) == sorted(want_flat)
    for name, w in want_flat.items():
        assert got_flat[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got_flat[name], w, err_msg=name)
    # Against the traceable JAX twin: scales within one ulp, codes within
    # one.
    traced = jax.tree.map(np.asarray, jax.jit(
        lambda p: jquant.quantize_tree(
            p, "llama", quantize_embeddings=quantize_embeddings))(
        jax.tree.map(jnp.asarray, tree)))
    for name, w in dict(_flat(traced)).items():
        if name.endswith("_scale"):
            np.testing.assert_allclose(got_flat[name], w,
                                       rtol=XLA_SCALE_RTOL, err_msg=name)
        elif w.dtype == np.int8:
            _assert_codes_close(got_flat[name], w, name)
    with pytest.raises(ValueError, match="llama"):
        tquant.quantize_loaded(tree, "opt")


@pytest.mark.parametrize("name,axis", [("wq", -2), ("w_down", -2),
                                       ("embed", -1), ("lm_head", -2)])
def test_quantize_tensor_matches_numpy_and_xla(name, axis):
    _, tree = _jax_tree(tie=False, seed=3)
    w = tree["layers"][name] if name in tree["layers"] else tree[name]
    q, s = tquant.quantize_tensor(torch.from_numpy(w.copy()), axis)
    wq, ws = jquant._quantize_np(w, axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == ws.shape
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(s.numpy(), ws)
    xq, xs = jax.jit(jquant._quantize_jnp, static_argnums=1)(
        jnp.asarray(w), axis)
    np.testing.assert_allclose(s.numpy(), np.asarray(xs),
                               rtol=XLA_SCALE_RTOL)
    _assert_codes_close(q.numpy(), xq, name)


@pytest.mark.parametrize("quantize_embeddings", [False, True])
def test_int8_init_quantizes_the_same_draws(quantize_embeddings):
    """``init_params(quantization="int8")`` draws what the unquantized
    init draws and quantizes each leaf: the same leaves and shapes as the
    JAX quantize_tree of its init, and the codes of the bf16 init."""
    tcfg = get_model_config("tiny-llama")
    jcfg = jax_model_config("tiny-llama")
    kw = dict(lora_slots=2, lora_rank=4)
    got = tllama.init_params(tcfg, torch.Generator().manual_seed(5), "cpu",
                             quantization="int8",
                             quantize_embeddings=quantize_embeddings, **kw)
    plain = tllama.init_params(tcfg, torch.Generator().manual_seed(5), "cpu",
                               **kw)
    jshapes = dict(_flat(jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)),
        jax.eval_shape(lambda: jquant.quantize_tree(
            jllama.init_params(jcfg, jax.random.key(0), **kw), "llama",
            quantize_embeddings=quantize_embeddings)))))
    got_flat = dict(_flat(got))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got_flat.items()} == jshapes
    for name, w in _flat(plain):
        short = name.split(".")[-1]
        quantized = (short in tquant.LLAMA_LAYER_KEYS
                     or (quantize_embeddings and short in ("embed",
                                                           "lm_head")))
        if not quantized:
            assert torch.equal(got_flat[name], w), name
            continue
        axis = -1 if short == "embed" else -2
        q, s = tquant.quantize_tensor(w, axis)
        assert torch.equal(got_flat[name], q), name
        assert torch.equal(got_flat[name + "_scale"], s), name
    with pytest.raises(ValueError, match="quantization"):
        tllama.init_params(tcfg, torch.Generator(), "cpu",
                           quantization="int4")


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("quantize_embeddings", [False, True])
def test_quantized_model_logits_match_jax(tie, quantize_embeddings):
    """A prefill and a decode of tiny-llama with int8 weights (the JAX
    quantize_loaded tree in both packages): logits at 1e-4 in float32."""
    jcfg, tree = _jax_tree(tie=tie, seed=1)
    tree = jquant.quantize_loaded(tree, "llama",
                                  quantize_embeddings=quantize_embeddings)
    tcfg = get_model_config("tiny-llama").replace(
        dtype="float32", tie_word_embeddings=tie)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.params_from_numpy(tree, tcfg, "cpu")
    assert tparams["layers"]["wq"].dtype == torch.int8
    assert (tparams["embed"].dtype == torch.int8) == quantize_embeddings
    assert ("lm_head" in tparams) == (not tie)
    L, KVH, D, bs, NB = 2, 2, 32, 4, 8
    shape = (L, NB, bs, KVH, D)
    jkv = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    tkv = (torch.zeros(shape), torch.zeros(shape))
    rng = np.random.default_rng(2)
    tables = np.stack([np.arange(4), np.arange(4, 8)]).astype(np.int32)
    T = 12
    take = np.asarray([12, 9], np.int32)
    tokens = rng.integers(0, 512, size=(2, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    slots = np.where(positions < take[:, None],
                     tables[:, :3].repeat(bs, 1)[:, :T] * bs + positions % bs,
                     -1).astype(np.int64)
    steps = [(tokens, positions, slots, take, take, "prefill")]
    pos = take[:, None].astype(np.int32)
    steps.append((rng.integers(0, 512, size=(2, 1)).astype(np.int32), pos,
                  (tables[np.arange(2), pos[:, 0] // bs] * bs
                   + pos[:, 0] % bs)[:, None].astype(np.int64),
                  (take + 1).astype(np.int32), np.ones((2,), np.int32),
                  "decode"))
    for tok, pos, sl, ctx, lens, mode in steps:
        jl, jkv = jllama.apply(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jkv,
            jnp.asarray(sl), jnp.asarray(tables), jnp.asarray(ctx),
            jnp.asarray(lens), mode=mode)
        t = torch.from_numpy
        tl, _ = tllama.apply(tparams, tcfg, t(tok), t(pos), tkv, t(sl),
                             t(tables), t(ctx), t(lens), mode=mode)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
