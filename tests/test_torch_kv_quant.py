"""The int8 KV cache of the torch port against the JAX package, on the
CPU, from the same numpy inputs:

- ``quantize_kv``: scales to 1e-7 relative, int8 codes equal except at
  rounding ties, an all-zero row at scale 1/127;
- the in-place int8 page write against JAX ``write_kv_pages``;
- the int8 branches of both plain attention versions against the JAX
  references on the same int8 pages, f32 at 1e-5, and against the int8
  Pallas kernels in interpret mode at their own 2e-3;
- tiny-llama logits and written pages with an int8 pool, in prefill,
  prefill_cached and decode, against JAX ``apply``;
- greedy streams of the int8 torch ``EngineCore`` (int8 KV and int8
  weights) against the JAX engine configured the same;
- the pool's bytes per block and the ``kv_cache_dtype`` on ``stats()``
  and ``/metrics``.

The CUDA kernels cannot run here; tests/test_torch_kernels_cuda.py and
chip_smoke.py hold their int8 modes against the same plain versions on
the card."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import production_stack_tpu.ops.attention as jatt
import production_stack_tpu_torch.ops.attention as tatt
from production_stack_tpu.engine.core import (
    kv_bytes_per_block as jax_kv_bytes_per_block,
)
from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.ops.pallas_paged_attention import (
    pallas_paged_attention,
)
from production_stack_tpu.ops.pallas_prefill_attention import (
    pallas_prefill_attention,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import (
    EngineCore,
    kv_bytes_per_block,
)
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.models import convert
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.paged_attention import paged_attention
from production_stack_tpu_torch.ops.prefill_attention import (
    cached_prefill_attention,
)
from test_torch_engine import MAKE_ENGINE, Pair, cfg_model

torch.set_num_threads(1)

XLA_TOL = 1e-5
PALLAS_TOL = 2e-3
MODEL_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _quantized(x):
    """JAX-quantized (codes, scales [..., KVH]) of float values, as numpy."""
    q, s = jatt.quantize_kv(jnp.asarray(x))
    return np.array(q), np.array(s)


def _pages_int8(rng, L, NB, bs, KVH, D):
    """One side of an int8 pool: JAX-quantized random values, as numpy
    (codes [L, NB, bs, KVH, D], scales [L, NB, bs*KVH])."""
    q, s = _quantized(rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32))
    return q, s.reshape(L, NB, bs * KVH)


def _jpages(p):
    return (jnp.asarray(p[0]), jnp.asarray(p[1]))


def _tpages(p):
    return (_t(p[0]).clone(), _t(p[1]).clone())


# -- quantize_kv and the write --------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 4, 64)).astype(np.float32)
    x[3, 1] = 0.0  # an all-zero row
    # A row full of rounding ties: amax 127 makes the scale exactly 1.0,
    # so k + 0.5 lands on a tie for every k.
    x[9, 2] = np.concatenate([[127.0], np.arange(63) - 31.5])
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else x.dtype)
    xt = convert.tensor_from_numpy(np.asarray(xj), "cpu")
    jq, js = (np.asarray(a) for a in jatt.quantize_kv(xj))
    tq, ts = tatt.quantize_kv(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-7, atol=0)
    # Both round half to even; codes may differ only at a tie, by one.
    # Ties: the planted row's 63, plus the few that bf16's coarse values
    # land on (under 1% of the elements).
    ratio = xt.float().numpy() / ts.numpy()[..., None]
    ties = np.abs(ratio - np.trunc(ratio)) == 0.5
    diff = tq.numpy().astype(np.int32) - jq.astype(np.int32)
    assert 63 <= ties.sum() <= 0.01 * ties.size
    assert np.all(np.abs(diff) <= 1)
    assert np.all(ties[diff != 0])
    assert (diff != 0).sum() <= ties.sum()
    # The all-zero row: scale 1/127, codes 0 (the JAX docstring says 1.0;
    # its code, and this port, give amax 1.0, so 1/127).
    assert ts[3, 1].item() == np.float32(1.0) / np.float32(127.0)
    assert torch.all(tq[3, 1] == 0)


def test_int8_write_matches_jax_in_place():
    L, NB, bs, KVH, D, B, T = 3, 6, 4, 2, 8, 2, 5
    rng = np.random.default_rng(4)
    k, v = (_pages_int8(rng, L, NB, bs, KVH, D) for _ in range(2))
    k_new = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    v_new = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    slots = np.asarray([[0, 5, 6, -1, 23], [-1, -1, 10, 11, -7]], np.int64)
    for layer in (0, 2):
        want = jatt.write_kv_pages(
            _jpages(k), _jpages(v), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(slots), jnp.int32(layer))
        tk, tv = _tpages(k), _tpages(v)
        got = tatt.write_kv_pages(tk, tv, _t(k_new), _t(v_new), _t(slots),
                                  layer)
        assert got[0][0] is tk[0] and got[1][1] is tv[1]  # in place
        for side, old, (wd, ws) in zip((tk, tv), (k, v), want):
            np.testing.assert_array_equal(side[0].numpy(), np.asarray(wd))
            np.testing.assert_array_equal(side[1].numpy(), np.asarray(ws))
            # Exactly the live slots changed, data and scales alike.
            changed = (side[1].numpy() != old[1]).reshape(-1, KVH).any(-1)
            live = slots[slots >= 0] + layer * NB * bs
            assert sorted(np.nonzero(changed)[0]) == sorted(live)


# -- the plain versions ------------------------------------------------------

def _decode_case(B, H, KVH, D, L, bs, MAXB, ctx, seed):
    rng = np.random.default_rng(seed)
    NB = B * MAXB + 2
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k, v = (_pages_int8(rng, L, NB, bs, KVH, D) for _ in range(2))
    tables = rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)
    return q, k, v, tables, np.asarray(ctx, np.int32)


@pytest.mark.parametrize("H,KVH,MAXB", [(8, 4, 3), (6, 2, 16), (4, 4, 5)])
def test_int8_paged_reference_matches_xla(H, KVH, MAXB):
    B, D, L, bs = 4, 32, 3, 4
    ctx = [1, MAXB * bs, 5, MAXB * bs - 3]
    q, k, v, tables, cl = _decode_case(B, H, KVH, D, L, bs, MAXB, ctx,
                                       seed=H + MAXB)
    for layer in (0, L - 1):
        want = jatt.paged_attention_reference(
            jnp.asarray(q), _jpages(k), _jpages(v), jnp.asarray(tables),
            jnp.asarray(cl), jnp.int32(layer), scale=0.17)
        got = tatt.paged_attention_reference(
            _t(q), _tpages(k), _tpages(v), _t(tables), _t(cl), layer,
            scale=0.17)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=XLA_TOL, atol=XLA_TOL)
        # The wrapper takes the plain version for CPU tensors and counts
        # no launch of either mode.
        before = (paged_attention.launches, paged_attention.launches_int8)
        via = tatt.paged_decode_attention(
            _t(q), _tpages(k), _tpages(v), _t(tables), _t(cl), layer,
            scale=0.17)
        assert torch.equal(via, got)
        assert (paged_attention.launches,
                paged_attention.launches_int8) == before


def test_int8_gather_dequantizes_like_xla():
    q, k, v, tables, _ = _decode_case(2, 4, 2, 8, 3, 4, 5, [1, 1], seed=9)
    want = jatt._gather_ctx(_jpages(k), jnp.asarray(tables), jnp.int32(2))
    got = tatt._gather_ctx(_tpages(k), _t(tables), 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prefill_case(B, T, KVH, group, D, L, bs, MAXB, prefix, take, seed,
                  layer=1):
    """int8 pages holding each row's prefix AND its chunk (the engine's
    write-then-attend layout), plus the chunk's k_new/v_new as the
    dequantized page rows (what the Pallas kernel must see for parity)."""
    rng = np.random.default_rng(seed)
    H, S, NB = KVH * group, MAXB * bs, B * MAXB + 2
    tables = rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)
    prefix, take = np.asarray(prefix, np.int32), np.asarray(take, np.int32)
    positions = (prefix[:, None] + np.arange(T)[None, :]).astype(np.int32)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    pages, news = [], []
    for _ in range(2):
        cq, cs = _quantized(rng.normal(size=(B, S, KVH, D)).astype(np.float32))
        data, scales = _pages_int8(rng, L, NB, bs, KVH, D)
        for b in range(B):
            for j in range(MAXB):
                data[layer, tables[b, j]] = cq[b, j * bs:(j + 1) * bs]
                scales[layer, tables[b, j]] = cs[b, j * bs:(j + 1) * bs] \
                    .reshape(-1)
        pages.append((data, scales))
        deq = cq.astype(np.float32) * cs[..., None]
        news.append(np.take_along_axis(deq, positions[:, :, None, None], 1))
    return dict(q=q, k=pages[0], v=pages[1], tables=tables,
                positions=positions, total=(prefix + take).astype(np.int32),
                layer=layer, k_new=news[0], v_new=news[1], take=take)


def _torch_prefill(s, scale):
    return tatt._context_prefill_reference(
        _t(s["q"]), _tpages(s["k"]), _tpages(s["v"]), _t(s["tables"]),
        _t(s["positions"]), _t(s["total"]), s["layer"], scale=scale)


def _jax_prefill(s, scale):
    return jatt.context_prefill_attention(
        jnp.asarray(s["q"]), _jpages(s["k"]), _jpages(s["v"]),
        jnp.asarray(s["tables"]), jnp.asarray(s["positions"]),
        jnp.asarray(s["total"]), jnp.int32(s["layer"]), scale=scale)


@pytest.mark.parametrize("group,KVH,MAXB", [(2, 2, 4), (3, 2, 9), (1, 4, 9)])
def test_int8_context_prefill_reference_matches_xla(group, KVH, MAXB):
    B, T, D, L, bs = 3, 8, 32, 2, 4
    s = _prefill_case(B, T, KVH, group, D, L, bs, MAXB,
                      prefix=[0, 5, MAXB * bs - T], take=[8, 3, 8],
                      seed=group * 10 + MAXB)
    want = _jax_prefill(s, 0.13)
    np.testing.assert_allclose(_torch_prefill(s, 0.13).numpy(),
                               np.asarray(want), rtol=XLA_TOL, atol=XLA_TOL)
    before = (cached_prefill_attention.launches,
              cached_prefill_attention.launches_int8)
    via = tatt.context_prefill_attention(
        _t(s["q"]), _tpages(s["k"]), _tpages(s["v"]), _t(s["tables"]),
        _t(s["positions"]), _t(s["total"]), s["layer"], scale=0.13)
    np.testing.assert_allclose(via.numpy(), np.asarray(want), rtol=XLA_TOL,
                               atol=XLA_TOL)
    assert (cached_prefill_attention.launches,
            cached_prefill_attention.launches_int8) == before


def test_int8_chunked_context_prefill_branch_matches_xla(monkeypatch):
    """The bounded-memory online-softmax branch on int8 pages, forced at
    toy shapes as tests/test_pallas_attention.py forces it; the 48-token
    span leaves a ragged tail."""
    s = _prefill_case(3, 16, 4, 3, 32, 2, 16, 8, prefix=[84, 61, 112],
                      take=[16, 16, 16], seed=3)
    one_shot = _jax_prefill(s, 0.11)
    for span in (32, 48):
        monkeypatch.setattr(tatt, "_CHUNKED_SCORE_BYTES", 0)
        monkeypatch.setattr(tatt, "_CHUNKED_SCORE_SPAN", span)
        got = _torch_prefill(s, 0.11).numpy()
        np.testing.assert_allclose(got, np.asarray(one_shot), rtol=XLA_TOL,
                                   atol=XLA_TOL)
        monkeypatch.setattr(jatt, "_CHUNKED_SCORE_BYTES", 0)
        monkeypatch.setattr(jatt, "_CHUNKED_SCORE_SPAN", span)
        np.testing.assert_allclose(got, np.asarray(_jax_prefill(s, 0.11)),
                                   rtol=XLA_TOL, atol=XLA_TOL)
        monkeypatch.undo()


def test_int8_paged_reference_matches_pallas_interpret():
    """The shapes of tests/test_kv_quant.py's int8 kernel test."""
    B, H, KVH, D, L, bs, MAXB = 4, 16, 8, 128, 3, 16, 4
    rng = np.random.default_rng(29)
    ctx = rng.integers(1, MAXB * bs + 1, size=(B,)).astype(np.int32)
    q, k, v, tables, cl = _decode_case(B, H, KVH, D, L, bs, MAXB, ctx,
                                       seed=29)
    for layer in (0, L - 1):
        want = pallas_paged_attention(
            jnp.asarray(q), _jpages(k), _jpages(v), jnp.asarray(tables),
            jnp.asarray(cl), jnp.int32(layer), scale=0.1, interpret=True)
        got = tatt.paged_attention_reference(
            _t(q), _tpages(k), _tpages(v), _t(tables), _t(cl), layer,
            scale=0.1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_int8_context_prefill_reference_matches_pallas_interpret():
    """The shapes of tests/test_prefill_kernel.py's int8 test, with the
    chunk's k_new/v_new set to its dequantized page rows: only then do the
    Pallas kernel (chunk at full precision) and the plain version (chunk
    read back from the int8 pages) compute the same function."""
    B, T, KVH, group, D, L, bs, MAXB = 3, 12, 8, 2, 128, 2, 16, 4
    take = [12, 5, 12]
    s = _prefill_case(B, T, KVH, group, D, L, bs, MAXB, prefix=[0, 9, 40],
                      take=take, seed=7)
    want = np.asarray(pallas_prefill_attention(
        jnp.asarray(s["q"]), _jpages(s["k"]), _jpages(s["v"]),
        jnp.asarray(s["tables"]), jnp.asarray(s["positions"]),
        jnp.asarray(s["total"]), jnp.int32(s["layer"]),
        jnp.asarray(s["k_new"]), jnp.asarray(s["v_new"]),
        jnp.asarray(s["take"]), scale=0.09, interpret=True))
    got = _torch_prefill(s, 0.09).numpy()
    for b, n in enumerate(take):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=PALLAS_TOL,
                                   atol=PALLAS_TOL)


# -- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_model_config("tiny-llama").replace(dtype="float32")
    tcfg = get_model_config("tiny-llama").replace(dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.key(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, "cpu"))


def _assert_pages_agree(got, want, kv_rel):
    """A written int8 side of the pool: scales within ``kv_rel``, the
    measured relative difference of the two models' float32 K/V row
    maxima that the scales are taken from (a scale is ``amax / 127``,
    rounded once on each side), never looser than 1e-6; codes equal but
    for a rare flip by one where the two models' f32 K/V land on the two
    sides of a rounding boundary."""
    (gd, gs), (wd, ws) = got, (np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_allclose(gs.numpy(), ws,
                               rtol=max(1e-6, kv_rel + 2.0 ** -23), atol=0)
    diff = gd.numpy().astype(np.int32) - wd.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).sum() <= 2, (diff != 0).sum()


def _record_quantizer_inputs(monkeypatch):
    """Record the float32 K/V each model hands its int8 quantizer, layer
    by layer, K before V: ``(torch list, jax list)``. The JAX model runs
    its layers in a ``lax.scan``, so its values leave through an ordered
    debug callback."""
    tgot, jgot = [], []
    tq, jq = tatt.quantize_kv, jatt.quantize_kv

    def t_rec(x):
        tgot.append(x.float().numpy().copy())
        return tq(x)

    def j_rec(x):
        jax.debug.callback(lambda v: jgot.append(np.asarray(v)), x,
                           ordered=True)
        return jq(x)

    monkeypatch.setattr(tatt, "quantize_kv", t_rec)
    monkeypatch.setattr(jatt, "quantize_kv", j_rec)
    return tgot, jgot


def test_model_with_int8_pool_matches_jax(models, monkeypatch):
    """prefill, prefill_cached and decode over an int8 pool; before each
    step the torch pool takes the JAX pool's bytes, so each step's logits
    compare on identical pages. The scales' bar is the measured agreement
    of the K/V they quantize: the two models' float32 K/V differ in the
    last bits (XLA's and torch's reduction order in the RMS norm and
    their own cos, sin and rsqrt), and each step's quantizer inputs are
    held to each other first."""
    jcfg, tcfg, jparams, tparams = models
    L, KVH, D, bs, NB = (jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim,
                         4, 16)
    zeros = (np.zeros((L, NB, bs, KVH, D), np.int8),
             np.ones((L, NB, bs * KVH), np.float32))
    jkv = (_jpages(zeros), _jpages(zeros))
    tables = np.stack([np.arange(8), np.arange(8, 16)]).astype(np.int32)
    rng = np.random.default_rng(1)
    tgot, jgot = _record_quantizer_inputs(monkeypatch)

    def slots(positions, take):
        out = np.full(positions.shape, -1, np.int64)
        for b, n in enumerate(take):
            pos = positions[b, :n]
            out[b, :n] = tables[b, pos // bs] * bs + pos % bs
        return out

    def kv_agreement(sl):
        """Max relative difference of the recorded K/V's row maxima (the
        torch side quantizes the live rows only)."""
        live = np.flatnonzero(sl.reshape(-1) >= 0)
        assert len(tgot) == len(jgot) == 2 * L
        rel = 0.0
        for t, j in zip(tgot, jgot):
            j = j.reshape(-1, KVH, D)[live]
            np.testing.assert_allclose(t, j, rtol=MODEL_TOL, atol=XLA_TOL)
            ta, ja = np.abs(t).max(-1), np.abs(j).max(-1)
            rel = max(rel, float((np.abs(ta - ja) / ja).max()))
        del tgot[:], jgot[:]
        return rel

    def step(tokens, positions, take, context, seq_lens, mode, last=None):
        nonlocal jkv
        tkv = tuple(_tpages((np.asarray(d), np.asarray(s))) for d, s in jkv)
        sl = slots(positions, take)
        jl, jkv = jllama.apply(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jkv,
            jnp.asarray(sl), jnp.asarray(tables), jnp.asarray(context),
            jnp.asarray(seq_lens), mode=mode,
            last_token=None if last is None else jnp.asarray(last))
        jax.effects_barrier()
        tl, out = tllama.apply(
            tparams, tcfg, _t(tokens), _t(positions), tkv, _t(sl),
            _t(tables), _t(context), _t(seq_lens), mode=mode,
            last_token=None if last is None else _t(last))
        assert out[0][0] is tkv[0][0]  # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        kv_rel = kv_agreement(sl)
        for got, want in zip(out, jkv):
            _assert_pages_agree(got, want, kv_rel)

    T, take = 16, np.asarray([16, 11], np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    step(rng.integers(0, 512, (2, T)).astype(np.int32), pos, take, take,
         take, "prefill")
    T2, take2 = 8, np.asarray([8, 5], np.int32)
    pos2 = (take[:, None] + np.arange(T2)[None]).astype(np.int32)
    step(rng.integers(0, 512, (2, T2)).astype(np.int32), pos2, take2,
         take + take2, take2, "prefill_cached", last=take2 - 1)
    pos3 = (take + take2)[:, None].astype(np.int32)
    step(rng.integers(0, 512, (2, 1)).astype(np.int32), pos3, [1, 1],
         (pos3[:, 0] + 1).astype(np.int32), np.ones((2,), np.int32),
         "decode")


# -- the engine --------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair():
    """One JAX/torch pair with an int8 pool and int8 weights (the JAX
    engine quantizes its init; the torch engine takes that tree), short
    prefill chunks and a pool small enough to preempt."""
    p = Pair(kv_cache_dtype="int8", quantization="int8",
             prefill_chunk_size=16, num_blocks=24)
    yield p
    p.stop()


def _replay_logits(pair, tokens, n_prompt, int8):
    """The JAX int8 engine's logits after ``tokens``, replayed the way it
    computes them: the prompt's K/V written by one prefill (attending at
    full precision), each generated token then decoded over the pages.
    ``int8=False`` replays the same on a float32 pool."""
    eng = pair.jax
    cfg = eng.model_config
    apply = jllama.apply
    n = len(tokens)
    bs = 4
    nb = (n + bs - 1) // bs + 1
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim)
    if int8:
        side = (jnp.zeros(shape, jnp.int8),
                jnp.ones(shape[:2] + (bs * cfg.num_kv_heads,), jnp.float32))
    else:
        side = jnp.zeros(shape, jnp.float32)
    kv = (side, side)
    table = jnp.arange(nb, dtype=jnp.int32)[None]
    ids = jnp.asarray([tokens], jnp.int32)
    logits, kv = apply(
        eng.params, cfg, ids[:, :n_prompt],
        jnp.arange(n_prompt, dtype=jnp.int32)[None], kv,
        jnp.arange(n_prompt, dtype=jnp.int32)[None], table,
        jnp.asarray([n_prompt], jnp.int32),
        jnp.asarray([n_prompt], jnp.int32), mode="prefill")
    last = logits[0, -1]
    for i in range(n_prompt, n):
        logits, kv = apply(
            eng.params, cfg, ids[:, i:i + 1], jnp.asarray([[i]], jnp.int32),
            kv, jnp.asarray([[i]], jnp.int32), table,
            jnp.asarray([i + 1], jnp.int32), jnp.ones((1,), jnp.int32),
            mode="decode")
        last = logits[0, 0]
    return np.asarray(last)


def assert_same_int8_streams(pair, prompts, want, got):
    """Identical greedy streams, but for a divergence where the JAX int8
    engine's own top-2 logit gap is below the bar of one quantization
    step. The int8 cache moves each K/V element by at most half a step
    from its value; a rounding tie the two packages break apart (their
    f32 K/V agree to ~1e-7) moves one element by one step, i.e. two of
    those per-element errors. The bar is the largest logit change that
    the whole cache's quantization makes at that position (the JAX replay
    on an int8 pool against the same on a float32 pool), which bounds one
    element's step."""
    for prompt, (w_tok, w_fin), (g_tok, g_fin) in zip(prompts, want, got):
        assert w_fin != "timeout" and g_fin != "timeout"
        if g_tok == w_tok:
            assert g_fin == w_fin
            continue
        i = next((j for j, (a, b) in enumerate(zip(w_tok, g_tok)) if a != b),
                 min(len(w_tok), len(g_tok)))
        ctx = list(prompt) + w_tok[:i]
        q8 = _replay_logits(pair, ctx, len(prompt), True)
        f32 = _replay_logits(pair, ctx, len(prompt), False)
        top2 = np.sort(q8)[-2:]
        gap, bar = float(top2[1] - top2[0]), float(np.abs(q8 - f32).max())
        print(f"int8 divergence at {i}: JAX int8 top-2 gap {gap:.3e}, "
              f"one-quantization-step bar {bar:.3e}")
        assert gap < bar, (
            f"streams diverge at {i} (jax {w_tok}, torch {g_tok}) where "
            f"JAX's int8 top-2 gap {gap} is not below the bar {bar}")


SCENARIOS = {
    "one prompt": ([[1, 2, 3, 4, 5, 6, 7]], dict(temperature=0.0,
                                                  max_tokens=8), True),
    "three concurrent": ([[10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28],
                          list(range(40, 61))],
                         dict(temperature=0.0, max_tokens=12), True),
    "logit shaping": ([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]],
                      dict(temperature=0.0, max_tokens=10,
                           presence_penalty=0.7, frequency_penalty=0.4,
                           logit_bias={5: 1.5, 300: -2.0}, min_tokens=4,
                           stop_token_ids=[11]), True),
    "chunked long prompt": ([list(range(200, 250))],
                            dict(temperature=0.0, max_tokens=8), False),
    "preemption": ([list(range(300 + 10 * i, 310 + 10 * i))
                    for i in range(4)],
                   dict(temperature=0.0, max_tokens=24), True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_int8_engine_streams_match_jax(int8_pair, name):
    prompts, sampling, concurrent = SCENARIOS[name]
    chunks = int8_pair.torch.prefill_chunks_total
    preempted = int8_pair.torch.scheduler.num_preempted_total
    (want,), (got,) = int8_pair.run(prompts, sampling, concurrent)
    assert_same_int8_streams(int8_pair, prompts, want, got)
    if name == "chunked long prompt":  # 50 tokens: chunks 16+16+16+2
        assert int8_pair.torch.prefill_chunks_total - chunks == 4
    if name == "preemption":
        assert int8_pair.torch.scheduler.num_preempted_total > preempted


def test_int8_engine_prefix_cache_hit(int8_pair):
    base = list(range(100, 130))  # 7 full 4-token pages + 2 tokens
    int8_pair.run([base + [7, 8]], dict(temperature=0.0, max_tokens=8))
    cached = int8_pair.torch.cached_tokens_total
    prompts = [base + [9, 10, 11]]
    (want,), (got,) = int8_pair.run(prompts, dict(temperature=0.0,
                                                  max_tokens=8))
    assert int8_pair.torch.cached_tokens_total - cached >= 28
    assert_same_int8_streams(int8_pair, prompts, want, got)


def test_int8_replay_reproduces_the_jax_stream(int8_pair):
    """The divergence yardstick is the JAX int8 engine's own path: its
    replay picks the tokens that engine streamed, and the bar it gives is
    a positive logit change."""
    prompt = [5, 6, 7, 8, 9]
    (want,), _ = int8_pair.run([prompt], dict(temperature=0.0, max_tokens=4))
    tokens = want[0][0]
    for i in range(len(tokens)):
        ctx = prompt + tokens[:i]
        q8 = _replay_logits(int8_pair, ctx, len(prompt), True)
        assert int(np.argmax(q8)) == tokens[i]
    f32 = _replay_logits(int8_pair, ctx, len(prompt), False)
    assert np.abs(q8 - f32).max() > 0


def test_int8_engine_pool_and_weights(int8_pair):
    eng = int8_pair.torch
    (kd, ks), (vd, vs) = eng.kv
    L, NB, bs, KVH, D = kd.shape
    assert kd.dtype == vd.dtype == torch.int8
    assert ks.dtype == vs.dtype == torch.float32
    assert ks.shape == vs.shape == (L, NB, bs * KVH)
    assert eng.params["layers"]["wq"].dtype == torch.int8
    assert eng.params["layers"]["wq_scale"].dtype == torch.float32


# -- bytes per block, stats and /metrics -----------------------------------

def test_int8_bytes_per_block_at_llama8b_dims():
    """At Llama-3-8B KV dims (32 layers, 8 kv heads, D 128, 64-token
    pages) the int8 pool's block is 4,325,376 B against bf16's 8,388,608
    B: 1.94x the blocks at equal memory, and the JAX formula agrees here
    (these dims need no TPU tile padding)."""
    mc = types.SimpleNamespace(num_layers=32, num_kv_heads=8, head_dim=128,
                               torch_dtype=torch.bfloat16, dtype="bfloat16")
    int8 = kv_bytes_per_block(mc, 64, "int8")
    bf16 = kv_bytes_per_block(mc, 64, "bf16")
    assert int8 == 32 * (2 * 64 * 8 * 128 + 2 * 64 * 8 * 4) == 4_325_376
    assert bf16 == 32 * 2 * 64 * 8 * 128 * 2 == 8_388_608
    assert bf16 / int8 >= 1.9
    budget = 8 << 30
    assert budget // int8 >= 1.9 * (budget // bf16)
    assert int8 == jax_kv_bytes_per_block(mc, 64, "int8")
    assert bf16 == jax_kv_bytes_per_block(mc, 64, "bf16")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_stats_and_metrics_carry_the_kv_cache_dtype(kv_dtype):
    cfg = EngineConfig(device="cpu", kv_cache_dtype=kv_dtype,
                       **dict(MAKE_ENGINE, num_blocks=16, max_loras=0))
    eng = EngineCore(cfg)
    s = eng.stats()
    assert s["kv_cache_dtype"] == kv_dtype
    mc = cfg_model(cfg)
    per_token = kv_bytes_per_block(mc, cfg.block_size, kv_dtype) // 4
    assert s["kv_cache_bytes_per_token"] == per_token
    text = EngineServer(eng, ["tiny-llama"]).metrics_text()
    assert (f'tpu:kv_cache_bytes_per_token{{model_name="tiny-llama",'
            f'kv_cache_dtype="{kv_dtype}"}} {per_token}') in text
