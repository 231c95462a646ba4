"""Plain attention ops of the torch port against the JAX package, on the
CPU, from the same numpy inputs:

- against the JAX XLA references in float32 at 1e-5 (the bar of
  tests/test_models.py);
- against the Pallas kernels run in interpret mode at their own 2e-3
  (tests/test_pallas_attention.py, tests/test_prefill_kernel.py).

The CUDA kernels cannot run here (no nvcc, no card); chip_smoke.py holds
them against these same plain versions on an H100."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import production_stack_tpu.ops.attention as jatt
import production_stack_tpu_torch.ops.attention as tatt
from production_stack_tpu.ops.pallas_paged_attention import (
    pallas_paged_attention,
)
from production_stack_tpu.ops.pallas_prefill_attention import (
    pallas_prefill_attention,
)
from production_stack_tpu_torch.ops.paged_attention import paged_attention
from production_stack_tpu_torch.ops.prefill_attention import (
    cached_prefill_attention,
)

torch.set_num_threads(1)

XLA_TOL = 1e-5
PALLAS_TOL = 2e-3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _decode_inputs(B, H, KVH, D, L, bs, MAXB, ctx, seed):
    rng = np.random.default_rng(seed)
    NB = B * MAXB + 2
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    v = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    tables = rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)
    return q, k, v, tables, np.asarray(ctx, np.int32)


@pytest.mark.parametrize("H,KVH", [(8, 4), (6, 2), (4, 4)])  # GQA 2, 3, 1
@pytest.mark.parametrize("MAXB", [3, 16])
def test_paged_reference_matches_xla(H, KVH, MAXB):
    B, D, L, bs = 4, 32, 3, 4
    ctx = [1, MAXB * bs, 5, MAXB * bs - 3]  # ctx=1 and full tables
    q, k, v, tables, cl = _decode_inputs(B, H, KVH, D, L, bs, MAXB, ctx,
                                         seed=H + MAXB)
    for layer in (0, L - 1):
        want = jatt.paged_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(cl), jnp.int32(layer),
            scale=0.17)
        got = tatt.paged_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(cl), layer,
            scale=0.17)
        _close(got, want, XLA_TOL)
        # The dispatcher and the kernel wrapper take the plain version for
        # CPU tensors (and never count a launch).
        before = paged_attention.launches
        via = tatt.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(cl), layer,
            scale=0.17)
        assert torch.equal(via, got)
        assert paged_attention.launches == before


@pytest.mark.parametrize("H,KVH", [(16, 8), (24, 8), (8, 8)])  # GQA 2, 3, 1
def test_paged_reference_matches_pallas_interpret(H, KVH):
    B, D, L, bs, MAXB = 4, 128, 2, 16, 8
    ctx = [1, 128, 37, 100]
    q, k, v, tables, cl = _decode_inputs(B, H, KVH, D, L, bs, MAXB, ctx,
                                         seed=H)
    # Table entries past each live range point at page 0, poisoned.
    k[:, 0] = 1e9
    v[:, 0] = 1e9
    for b, c in enumerate(ctx):
        tables[b, -(-c // bs):] = 0
    for layer in (0, L - 1):
        want = pallas_paged_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(cl), jnp.int32(layer),
            scale=0.1, interpret=True)
        got = tatt.paged_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(cl), layer, scale=0.1)
        _close(got, want, PALLAS_TOL)


def test_prefill_attention_matches_xla():
    B, T, H, KVH, D = 3, 16, 6, 2, 32
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    seq_lens = np.asarray([16, 7, 1], np.int32)
    want = jatt.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.2,
                                  seq_lens=jnp.asarray(seq_lens))
    got = tatt.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), scale=0.2,
                                 seq_lens=torch.from_numpy(seq_lens))
    _close(got, want, XLA_TOL)
    no_lens = tatt.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale=0.2)
    _close(no_lens, jatt.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.2), XLA_TOL)


def _prefill_inputs(B, T, KVH, group, D, L, bs, MAXB, prefix, take, seed,
                    layer=1):
    """Pages holding each row's prefix AND its fresh chunk (the engine's
    write-then-attend layout), plus the chunk's k_new/v_new."""
    rng = np.random.default_rng(seed)
    H = KVH * group
    S = MAXB * bs
    NB = B * MAXB + 2
    tables = rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)
    prefix = np.asarray(prefix, np.int32)
    take = np.asarray(take, np.int32)
    positions = (prefix[:, None] + np.arange(T)[None, :]).astype(np.int32)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    ctx_k = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    ctx_v = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    kd = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    vd = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    for b in range(B):
        for j in range(MAXB):
            kd[layer, tables[b, j]] = ctx_k[b, j * bs:(j + 1) * bs]
            vd[layer, tables[b, j]] = ctx_v[b, j * bs:(j + 1) * bs]
    k_new = np.take_along_axis(ctx_k, positions[:, :, None, None], axis=1)
    v_new = np.take_along_axis(ctx_v, positions[:, :, None, None], axis=1)
    return dict(q=q, k=kd, v=vd, tables=tables, positions=positions,
                total=(prefix + take).astype(np.int32), layer=layer,
                k_new=k_new, v_new=v_new, take=take)


def _torch_ref(s, scale):
    return tatt._context_prefill_reference(
        torch.from_numpy(s["q"]), torch.from_numpy(s["k"]),
        torch.from_numpy(s["v"]), torch.from_numpy(s["tables"]),
        torch.from_numpy(s["positions"]), torch.from_numpy(s["total"]),
        s["layer"], scale=scale)


def _jax_ref(s, scale):
    return jatt.context_prefill_attention(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        jnp.asarray(s["tables"]), jnp.asarray(s["positions"]),
        jnp.asarray(s["total"]), jnp.int32(s["layer"]), scale=scale)


@pytest.mark.parametrize("group,KVH", [(2, 2), (3, 2), (1, 4)])
@pytest.mark.parametrize("MAXB", [4, 9])
def test_context_prefill_reference_matches_xla(group, KVH, MAXB):
    B, T, D, L, bs = 3, 8, 32, 2, 4
    prefix = [0, 5, MAXB * bs - T]
    s = _prefill_inputs(B, T, KVH, group, D, L, bs, MAXB, prefix,
                        take=[8, 3, 8], seed=group * 10 + MAXB)
    _close(_torch_ref(s, 0.13), _jax_ref(s, 0.13), XLA_TOL)
    # The CPU dispatcher takes the plain path.
    before = cached_prefill_attention.launches
    via = tatt.context_prefill_attention(
        torch.from_numpy(s["q"]), torch.from_numpy(s["k"]),
        torch.from_numpy(s["v"]), torch.from_numpy(s["tables"]),
        torch.from_numpy(s["positions"]), torch.from_numpy(s["total"]),
        s["layer"], scale=0.13)
    _close(via, _jax_ref(s, 0.13), XLA_TOL)
    assert cached_prefill_attention.launches == before


def test_chunked_context_prefill_branch_matches_xla(monkeypatch):
    """The bounded-memory online-softmax branch, forced at toy shapes (as
    tests/test_pallas_attention.py forces it for JAX), against both JAX
    branches; the 48-token span leaves a ragged tail."""
    B, T, KVH, group, D, L, bs, MAXB = 3, 16, 4, 3, 32, 2, 16, 8
    s = _prefill_inputs(B, T, KVH, group, D, L, bs, MAXB,
                        prefix=[84, 61, 112], take=[16, 16, 16], seed=3)
    one_shot = _jax_ref(s, 0.11)
    for span in (32, 48):
        monkeypatch.setattr(tatt, "_CHUNKED_SCORE_BYTES", 0)
        monkeypatch.setattr(tatt, "_CHUNKED_SCORE_SPAN", span)
        got = _torch_ref(s, 0.11)
        _close(got, one_shot, XLA_TOL)
        monkeypatch.setattr(jatt, "_CHUNKED_SCORE_BYTES", 0)
        monkeypatch.setattr(jatt, "_CHUNKED_SCORE_SPAN", span)
        _close(got, _jax_ref(s, 0.11), XLA_TOL)
        monkeypatch.undo()


@pytest.mark.parametrize("group,MAXB,prefix,take", [
    (1, 4, [0, 16, 20], [12, 12, 5]),
    (2, 8, [0, 9, 52], [12, 1, 12]),
])
def test_context_prefill_reference_matches_pallas_interpret(group, MAXB,
                                                            prefix, take):
    B, T, KVH, D, L, bs = 3, 12, 8, 128, 2, 8
    s = _prefill_inputs(B, T, KVH, group, D, L, bs, MAXB, prefix, take,
                        seed=group + MAXB)
    want = pallas_prefill_attention(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        jnp.asarray(s["tables"]), jnp.asarray(s["positions"]),
        jnp.asarray(s["total"]), jnp.int32(s["layer"]),
        jnp.asarray(s["k_new"]), jnp.asarray(s["v_new"]),
        jnp.asarray(s["take"]), scale=0.09, interpret=True)
    got = _torch_ref(s, 0.09)
    # Rows past each row's fresh length are padding the engine discards.
    for b, n in enumerate(take):
        _close(got[b, :n], np.asarray(want)[b, :n], PALLAS_TOL)


def test_gather_ctx_matches_xla():
    q, k, v, tables, _ = _decode_inputs(2, 4, 2, 8, 3, 4, 5, [1, 1], seed=9)
    want = jatt._gather_ctx(jnp.asarray(k), jnp.asarray(tables), jnp.int32(2))
    got = tatt._gather_ctx(torch.from_numpy(k), torch.from_numpy(tables), 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_write_kv_pages_drops_negative_slots_in_place():
    L, NB, bs, KVH, D, B, T = 3, 6, 4, 2, 8, 2, 5
    rng = np.random.default_rng(4)
    k = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    v = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    k_new = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    v_new = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    slots = np.asarray([[0, 5, 6, -1, 23], [-1, -1, 10, 11, -7]], np.int64)
    for layer in (0, 2):
        want_k, want_v = jatt.write_kv_pages(
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_new),
            jnp.asarray(v_new), jnp.asarray(slots), jnp.int32(layer))
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        got_k, got_v = tatt.write_kv_pages(
            tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
            torch.from_numpy(slots), layer)
        assert got_k is tk and got_v is tv  # updated in place
        np.testing.assert_array_equal(_np(tk), np.asarray(want_k))
        np.testing.assert_array_equal(_np(tv), np.asarray(want_v))
        # Exactly the live slots changed.
        changed = (_np(tk) != k).any(axis=(-1, -2)).reshape(-1)
        live = slots[slots >= 0] + layer * NB * bs
        assert sorted(np.nonzero(changed)[0]) == sorted(live)


def test_int8_pages_match_xla():
    """int8 (data, scales) pages reach the plain version, which
    dequantizes them as the JAX reference does (more int8 cases in
    tests/test_torch_kv_quant.py)."""
    q, k, v, tables, cl = _decode_inputs(1, 2, 2, 8, 1, 4, 2, [3], seed=1)
    kq, ks = jatt.quantize_kv(jnp.asarray(k))
    vq, vs = jatt.quantize_kv(jnp.asarray(v))
    k_pages = (kq, ks.reshape(1, k.shape[1], 8))
    v_pages = (vq, vs.reshape(1, v.shape[1], 8))
    want = jatt.paged_attention_reference(
        jnp.asarray(q), k_pages, v_pages, jnp.asarray(tables),
        jnp.asarray(cl), jnp.int32(0), scale=1.0)

    def torch_pages(p):
        return tuple(torch.from_numpy(np.array(a)) for a in p)

    got = tatt.paged_attention_reference(
        torch.from_numpy(q), torch_pages(k_pages), torch_pages(v_pages),
        torch.from_numpy(tables), torch.from_numpy(cl), 0, scale=1.0)
    _close(got, want, XLA_TOL)
