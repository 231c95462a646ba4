"""The decode kernel's split-K plan and its plain model, on the CPU.

The bf16 decode kernel (``csrc/paged_attention.cu``) cuts each
sequence's table into runs of whole pages (``split_plan``), keeps an
unnormalised ``(acc, m, l)`` per run and merges the runs by flash
recombination. The plan is pure Python and the merge has a plain model
(``split_partials_reference`` + ``merge_split_partials``); both are held
here against the port's plain decode attention and against the JAX
package's ``paged_attention_reference``, from the same numpy inputs, in
float32 at 1e-5 (the bar of tests/test_torch_attention.py). The kernel
itself runs only on the card (tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import production_stack_tpu.ops.attention as jatt
from production_stack_tpu_torch.ops import attention as tatt
from production_stack_tpu_torch.ops.paged_attention import (
    BLOCKS_PER_SM,
    MAX_SPLITS,
    SPLIT_MIN_TOKENS,
    merge_split_partials,
    split_pages,
    split_partials_reference,
    split_plan,
)

torch.set_num_threads(1)

TOL = 1e-5

# (B, KVH, MAXB, bs, row_tiles): the served shapes (64-token pages, the
# engine's power-of-two table widths), the test shapes (4-token pages),
# odd table widths, long tables and many heads.
PLAN_SHAPES = [
    (8, 8, 32, 64, 1), (8, 8, 64, 64, 1), (1, 8, 64, 64, 1),
    (16, 8, 64, 64, 1), (4, 8, 4, 64, 1), (3, 2, 5, 16, 1),
    (2, 2, 128, 4, 1), (1, 1, 1000, 4, 1), (1, 1, 4096, 64, 1),
    (64, 8, 64, 64, 2), (1, 4, 7, 1, 4), (2, 1, 129, 2, 1),
]


@pytest.mark.parametrize("B,KVH,MAXB,bs,row_tiles", PLAN_SHAPES)
def test_every_live_token_in_exactly_one_split(B, KVH, MAXB, bs, row_tiles):
    splits = split_plan(B, KVH, MAXB, bs, row_tiles=row_tiles)
    pages = split_pages(MAXB, splits)
    assert 1 <= splits <= MAX_SPLITS
    # Splits lie within the table and cover it: each starts on a table
    # page, and together they hold every page once.
    starts = [s * pages for s in range(splits)]
    assert all(st < MAXB for st in starts)
    assert splits * pages >= MAXB
    owner = np.full(MAXB * bs, -1)
    for s, st in enumerate(starts):
        lo, hi = st * bs, min((st + pages) * bs, MAXB * bs)
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    # No more splits than SPLIT_MIN_TOKENS-token runs fill the table;
    # spreading the table evenly over them (the kernel's arithmetic)
    # keeps each run above half of that, unless one split holds it all.
    if splits > 1:
        assert pages * bs > SPLIT_MIN_TOKENS // 2


@pytest.mark.parametrize("bs", [1, 4, 16, 64, 256])
def test_one_split_for_short_contexts(bs):
    for MAXB in range(1, max(1, SPLIT_MIN_TOKENS // bs) + 1):
        for B in (1, 8, 64):
            assert split_plan(B, 8, MAXB, bs) == 1


def test_plan_fills_one_wave_of_resident_blocks():
    # 8 x 2,048 on Llama-3-8B's 8 kv heads: 6 runs of 6 pages (the last
    # 2), 384 blocks, one wave of 3 blocks on each of 132 SMs; one
    # sequence of 4,096 tokens: 16 runs of 4 pages.
    assert split_plan(8, 8, 32, 64) == 6
    assert split_pages(32, 6) == 6
    assert split_plan(1, 8, 64, 64) == 16
    # A batch that fills the wave by itself is not split.
    assert split_plan(64, 8, 64, 64) == 1
    for B, KVH, MAXB, bs, tiles in PLAN_SHAPES:
        splits = split_plan(B, KVH, MAXB, bs, row_tiles=tiles)
        assert splits == 1 or B * KVH * tiles * splits <= BLOCKS_PER_SM * 132


def _inputs(B, H, KVH, D, L, bs, MAXB, ctx, seed):
    rng = np.random.default_rng(seed)
    NB = B * MAXB + 2
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    v = rng.normal(size=(L, NB, bs, KVH, D)).astype(np.float32)
    tables = rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)
    return q, k, v, tables, np.asarray(ctx, np.int32)


# Contexts at, one below and one above a split boundary, one token,
# shorter than one split, more splits than live pages, the full table.
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("H,KVH", [(8, 2), (6, 2), (4, 4)])
def test_merged_splits_match_both_references(splits, H, KVH):
    B, D, L, bs, MAXB = 7, 32, 2, 4, 12
    span = split_pages(MAXB, splits) * bs
    ctx = [span, span - 1, span + 1, 1, 3, MAXB * bs, 2 * span + 5]
    ctx = [min(c, MAXB * bs) for c in ctx]
    q, k, v, tables, cl = _inputs(B, H, KVH, D, L, bs, MAXB, ctx,
                                  seed=splits * 10 + H)
    t = [torch.from_numpy(x) for x in (q, k, v, tables, cl)]
    acc, m, l = split_partials_reference(*t, 1, scale=D ** -0.5,
                                         splits=splits)
    assert acc.shape == (B, H, splits, D) and m.shape == l.shape == (
        B, H, splits)
    merged = merge_split_partials(acc, m, l, torch.float32)
    plain = tatt.paged_attention_reference(*t, 1, scale=D ** -0.5)
    jax_ref = jatt.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(cl), jnp.int32(1), scale=D ** -0.5)
    np.testing.assert_allclose(merged.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jax_ref),
                               rtol=TOL, atol=TOL)
    # Splits past a sequence's context are empty partials.
    for b, c in enumerate(ctx):
        for s in range(splits):
            if s * span >= c:
                assert (l[b, :, s] == 0).all()
                assert (m[b, :, s] == tatt.NEG_INF).all()
                assert (acc[b, :, s] == 0).all()
            else:
                assert (l[b, :, s] > 0).all()


def test_a_left_out_split_changes_the_result():
    # The merge's own check: dropping one live split's partial (a planted
    # kernel fault) moves the output far past the bar.
    B, H, KVH, D, L, bs, MAXB = 2, 4, 2, 32, 1, 4, 16
    q, k, v, tables, cl = _inputs(B, H, KVH, D, L, bs, MAXB, [64, 40], 3)
    t = [torch.from_numpy(x) for x in (q, k, v, tables, cl)]
    acc, m, l = split_partials_reference(*t, 0, scale=D ** -0.5, splits=4)
    full = merge_split_partials(acc, m, l, torch.float32)
    l_cut = l.clone()
    l_cut[:, :, 1] = 0
    cut = merge_split_partials(acc, m, l_cut, torch.float32)
    assert (full - cut).abs().max().item() > 100 * TOL
