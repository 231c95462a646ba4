"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped on a host without a CUDA device (there is no nvcc either);
run there with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (``--noconftest``: the card's machine
has no JAX, which tests/conftest.py imports).
``chip_smoke.py`` makes the same checks at the main-path shapes."""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops import attention as att
from production_stack_tpu_torch.ops.paged_attention import paged_attention
from production_stack_tpu_torch.ops.prefill_attention import (
    cached_prefill_attention,
)

pytestmark = pytest.mark.cuda


def assert_close(got, want):
    """The bars of chip_smoke.py, where they are derived: f32 2e-3
    absolute; bf16 2^-5 of each output row's largest |want|."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert err.max().item() <= 2e-3
    else:
        bar = 2.0 ** -5 * want.float().abs().amax(dim=-1, keepdim=True)
        assert bool((err <= bar).all()), (err / bar).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    return torch.device("cuda")


def _pool(cuda, dtype, L, NB, bs, KVH, D, seed, int8=False):
    """K and V pages of random values: in ``dtype``, or quantized into
    int8 ``(data, scales)`` pairs."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    sides = [torch.randn((L, NB, bs, KVH, D), generator=g, device=cuda,
                         dtype=dtype) for _ in range(2)]
    if not int8:
        return tuple(sides)
    out = []
    for x in sides:
        data, scales = att.quantize_kv(x)
        out.append((data, scales.reshape(L, NB, bs * KVH)))
    return tuple(out)


def _launches(fn, int8):
    return fn.launches_int8 if int8 else fn.launches


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,bs,MAXB", [(8, 2, 64, 16, 5),
                                             (4, 4, 128, 4, 7),
                                             (6, 2, 32, 64, 3)])
def test_paged_attention_matches_plain(cuda, dtype, H, KVH, D, bs, MAXB,
                                       int8):
    rng = np.random.default_rng(H + D)
    B = 3
    k, v = _pool(cuda, dtype, 2, B * MAXB + 1, bs, KVH, D, seed=D, int8=int8)
    q = torch.randn((B, H, D), device=cuda, dtype=dtype)
    tables = torch.from_numpy(rng.permutation(B * MAXB + 1)[:B * MAXB]
                              .reshape(B, MAXB).astype(np.int32)).to(cuda)
    ctx = torch.tensor([1, MAXB * bs, MAXB * bs // 2 + 1], dtype=torch.int32,
                       device=cuda)
    before = _launches(paged_attention, int8)
    got = paged_attention(q, k, v, tables, ctx, 1, scale=D ** -0.5)
    want = att.paged_attention_reference(q, k, v, tables, ctx, 1,
                                         scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(paged_attention, int8) == before + 1
    assert_close(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D", [(6, 2, 64), (8, 8, 128), (4, 2, 32)])
def test_cached_prefill_matches_plain(cuda, dtype, H, KVH, D, int8):
    rng = np.random.default_rng(H * D)
    B, T, bs, MAXB = 2, 40, 8, 12
    k, v = _pool(cuda, dtype, 2, B * MAXB + 1, bs, KVH, D, seed=H, int8=int8)
    q = torch.randn((B, T, H, D), device=cuda, dtype=dtype)
    k_new = torch.randn((B, T, KVH, D), device=cuda, dtype=dtype)
    v_new = torch.randn((B, T, KVH, D), device=cuda, dtype=dtype)
    tables = rng.permutation(B * MAXB + 1)[:B * MAXB].reshape(B, MAXB)
    prefix, take = np.asarray([0, 43]), np.asarray([40, 9])
    positions = prefix[:, None] + np.arange(T)[None]
    slots = np.full((B, T), -1, np.int64)
    for b in range(B):
        pos = positions[b, :take[b]]
        slots[b, :take[b]] = tables[b, pos // bs] * bs + pos % bs
    # The engine's order: the chunk's K/V go to the pages, then attention
    # reads prefix and chunk from there.
    att.write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), 1)
    args = (q, k, v, torch.from_numpy(tables.astype(np.int32)).to(cuda),
            torch.from_numpy(positions).to(cuda),
            torch.from_numpy((prefix + take).astype(np.int32)).to(cuda), 1)
    before = _launches(cached_prefill_attention, int8)
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(cached_prefill_attention, int8) == before + 1
    for b in range(B):
        assert_close(got[b, :take[b]], want[b, :take[b]])


# -- the bf16 kernels' own cases (split-K decode, tensor-core prefill) -------

def _tables(rng, B, MAXB, NB, ctx, bs, cuda):
    """Distinct shuffled pages per sequence; entries past each live range
    point at page 0, which the kernel must never read for that row."""
    t = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    for b, c in enumerate(ctx):
        t[b, -(-c // bs):] = 0
    return torch.from_numpy(t).to(cuda)


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("bs", [4, 64])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 32])
def test_split_decode_matches_plain(cuda, G, bs, D, int8):
    from production_stack_tpu_torch.ops.paged_attention import (
        ROW_TILE,
        split_pages,
        split_plan,
    )

    KVH, B = 2, 7
    MAXB = 1024 // bs
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = split_plan(B, KVH, MAXB, bs, row_tiles=-(-G // ROW_TILE),
                        sms=sms)
    assert splits > 1
    span = split_pages(MAXB, splits) * bs
    # At, one below and one above a split boundary; one token (more
    # splits than live pages); shorter than one split; the full table;
    # one split's length past the second boundary.
    ctx = [span, span - 1, span + 1, 1, span // 2, MAXB * bs,
           min(2 * span + 7, MAXB * bs)]
    rng = np.random.default_rng(G * 1000 + bs + D)
    NB = B * MAXB + 1
    k, v = _pool(cuda, torch.bfloat16, 2, NB, bs, KVH, D, seed=G + D,
                 int8=int8)
    q = torch.randn((B, G * KVH, D), device=cuda, dtype=torch.bfloat16)
    tables = _tables(rng, B, MAXB, NB, ctx, bs, cuda)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    before = _launches(paged_attention, int8)
    # Twice: the merge counters must be back at 0 after a launch.
    for _ in range(2):
        got = paged_attention(q, k, v, tables, cl, 1, scale=D ** -0.5)
        want = att.paged_attention_reference(q, k, v, tables, cl, 1,
                                             scale=D ** -0.5)
        torch.cuda.synchronize()
        assert_close(got, want)
    assert _launches(paged_attention, int8) == before + 2


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KVH", [(4, 4), (6, 2), (32, 8), (16, 2)])
def test_tensor_core_prefill_cases(cuda, H, KVH, D, int8):
    # Rows: an empty prefix with a full chunk; a prefix of 37, so the
    # causal diagonal crosses 64-key tiles mid-tile; a ragged short take
    # over a longer prefix. G = 3 pads each 64-row block with one zero
    # row; G = 8 splits a token's heads over two warps.
    rng = np.random.default_rng(H * D + int8)
    B, T, bs, MAXB = 3, 100, 16, 24
    prefix, take = np.asarray([0, 37, 130]), np.asarray([100, 61, 7])
    NB = B * MAXB + 1
    k, v = _pool(cuda, torch.bfloat16, 2, NB, bs, KVH, D, seed=H + D,
                 int8=int8)
    q = torch.randn((B, T, H, D), device=cuda, dtype=torch.bfloat16)
    k_new = torch.randn((B, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    v_new = torch.randn((B, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB)
    positions = prefix[:, None] + np.arange(T)[None]
    slots = np.full((B, T), -1, np.int64)
    for b in range(B):
        pos = positions[b, :take[b]]
        slots[b, :take[b]] = tables[b, pos // bs] * bs + pos % bs
    att.write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), 1)
    args = (q, k, v, torch.from_numpy(tables.astype(np.int32)).to(cuda),
            torch.from_numpy(positions).to(cuda),
            torch.from_numpy((prefix + take).astype(np.int32)).to(cuda), 1)
    before = _launches(cached_prefill_attention, int8)
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(cached_prefill_attention, int8) == before + 1
    for b in range(B):
        assert_close(got[b, :take[b]], want[b, :take[b]])


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (6, 2, 64)])
def test_batched_prefill_rows_with_a_padding_row(cuda, H, KVH, D, int8):
    """The engine's batched cached prefill (``_prefill_rows``): rows at one
    chunk bucket, two first-round rows with an empty prefix, one over a
    prefix of a whole chunk, and a padding row as the engine builds it
    (positions 0, total length 1, an all-zero table, no page writes).
    The live rows match the plain version; the padding row is finite."""
    rng = np.random.default_rng(D + int8)
    B, T, bs, MAXB = 4, 128, 16, 16
    prefix, take = np.asarray([0, 0, 128, 0]), np.asarray([128, 77, 128, 0])
    NB = B * MAXB + 1
    k, v = _pool(cuda, torch.bfloat16, 2, NB, bs, KVH, D, seed=7 * D,
                 int8=int8)
    q = torch.randn((B, T, H, D), device=cuda, dtype=torch.bfloat16)
    k_new = torch.randn((B, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    v_new = torch.randn((B, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB)
    tables[3] = 0
    positions = prefix[:, None] + np.arange(T)[None]
    positions[3] = 0
    slots = np.full((B, T), -1, np.int64)
    for b in range(3):
        pos = positions[b, :take[b]]
        slots[b, :take[b]] = tables[b, pos // bs] * bs + pos % bs
    att.write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), 1)
    totals = np.where(take > 0, prefix + take, 1).astype(np.int32)
    args = (q, k, v, torch.from_numpy(tables.astype(np.int32)).to(cuda),
            torch.from_numpy(positions).to(cuda),
            torch.from_numpy(totals).to(cuda), 1)
    before = _launches(cached_prefill_attention, int8)
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(cached_prefill_attention, int8) == before + 1
    for b in range(3):
        assert_close(got[b, :take[b]], want[b, :take[b]])
    assert bool(torch.isfinite(got[3]).all())


def _cached_rows(cuda, H, KVH, D, bs, MAXB, T, prefix, take, pad, seed,
                 int8=False):
    """Cached-prefill inputs of rows laid out as the engine builds them:
    row b's ``take[b]`` tokens written at ``prefix[b]``.., its positions
    ascending over the whole bucket ``T`` (the columns past the take
    write no page), its total length ``prefix + take``; the rows in
    ``pad`` are padding (positions 0, total 1, an all-zero table, no
    writes)."""
    rng = np.random.default_rng(seed)
    B = len(prefix)
    NB = B * MAXB + 1
    k, v = _pool(cuda, torch.bfloat16, 2, NB, bs, KVH, D, seed=seed,
                 int8=int8)
    q = torch.randn((B, T, H, D), device=cuda, dtype=torch.bfloat16)
    k_new = torch.randn((B, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    v_new = torch.randn((B, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    tables = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB)
    positions = np.asarray(prefix)[:, None] + np.arange(T)[None]
    slots = np.full((B, T), -1, np.int64)
    totals = np.asarray(prefix) + np.asarray(take)
    for b in range(B):
        if b in pad:
            tables[b], positions[b], totals[b] = 0, 0, 1
            continue
        pos = positions[b, :take[b]]
        slots[b, :take[b]] = tables[b, pos // bs] * bs + pos % bs
    att.write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), 1)
    return (q, k, v, torch.from_numpy(tables.astype(np.int32)).to(cuda),
            torch.from_numpy(positions).to(cuda),
            torch.from_numpy(totals.astype(np.int32)).to(cuda), 1)


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (6, 2, 64)])
def test_spec_verify_rows(cuda, H, KVH, D, int8):
    """The speculative verify at --speculative-num-tokens 4
    (``core.py::_launch_verify``): 8 rows of 4 query tokens, six at the end
    of 2,048-token contexts, one over a 5-token prefix and one padding row
    as the verify builds it for a free slot. The live rows match the plain
    version; the padding row is finite."""
    T, bs, MAXB = 4, 64, 32
    prefix = [2044] * 6 + [5, 0]
    args = _cached_rows(cuda, H, KVH, D, bs, MAXB, T, prefix, [T] * 8,
                        pad={7}, seed=3 * D + int8, int8=int8)
    before = _launches(cached_prefill_attention, int8)
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(cached_prefill_attention, int8) == before + 1
    assert_close(got[:7], want[:7])
    assert bool(torch.isfinite(got[7]).all())


@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (6, 2, 64)])
def test_draft_catch_up_rows_with_padding(cuda, H, KVH, D):
    """The drafter's catch-up (``core.py::_propose_draft_model``, phase A)
    over its pages in the model dtype: [4, 64] rows, a whole prompt's
    first 50 tokens, a steady-state row of 3 tokens past a 200-token
    context, a padding row, and a full bucket over a 64-token prefix. The
    live rows' real tokens match the plain version (the last of each is
    the one the drafter samples from); the padding row is finite."""
    T, bs, MAXB = 64, 16, 24
    prefix, take = [0, 200, 0, 64], [50, 3, 0, 64]
    args = _cached_rows(cuda, H, KVH, D, bs, MAXB, T, prefix, take,
                        pad={2}, seed=5 * D)
    before = cached_prefill_attention.launches
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert cached_prefill_attention.launches == before + 1
    for b in (0, 1, 3):
        assert_close(got[b, :take[b]], want[b, :take[b]])
    assert bool(torch.isfinite(got[2]).all())


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("H,KVH,D", [(32, 8, 128), (6, 2, 64)])
def test_constrained_draft_step_rows(cuda, H, KVH, D, int8):
    """The drafter's FSM-constrained draft step
    (``core.py::_draft_constrained``): [8, 32] rows at the smallest
    bucket, one live token a row in column 0 (six at the end of 2,048-token
    contexts, one past a 100-token context), its positions ascending over
    the whole row, and a row that drafts nothing this step (positions 0,
    total 1, an all-zero table). Each live token matches the plain
    version: with the JAX layout's zeros past column 0 the kernel would
    take the tile's key range from position 0 and hide the context from
    it. The idle row is finite."""
    T, bs, MAXB = 32, 64, 64
    prefix = [2047] * 6 + [100, 0]
    args = _cached_rows(cuda, H, KVH, D, bs, MAXB, T, prefix, [1] * 8,
                        pad={7}, seed=7 * D + int8, int8=int8)
    before = _launches(cached_prefill_attention, int8)
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(cached_prefill_attention, int8) == before + 1
    assert_close(got[:7, :1], want[:7, :1])
    assert bool(torch.isfinite(got[7]).all())


def test_unsupported_shapes_raise_not_fall_back(cuda):
    k, v = _pool(cuda, torch.float32, 1, 4, 4, 2, 48, seed=0)
    q = torch.randn((1, 4, 48), device=cuda)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    ctx = torch.ones((1,), dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q, k, v, tables, ctx, 0, scale=1.0)
    assert paged_attention.launches == before


def test_malformed_int8_pages_raise_not_fall_back(cuda):
    (kd, ks), (vd, vs) = _pool(cuda, torch.float32, 1, 4, 4, 2, 64, seed=1,
                               int8=True)
    q = torch.randn((1, 4, 64), device=cuda)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    ctx = torch.ones((1,), dtype=torch.int32, device=cuda)
    before = paged_attention.launches_int8
    for k, v, match in [((kd, ks.reshape(1, 4, 4, 2)), (vd, vs), "scales"),
                        ((kd, ks), vd.float(), "encoding"),
                        ((kd.float(), ks), (vd, vs), "int8")]:
        with pytest.raises((ValueError, TypeError), match=match):
            paged_attention(q, k, v, tables, ctx, 0, scale=1.0)
    assert paged_attention.launches_int8 == before


# -- page probes (csrc/page_probes.cu) ----------------------------------------

def _probe_inputs(cuda, dtype, B, MAXB, bs, KVH, D, G, ctx, seed):
    from production_stack_tpu_torch.probes import common

    k, v, bt, cl = common.make_inputs(
        B=B, MAXB=MAXB, NB=B * MAXB + 3, ctx=ctx, L=2, bs=bs, KVH=KVH, D=D,
        dtype=dtype, device=cuda, seed=seed)
    q = torch.randn((B, KVH * G, D), device=cuda, dtype=torch.bfloat16)
    return q, k, v, bt, cl


def _probe_close(got, want, tol):
    """Probe outputs are float32 sums of page values taken in another
    order (atomics): within ``tol`` of the largest |want|."""
    bar = tol * want.abs().max().clamp_min(1e-30)
    assert (got - want).abs().max().item() <= bar.item()


_PAGE_DTYPES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.mark.parametrize("dtype", _PAGE_DTYPES)
@pytest.mark.parametrize("P", [1, 2, 4])
def test_dma_only_matches_plain(cuda, dtype, P):
    from production_stack_tpu_torch.probes.kernel_dma_only import (
        dma_only,
        dma_only_reference,
    )

    name = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.int8: "int8"}[dtype]
    for ctx in ([1, 64, 100, 23], [23, 100, 64, 0], [64, 0, 1, 33]):
        _, k, v, bt, cl = _probe_inputs(cuda, dtype, 4, 8, 16, 2, 64, 1,
                                        ctx, seed=P)
        before = getattr(dma_only, "launches_" + name)
        got = dma_only(k, v, bt, cl, 1, pages_per_block=P)
        want = dma_only_reference(k, v, bt, cl, 1, pages_per_block=P)
        torch.cuda.synchronize()
        assert getattr(dma_only, "launches_" + name) == before + 1
        _probe_close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", _PAGE_DTYPES)
@pytest.mark.parametrize("mode", ["reads", "dots"])
@pytest.mark.parametrize("bs,KVH,D,G,P", [(16, 2, 64, 3, 2), (4, 4, 128, 6, 2),
                                         (8, 1, 32, 8, 4), (64, 8, 128, 8, 8),
                                         (8, 1, 64, 40, 8)])
def test_probe_strided_matches_plain(cuda, dtype, mode, bs, KVH, D, G, P):
    from production_stack_tpu_torch.probes.kernel_probe_strided import (
        probe_strided,
        probe_strided_reference,
    )

    MAXB = 8
    ctx = [1, P * bs, P * bs + 3, MAXB * bs]
    q, k, v, bt, cl = _probe_inputs(cuda, dtype, 4, MAXB, bs, KVH, D, G, ctx,
                                    seed=G)
    name = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.int8: "int8"}[dtype]
    attr = f"launches_{mode}_{name}"
    before = getattr(probe_strided, attr)
    got = probe_strided(q, k, v, bt, cl, 1, mode=mode, pages_per_block=P)
    want = probe_strided_reference(q, k, v, bt, cl, 1, mode=mode,
                                   pages_per_block=P)
    torch.cuda.synchronize()
    assert getattr(probe_strided, attr) == before + 1
    _probe_close(got, want, 1e-6 if mode == "reads" else 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("bs", [4, 64])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 16, 32])
def test_strided_probe_mma_matches_plain(cuda, G, bs, D, dtype):
    """The strided probe on the decode kernel's tiles (bf16 q over bf16 or
    int8 pages) at P 1/2/4/8/MAXB, contexts at, below and above a chunk
    boundary, one token and the full table, in both modes, two launches
    each, at the chip_smoke.py bars (1e-6 reads, 1e-5 dots)."""
    from production_stack_tpu_torch.probes.kernel_probe_strided import (
        probe_strided,
        probe_strided_reference,
        route,
    )

    KVH, MAXB = 2, 512 // bs
    q, k, v, bt, _ = _probe_inputs(cuda, dtype, 5, MAXB, bs, KVH, D, G,
                                   [1] * 5, seed=G * 100 + D + bs)
    assert route(q, k) == "mma"
    name = "bf16" if dtype == torch.bfloat16 else "int8"
    for P in (1, 2, 4, 8, MAXB):
        span = P * bs
        if G > span:
            continue  # a chunk must hold the G rows reads adds
        cl = torch.tensor([span, span - 1, span + 1, 1, MAXB * bs],
                          dtype=torch.int32, device=cuda)
        for mode in ("reads", "dots"):
            attr = f"launches_{mode}_{name}"
            before = getattr(probe_strided, attr)
            want = probe_strided_reference(q, k, v, bt, cl, 1, mode=mode,
                                           pages_per_block=P)
            for _ in range(2):
                got = probe_strided(q, k, v, bt, cl, 1, mode=mode,
                                    pages_per_block=P)
                torch.cuda.synchronize()
                _probe_close(got, want, 1e-6 if mode == "reads" else 1e-5)
            assert getattr(probe_strided, attr) == before + 2


def test_probes_raise_not_fall_back(cuda):
    from production_stack_tpu_torch.probes.kernel_dma_only import dma_only
    from production_stack_tpu_torch.probes.kernel_probe_strided import (
        probe_strided,
    )

    q, k, v, bt, cl = _probe_inputs(cuda, torch.float32, 2, 8, 8, 2, 48, 2,
                                    [9, 16], seed=0)
    before = (dma_only.launches_f32, probe_strided.launches_dots_f32)
    with pytest.raises(ValueError, match="head_dim"):
        dma_only(k, v, bt, cl, 0, pages_per_block=2)
    with pytest.raises(ValueError, match="head_dim"):
        probe_strided(q, k, v, bt, cl, 0, mode="dots", pages_per_block=2)
    with pytest.raises(ValueError, match="does not divide"):
        dma_only(k, v, bt, cl, 0, pages_per_block=3)
    assert (dma_only.launches_f32,
            probe_strided.launches_dots_f32) == before


# -- KV movement on the card --------------------------------------------------

def _kv_core(int8: bool, **over):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore

    cfg = EngineConfig(**dict(dict(
        model="tiny-llama", device="cuda", dtype="bfloat16", max_loras=0,
        max_model_len=256, block_size=16, num_blocks=24,
        kv_cache_dtype="int8" if int8 else "bf16"), **over))
    return EngineCore(cfg)


def _bits(x):
    leaves = x if isinstance(x, tuple) else (x,)
    return [t.cpu().contiguous().view(torch.uint8) for t in leaves]


def _same_bits(a, b):
    for x, y in zip(_bits(a), _bits(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("int8", [False, True], ids=["pages_bf16",
                                                     "pages_int8"])
def test_kv_extract_inject_round_trip_is_bit_equal(cuda, int8):
    """Pinned asynchronous copies both ways: random pages injected into
    one pool, extracted, injected into another (host relay and card to
    card), extracted again: every bit survives; a spill drained to the
    host store and restored into fresh blocks does too."""
    a, b, c = (_kv_core(int8), _kv_core(int8),
               _kv_core(int8, kv_offload_bytes=1 << 30))
    bs, n = 16, 5
    tokens = list(range(1, n * bs + 2))
    g = torch.Generator().manual_seed(0)
    mc = a.model_config
    shape = (n, mc.num_layers, bs, mc.num_kv_heads, mc.head_dim)

    def side():
        if not int8:
            return torch.randn(shape, generator=g).to(torch.bfloat16)
        return (torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8),
                torch.rand(shape[:2] + (bs * mc.num_kv_heads,),
                           generator=g))

    k0, v0 = side(), side()
    hashes, parent = [], a.kv_mgr.chain_root("")
    for i in range(n):
        parent = a.kv_mgr.allocator.chain_hash(
            parent, tuple(tokens[i * bs:(i + 1) * bs]))
        hashes.append(parent)
    assert a.inject_kv(hashes, k0, v0) == n
    first = a.extract_kv(tokens)
    assert first["hashes"] == hashes
    _same_bits(first["k"], k0)
    _same_bits(first["v"], v0)
    assert b.inject_kv(first["hashes"], first["k"], first["v"]) == n
    again = b.extract_kv(tokens)
    _same_bits(again["k"], k0)
    _same_bits(again["v"], v0)
    assert c.inject_from_core(a, tokens) == n
    moved = c.extract_kv(tokens)
    _same_bits(moved["k"], k0)
    # Spill c's blocks to its host store (asynchronous, pinned) and
    # restore them into other blocks right away.
    alloc = c.kv_mgr.allocator
    c._pending_offload = [(h, alloc.prefix_map[h]) for h in hashes]
    c._drain_offload()
    fresh = [alloc.allocate() for _ in hashes]
    assert c._restore_blocks(list(zip(fresh, hashes)))
    k_r, v_r, ready = c._pages_to_host(fresh)
    assert ready is not None  # an asynchronous copy on the card
    ready()
    _same_bits(k_r, k0)
    _same_bits(v_r, v0)
    for core in (a, b, c):
        core.stop()


# -- OPT-125m shapes and the other architectures on the card ----------------

@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("ctx", [[2048] * 8, [2048, 1, 37, 2000, 1500, 64,
                                             65, 1024]],
                         ids=["8x2048", "ragged"])
def test_opt125m_decode_matches_plain(cuda, ctx, int8):
    """facebook/opt-125m's decode: 12 heads of 64 over 12 kv heads (a head
    group of one: one live row of the 16-row MMA tile), 64-token pages,
    tables of 32 pages, the split plan's 96 blocks a wave."""
    H = KVH = 12
    D, bs, MAXB, B = 64, 64, 32, len(ctx)
    rng = np.random.default_rng(sum(ctx) + int8)
    NB = B * MAXB + 1
    k, v = _pool(cuda, torch.bfloat16, 2, NB, bs, KVH, D, seed=64 + int8,
                 int8=int8)
    q = torch.randn((B, H, D), device=cuda, dtype=torch.bfloat16)
    tables = _tables(rng, B, MAXB, NB, ctx, bs, cuda)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    before = _launches(paged_attention, int8)
    got = paged_attention(q, k, v, tables, cl, 1, scale=D ** -0.5)
    want = att.paged_attention_reference(q, k, v, tables, cl, 1,
                                         scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(paged_attention, int8) == before + 1
    assert_close(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["pages_q", "pages_int8"])
@pytest.mark.parametrize("prefix,take", [(1024, 1024), (1024, 877), (0, 1024),
                                         (37, 300)])
def test_opt125m_cached_prefill_matches_plain(cuda, prefix, take, int8):
    """facebook/opt-125m's cached prefill at the 1,024 chunk bucket: a
    chunk over a 1,024-token prefix, the second chunk of a 1,901-token
    prompt (padded columns discarded), a first chunk, and a diagonal
    crossing a key tile; 12/12 heads of 64 (query tiles of one head)."""
    H = KVH = 12
    D, bs, MAXB, T = 64, 64, 32, 1024
    rng = np.random.default_rng(prefix + take + int8)
    NB = MAXB + 1
    k, v = _pool(cuda, torch.bfloat16, 2, NB, bs, KVH, D, seed=65 + int8,
                 int8=int8)
    q = torch.randn((1, T, H, D), device=cuda, dtype=torch.bfloat16)
    k_new = torch.randn((1, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    v_new = torch.randn((1, T, KVH, D), device=cuda, dtype=torch.bfloat16)
    tables = rng.permutation(NB)[:MAXB].reshape(1, MAXB)
    positions = prefix + np.arange(T)[None]
    slots = np.full((1, T), -1, np.int64)
    pos = positions[0, :take]
    slots[0, :take] = tables[0, pos // bs] * bs + pos % bs
    att.write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), 1)
    args = (q, k, v, torch.from_numpy(tables.astype(np.int32)).to(cuda),
            torch.from_numpy(positions).to(cuda),
            torch.tensor([prefix + take], dtype=torch.int32, device=cuda), 1)
    before = _launches(cached_prefill_attention, int8)
    got = cached_prefill_attention(*args, scale=D ** -0.5)
    want = att._context_prefill_reference(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert _launches(cached_prefill_attention, int8) == before + 1
    assert_close(got[0, :take], want[0, :take])


@pytest.mark.parametrize("model", ["tiny-mixtral", "tiny-opt"])
def test_float32_forward_on_the_card_matches_the_cpu(cuda, model):
    """One model's prefill, cached prefill and decode forwards at float32
    on the card (the kernels' f32 mode) against the same forwards on the
    CPU (the plain versions), on the same parameters: logits at 1e-4."""
    from production_stack_tpu_torch.models import build_model
    from production_stack_tpu_torch.models import get_model_config

    cfg = get_model_config(model).replace(dtype="float32")
    init, apply = build_model(cfg)
    params = init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    cpu_params = _to(params, "cpu")
    bs, NB = 8, 16
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads, cfg.head_dim)
    pools = {d: (torch.zeros(shape, device=d), torch.zeros(shape, device=d))
             for d in (cuda, "cpu")}
    tables = np.stack([np.arange(8), np.arange(8, 16)]).astype(np.int32)
    rng = np.random.default_rng(0)

    def forward(tokens, positions, take, context, mode, last=None):
        slots = np.full(positions.shape, -1, np.int64)
        for b, n in enumerate(take):
            p = positions[b, :n]
            slots[b, :n] = tables[b, p // bs] * bs + p % bs
        out = {}
        for dev, prm in ((cuda, params), ("cpu", cpu_params)):
            def t(x):
                return torch.from_numpy(np.asarray(x)).to(dev)
            logits, _ = apply(
                prm, cfg, t(tokens), t(positions), pools[dev],
                torch.from_numpy(slots), t(tables), t(context),
                t(np.asarray(take, np.int32)), mode=mode,
                last_token=None if last is None else t(last))
            out[dev] = logits.cpu()
        torch.testing.assert_close(out[cuda], out["cpu"], rtol=1e-4,
                                   atol=1e-4)

    T = 32
    take = np.asarray([32, 21], np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    forward(rng.integers(0, cfg.vocab_size, (2, T)), pos, take, take,
            "prefill")
    pos2 = (take[:, None] + np.arange(16)[None]).astype(np.int32)
    take2 = np.asarray([16, 9], np.int32)
    forward(rng.integers(0, cfg.vocab_size, (2, 16)), pos2, take2,
            take + take2, "prefill_cached", last=take2 - 1)
    pos3 = (take + take2)[:, None].astype(np.int32)
    forward(rng.integers(0, cfg.vocab_size, (2, 1)), pos3, [1, 1],
            pos3[:, 0] + 1, "decode")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("quantization", [None, "int8"],
                         ids=["weights_bf16", "weights_int8"])
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path, quantization):
    """A bf16 tree drawn on the card, written as a two-shard safetensors
    checkpoint by the standard-library writer and served from the
    directory: every leaf lands on the card bit for bit (under int8 the
    loaded tree is ``quantize_loaded`` of the written one, codes and
    scales), and a drawn leaf the file carries is gone."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.models import build_model
    from production_stack_tpu_torch.models import get_model_config
    from production_stack_tpu_torch.models.quantize import quantize_loaded
    from production_stack_tpu_torch.models.weights import (
        read_safetensors,
        save_checkpoint,
    )

    cfg = get_model_config("tiny-llama")
    init, _ = build_model(cfg)
    tree = init(cfg, torch.Generator(device=cuda).manual_seed(3), cuda)
    path = str(tmp_path / "ckpt")
    save_checkpoint(tree, cfg, path, shards=2)
    shard = sorted((tmp_path / "ckpt").glob("*.safetensors"))[0]
    for name, t in read_safetensors(str(shard)):
        assert t.dtype == torch.bfloat16, name
    # The engine quantizes on the host, so the check does too.
    want = tree if quantization is None else quantize_loaded(
        _to(tree, "cpu"), "llama")
    core = EngineCore(EngineConfig(
        model=path, device="cuda", dtype="bfloat16", max_loras=2,
        max_model_len=256, block_size=16, num_blocks=24,
        quantization=quantization))
    assert core.params["lora"]["wq_a"].device.type == "cuda"

    def flat(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, v

    got = {k: v for k, v in flat(core.params) if not k.startswith("lora.")}
    want = dict(flat(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].device.type == "cuda", name
        assert got[name].dtype == w.dtype, name
        _same_bits(got[name], w.to(cuda))
