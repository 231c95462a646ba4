"""A plain model of the strided probe's tensor-core body
(``strided_probe_mma_kernel`` in ``csrc/page_probes.cu``) held against the
probe's plain version, and the CPU side of that body's routing, its bytes
and the decode decomposition that ``chip_smoke.py`` prints.

The kernel cannot run here (no card, no nvcc), so its arithmetic is
modelled in torch: per chunk of ``P * bs`` keys, 64-key tiles, 16 keys a
warp, bf16 q and pages (int8 codes are exact in bf16), S = q . K^T in
float32, S . V taken as two bf16 terms (``bf16(S)`` and ``bf16(S -
bf16(S))``) with float32 sums, and the four warps' partials added. The
model must meet the bars that ``chip_smoke.py`` holds the kernel to
(``PROBE_DOTS_TOL`` 1e-5 and ``PROBE_GATHER_TOL`` 1e-6 of the largest
|o|); one bf16 term of S, the decode kernel's P . V, must not.
"""

import importlib.util
import os

import pytest
import torch

from production_stack_tpu_torch.probes import common
from production_stack_tpu_torch.probes import kernel_probe_strided as kst

DOTS_TOL, READS_TOL = 1e-5, 1e-6  # chip_smoke.py's probe bars
KEY_TILE, WARP_KEYS = 64, 16  # the decode kernel's tile and warp slice


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mma_model(q, k_pages, v_pages, block_tables, context_lens, layer, *,
              mode, pages_per_block, two_terms=True):
    """One layer's ``o [B, KVH*G, D]`` float32 as the tensor-core body
    computes it (see the module docstring)."""
    B, MAXB = block_tables.shape
    _, _, bs, KVH, D = k_pages.shape
    G = q.shape[1] // KVH
    P = pages_per_block
    span, nc = P * bs, MAXB // P
    live = common.live_chunks(context_lens, span, nc)  # [B, nc]
    pages = block_tables.to(torch.int64).reshape(B, nc, P)
    # The staged bf16 tiles: bf16 pages as they are, int8 codes times a
    # unit scale (exact), then widened to float32 for the model's sums.
    kc = k_pages[layer][pages].to(torch.bfloat16).float().reshape(
        B, nc, span, KVH, D)
    vc = v_pages[layer][pages].to(torch.bfloat16).float().reshape(
        B, nc, span, KVH, D)
    if mode == "reads":
        o = kc[:, :, :G] + vc[:, :, :G]  # [B, nc, G, KVH, D]
        o = torch.where(live[:, :, None, None, None], o, 0.0).sum(1)
        return o.transpose(1, 2).reshape(B, KVH * G, D)
    # Zero rows past the chunk fill its last tile, as the copies do.
    n_tiles = -(-span // KEY_TILE)
    pad = n_tiles * KEY_TILE - span
    kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
    shape = (B, nc, n_tiles, KEY_TILE // WARP_KEYS, WARP_KEYS, KVH, D)
    kw, vw = kc.reshape(shape), vc.reshape(shape)  # [B, nc, tile, warp, key]
    qf = q.to(torch.bfloat16).float().reshape(B, KVH, G, D)
    s = torch.einsum("bhgd,bctwkhd->bctwhgk", qf, kw)
    hi = s.to(torch.bfloat16).float()
    terms = [hi, (s - hi).to(torch.bfloat16).float()] if two_terms else [hi]
    o = torch.zeros((B, nc, KEY_TILE // WARP_KEYS, KVH, G, D))
    for tile in range(n_tiles):  # each warp's float32 sum, tile by tile
        for t in terms:
            o += torch.einsum("bcwhgk,bcwkhd->bcwhgd", t[:, :, tile],
                              vw[:, :, tile])
    o = o.sum(2)  # the warps' partials added
    o = torch.where(live[:, :, None, None, None], o, 0.0).sum(1)
    return o.reshape(B, KVH * G, D)


def _err_over_bar(got, want, tol):
    return ((got - want).abs().max() / (tol * want.abs().max())).item()


def _inputs(dtype, B, MAXB, bs, KVH, D, G, ctx, seed, L=2):
    k, v, bt, cl = common.make_inputs(
        B=B, MAXB=MAXB, NB=B * MAXB + 3, ctx=ctx, L=L, bs=bs, KVH=KVH, D=D,
        dtype=dtype, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((B, KVH * G, D), generator=g, dtype=torch.bfloat16)
    return q, k, v, bt, cl


_MAXB, _KVH, _D = 16, 2, 32
_CASES = [(P, bs, G) for P in (1, 2, 8) for bs in (4, 64)
          for G in (1, 4, 8, 16, 24) if G <= P * bs]


@pytest.mark.parametrize("mode", ["reads", "dots"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_model_meets_the_probe_bars(dtype, mode):
    """Every (P, bs, G) of ``_CASES`` (P 1/2/8, bs 4/64, G 1/4/8/16/24 up
    to a chunk's keys), each over ragged contexts: one token, a context
    inside the last page of the second chunk, the full table, one past a
    chunk boundary."""
    tol = DOTS_TOL if mode == "dots" else READS_TOL
    over = {}
    for P, bs, G in _CASES:
        span = P * bs
        ctx = [1, min(2 * span - bs // 2, _MAXB * bs), _MAXB * bs, span + 1]
        q, k, v, bt, cl = _inputs(dtype, 4, _MAXB, bs, _KVH, _D, G, ctx,
                                  seed=P * 1000 + bs + G)
        want = kst.probe_strided_reference(q, k, v, bt, cl, 1, mode=mode,
                                           pages_per_block=P)
        got = mma_model(q, k, v, bt, cl, 1, mode=mode, pages_per_block=P)
        over[P, bs, G] = _err_over_bar(got, want, tol)
    assert max(over.values()) <= 1.0, over


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_one_bf16_term_of_s_misses_the_dots_bar(dtype):
    """At chip_smoke.py's 8 x 2,048 decode case (one layer, the decode
    plan's P = 4, 256-key chunks, G = 4, D = 128), the two-term S . V meets
    the 1e-5 bar and the decode kernel's one bf16 term of S does not."""
    shape = dict(_chip_smoke().DECODE_PROBE_SHAPE)
    G = shape.pop("G")
    shape.update(L=1)
    k, v, bt, cl = common.make_inputs(dtype=dtype, device="cpu", seed=0,
                                      **shape)
    g = torch.Generator().manual_seed(1)
    q = torch.randn((shape["B"], shape["KVH"] * G, shape["D"]), generator=g,
                    dtype=torch.bfloat16)
    want = kst.probe_strided_reference(q, k, v, bt, cl, 0, mode="dots",
                                       pages_per_block=4)
    two = mma_model(q, k, v, bt, cl, 0, mode="dots", pages_per_block=4)
    one = mma_model(q, k, v, bt, cl, 0, mode="dots", pages_per_block=4,
                    two_terms=False)
    assert _err_over_bar(two, want, DOTS_TOL) <= 0.5
    assert _err_over_bar(one, want, DOTS_TOL) > 10.0


@pytest.mark.parametrize("q_dtype,page_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "mma"),
    (torch.bfloat16, torch.int8, "mma"),
    (torch.bfloat16, torch.float32, "f32"),
    (torch.float32, torch.bfloat16, "f32"),
    (torch.float32, torch.int8, "f32"),
    (torch.float32, torch.float32, "f32"),
    (torch.float16, torch.bfloat16, "f32"),
])
def test_route_takes_the_tensor_cores_only_for_bf16_q(q_dtype, page_dtype,
                                                       route):
    """bf16 q over bf16 or int8 pages takes the decode kernel's tiles;
    float32 q or pages (and any other q) take the f32 check mode."""
    q = torch.zeros((2, 4, 32), dtype=q_dtype)
    k = torch.zeros((1, 4, 8, 2, 32), dtype=page_dtype)
    assert kst.route(q, k) == route


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_work_counts_the_codes_of_int8_pages_only(q_dtype):
    """The bound is the function's bytes: an int8 page counts its codes
    on either route, not the unit scales the mma route stages beside
    them."""
    L, bs, KVH, D, G, P = 2, 8, 2, 32, 4, 2
    q, k, _, bt, cl = _inputs(torch.int8, 2, 8, bs, KVH, D, G, [37, 9],
                              seed=3, L=L)
    q = q.to(q_dtype)
    n = common.pages_read(cl, 8, bs, P)  # 3 + 1 chunks of 2 pages
    assert n == 8
    nbytes, flops = kst.work(q, k, bt, cl, "dots", P)
    assert nbytes == L * (2 * n * bs * KVH * D
                          + q.numel() * (q.element_size() + 4))
    assert flops == 4 * KVH * G * D * n * bs * L


def test_unit_scales_are_two_tensors_of_ones_kept_for_the_last_shape():
    k = torch.zeros((2, 5, 4, 3, 32), dtype=torch.int8)
    ks, vs = common.unit_scales(k)
    assert ks.shape == vs.shape == (2, 5, 12)
    assert ks.dtype == torch.float32 and bool((ks == 1).all())
    assert ks.data_ptr() != vs.data_ptr()
    assert common.unit_scales(k)[0] is ks
    other = common.unit_scales(torch.zeros((1, 5, 4, 3, 32),
                                           dtype=torch.int8))
    assert other[0].shape == (1, 5, 12)
    assert common.unit_scales(k)[0] is not ks  # one shape is kept


@pytest.mark.parametrize("B,KVH,MAXB,bs,H,ctx,plan", [
    (8, 8, 32, 64, 32, 2048,  # 8 x 2,048: 6 splits with keys, 8 chunks
     {"splits": 6, "P": 6, "floor_P": 4, "grids_match": False}),
    (16, 8, 64, 64, 64, 3000,  # the JAX shapes: 3 and 3
     {"splits": 3, "P": 22, "floor_P": 16, "grids_match": True}),
    (4, 8, 64, 64, 64, [3000, 100, 3000, 3000],  # 25 splits, 37 chunks
     {"splits": 12, "P": 6, "floor_P": 4, "grids_match": False}),
])
def test_decode_plan_of_the_probe_shapes(B, KVH, MAXB, bs, H, ctx, plan):
    """The decode kernel's split at the probe phase's two shapes on a
    132-SM card, the P the probes split it at, and whether the two grids
    have as many blocks with keys."""
    assert _chip_smoke().decode_plan(B, KVH, MAXB, bs, H, sms=132,
                                     ctx=ctx) == plan


@pytest.mark.parametrize("grids_match", [True, False])
def test_decode_decomposition_arithmetic(grids_match):
    rows = {"dma_only_P4": {"dma_only_all_L_s": 1.0e-3},
            "reads_P4": {"all_L_s": 1.25e-3},
            "dots_P4": {"all_L_s": 1.5e-3},
            "reads_P32": {"all_L_s": 9.0},
            "decode_kernel_all_L_s": 1.75e-3}
    out = _chip_smoke().decode_decomposition(
        rows, {"splits": 6, "P": 6, "floor_P": 4, "grids_match": grids_match})
    assert out["P"] == 4 and out["plan_pages"] == 6 and out["splits"] == 6
    assert out["decode_kernel_s"] == 1.75e-3
    assert out["gather_floor_s"] == 1.0e-3
    assert out["ring_gather_s"] == 1.25e-3
    assert out["products_s"] == pytest.approx(0.25e-3)
    assert out["ring_gather_over_floor"] == pytest.approx(1.25)
    assert out["decode_over_floor"] == pytest.approx(1.75)
    if grids_match:
        assert out["softmax_merge_s"] == pytest.approx(0.25e-3)
        assert "softmax_merge_note" not in out
    else:  # decode minus dots would compare two different grids
        assert out["softmax_merge_s"] is None
        assert "P=4" in out["softmax_merge_note"]
