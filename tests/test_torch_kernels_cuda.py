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
