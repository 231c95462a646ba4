"""Paged decode attention: wrapper of the CUDA kernel in
``csrc/paged_attention.cu``.

Replaces ``production_stack_tpu/ops/pallas_paged_attention.py::
pallas_paged_attention`` in both of its modes: pages in q's dtype, and
int8 ``(data, scales)`` pages (``quantized=True`` there), which the
kernel dequantizes as it loads them. On a CPU tensor the wrapper runs
the plain version, ``ops/attention.py::paged_attention_reference``; on a
CUDA tensor it launches the kernel or raises — it never falls back.
``paged_attention.launches`` counts launches over pages in q's dtype and
``paged_attention.launches_int8`` launches over int8 pages (and nothing
else), so a run can show that its decode steps went through the kernel
in the mode it configured.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.attention import (
    kv_page_data,
    paged_attention_reference,
)

KERNEL = "paged_attention"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.paged_attention_launch
    # q, k, v, k_scales, v_scales, tables, lens, out; 10 ints; the stream.
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def page_operands(what: str, q, k_pages, v_pages):
    """Check the page operands of a kernel launch against q and return
    ``(k_data, v_data, k_scales, v_scales)``: the scales are None for
    pages in q's dtype, and the float32 ``[L, NB, bs*KVH]`` halves of
    int8 ``(data, scales)`` pairs otherwise. Raises on anything the
    kernels do not take."""
    quantized = isinstance(k_pages, tuple)
    if quantized != isinstance(v_pages, tuple):
        raise TypeError(f"{what}: k and v pages must share an encoding")
    k_data, v_data = kv_page_data(k_pages), kv_page_data(v_pages)
    tensors = [("k_pages", k_data), ("v_pages", v_data)]
    if quantized:
        k_scales, v_scales = k_pages[1], v_pages[1]
        tensors += [("k_scales", k_scales), ("v_scales", v_scales)]
    else:
        k_scales = v_scales = None
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if k_data.shape != v_data.shape or k_data.dim() != 5:
        raise ValueError(f"{what}: pages must be [L, NB, bs, KVH, D]")
    if quantized:
        L, NB, bs, KVH, _ = k_data.shape
        for t in (k_data, v_data):
            if t.dtype != torch.int8:
                raise TypeError(f"{what}: quantized pages must be int8")
        for t in (k_scales, v_scales):
            if t.dtype != torch.float32 or t.shape != (L, NB, bs * KVH):
                raise ValueError(
                    f"{what}: scales must be float32 [L, NB, bs*KVH]")
    elif k_data.dtype != q.dtype or v_data.dtype != q.dtype:
        raise TypeError(f"{what}: pages and q must share a dtype")
    return k_data, v_data, k_scales, v_scales


def check_inputs(q, k_pages, v_pages, block_tables, context_lens,
                 layer: int):
    """Raise on anything the kernel does not take (it is never skipped);
    returns :func:`page_operands`."""
    if not q.is_cuda:
        raise ValueError("paged_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: unsupported dtype {q.dtype}")
    for name, t in (("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    pages = page_operands("paged_attention", q, k_pages, v_pages)
    k_pages = pages[0]
    B, H, D = q.shape
    L, NB, bs, KVH, Dp = k_pages.shape
    if Dp != D or D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} not in {HEAD_DIMS}")
    if H % KVH != 0:
        raise ValueError("paged_attention: H must be a multiple of KVH")
    if not 0 <= layer < L:
        raise ValueError(f"paged_attention: layer {layer} outside [0, {L})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("paged_attention: block_tables must be [B, MAXB]")
    if context_lens.shape != (B,):
        raise ValueError("paged_attention: context_lens must be [B]")
    return pages


def paged_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages,  # [L, NB, bs, KVH, D], or int8 (data, scales) pairs
    v_pages,
    block_tables: torch.Tensor,  # [B, MAXB] page ids
    context_lens: torch.Tensor,  # [B] tokens in the pages, this one included
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Decode attention over the paged pool. Returns [B, H, D] in q's
    dtype. q is pre-scaled and cast back to its dtype before the kernel,
    as the TPU kernel did."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pages, v_pages, block_tables, context_lens, layer,
            scale=scale)
    layer = int(layer)
    k_data, v_data, k_scales, v_scales = check_inputs(
        q, k_pages, v_pages, block_tables, context_lens, layer)
    quantized = k_scales is not None
    B, H, D = q.shape
    L, NB, bs, KVH, _ = k_data.shape
    qs = (q * scale).to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qs)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            _ptr(qs), _ptr(k_data), _ptr(v_data), _ptr(k_scales),
            _ptr(v_scales), _ptr(bt), _ptr(ctx), _ptr(out), B, H, KVH, D,
            NB, bs, bt.shape[1], layer, _DTYPES[q.dtype], int(quantized),
            ctypes.c_void_p(stream))
    _build.check(lib, rc, KERNEL)
    if quantized:
        paged_attention.launches_int8 += 1
    else:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.launches_int8 = 0
