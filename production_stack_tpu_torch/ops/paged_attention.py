"""Paged decode attention: wrapper of the CUDA kernel in
``csrc/paged_attention.cu``.

Replaces ``production_stack_tpu/ops/pallas_paged_attention.py::
pallas_paged_attention``. On a CPU tensor the wrapper runs the plain
version, ``ops/attention.py::paged_attention_reference``; on a CUDA
tensor it launches the kernel or raises — it never falls back.
``paged_attention.launches`` counts kernel launches (and nothing else),
so a run can show that its decode steps went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.attention import (
    _require_plain_pages,
    paged_attention_reference,
)

KERNEL = "paged_attention"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k_pages, v_pages, block_tables, context_lens,
                 layer: int) -> None:
    """Raise on anything the kernel does not take (it is never skipped)."""
    k_pages = _require_plain_pages(k_pages)
    v_pages = _require_plain_pages(v_pages)
    if not q.is_cuda:
        raise ValueError("paged_attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: unsupported dtype {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: pages and q must share a dtype")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 5:
        raise ValueError("paged_attention: pages must be [L, NB, bs, KVH, D]")
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
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention: pages must be contiguous")
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("paged_attention: pages must be 16-byte aligned")


def paged_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [L, NB, bs, KVH, D]
    v_pages: torch.Tensor,
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
    check_inputs(q, k_pages, v_pages, block_tables, context_lens, layer)
    B, H, D = q.shape
    L, NB, bs, KVH, _ = k_pages.shape
    qs = (q * scale).to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ctx = context_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qs)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            _ptr(qs), _ptr(k_pages), _ptr(v_pages), _ptr(bt), _ptr(ctx),
            _ptr(out), B, H, KVH, D, NB, bs, bt.shape[1], layer,
            _DTYPES[q.dtype], ctypes.c_void_p(stream))
    _build.check(lib, rc, KERNEL)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
