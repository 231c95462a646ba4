"""Cached-prefill attention: wrapper of the CUDA kernel in
``csrc/prefill_attention.cu``.

Replaces ``production_stack_tpu/ops/pallas_prefill_attention.py::
pallas_prefill_attention``. The TPU version split the work: its kernel
streamed the live prefix pages into unnormalised ``(acc, m, l)`` and XLA
did the fresh-suffix attention and the flash merge. Here one kernel
streams the whole visible context from the pages (the chunk's own K/V
were written there one op earlier), so no ``[T, T]`` score temporary and
no merge pass exist.

On a CPU tensor the wrapper runs the plain version,
``ops/attention.py::_context_prefill_reference``, with the same
signature; on a CUDA tensor it launches the kernel or raises. ``cached_prefill_attention.launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.attention import (
    _context_prefill_reference,
    _require_plain_pages,
)
from production_stack_tpu_torch.ops.paged_attention import (
    HEAD_DIMS,
    _DTYPES,
    _ptr,
)

KERNEL = "prefill_attention"
MAX_GROUP = 64  # query heads per kv head one block holds (its 64 rows)


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.prefill_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k_pages, v_pages, block_tables, positions, total_lens,
                 layer: int) -> None:
    """Raise on anything the kernel does not take (it is never skipped)."""
    k_pages = _require_plain_pages(k_pages)
    v_pages = _require_plain_pages(v_pages)
    if not q.is_cuda:
        raise ValueError("cached prefill kernel needs CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"cached prefill: unsupported dtype {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("positions", positions), ("total_lens", total_lens)):
        if t.device != q.device:
            raise ValueError(f"cached prefill: {name} on {t.device}, "
                             f"q on {q.device}")
    for t in (k_pages, v_pages):
        if t.dtype != q.dtype:
            raise TypeError("cached prefill: pages and q must share a dtype")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 5:
        raise ValueError("cached prefill: pages must be [L, NB, bs, KVH, D]")
    B, T, H, D = q.shape
    L, NB, bs, KVH, Dp = k_pages.shape
    if Dp != D or D not in HEAD_DIMS:
        raise ValueError(f"cached prefill: head_dim {D} not in {HEAD_DIMS}")
    if H % KVH != 0 or H // KVH > MAX_GROUP:
        raise ValueError(
            f"cached prefill: H/KVH must be a whole number <= {MAX_GROUP}")
    if not 0 <= layer < L:
        raise ValueError(f"cached prefill: layer {layer} outside [0, {L})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("cached prefill: block_tables must be [B, MAXB]")
    if positions.shape != (B, T):
        raise ValueError("cached prefill: positions must be [B, T]")
    if total_lens.shape != (B,):
        raise ValueError("cached prefill: total_lens must be [B]")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("cached prefill: pages must be contiguous")
    for t in (k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("cached prefill: pages must be 16-byte aligned")


def cached_prefill_attention(
    q: torch.Tensor,  # [B, T, H, D] the chunk's query tokens
    k_pages: torch.Tensor,  # [L, NB, bs, KVH, D], the chunk already written
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MAXB]
    positions: torch.Tensor,  # [B, T] absolute, ascending along a row
    total_lens: torch.Tensor,  # [B] context length incl. this chunk
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Attention of a prefill chunk over its context in the pages: the
    query at position p sees keys 0..p below total_len. Returns
    [B, T, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return _context_prefill_reference(
            q, k_pages, v_pages, block_tables, positions, total_lens, layer,
            scale=scale)
    layer = int(layer)
    check_inputs(q, k_pages, v_pages, block_tables, positions, total_lens,
                 layer)
    B, T, H, D = q.shape
    L, NB, bs, KVH, _ = k_pages.shape
    qs = (q * scale).to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    total = total_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qs)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.prefill_attention_launch(
            _ptr(qs), _ptr(k_pages), _ptr(v_pages), _ptr(bt), _ptr(pos),
            _ptr(total), _ptr(out), B, T, H, KVH, D, NB, bs, bt.shape[1],
            layer, _DTYPES[q.dtype], ctypes.c_void_p(stream))
    _build.check(lib, rc, KERNEL)
    cached_prefill_attention.launches += 1
    return out


cached_prefill_attention.launches = 0
