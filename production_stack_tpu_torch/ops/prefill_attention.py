"""Cached-prefill attention: wrapper of the CUDA kernel in
``csrc/prefill_attention.cu``.

Replaces ``production_stack_tpu/ops/pallas_prefill_attention.py::
pallas_prefill_attention``, in both of its modes (pages in q's dtype, and
int8 ``(data, scales)`` pages dequantized as they load). The TPU version
split the work: its kernel
streamed the live prefix pages into unnormalised ``(acc, m, l)`` and XLA
did the fresh-suffix attention and the flash merge. Here one kernel
streams the whole visible context from the pages (the chunk's own K/V
were written there one op earlier), so no ``[T, T]`` score temporary and
no merge pass exist.

With int8 pages the chunk's own K/V are read back from the pages they
were just quantized into, as the plain version does; the Pallas kernel
attended them at full precision from ``k_new``/``v_new`` instead, so
under int8 the two differ by one quantization step on the chunk's keys.

On a CPU tensor the wrapper runs the plain version,
``ops/attention.py::_context_prefill_reference``, with the same
signature; on a CUDA tensor it launches the kernel or raises.
``cached_prefill_attention.launches`` counts launches over pages in q's
dtype, ``cached_prefill_attention.launches_int8`` launches over int8
pages, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops.attention import (
    _context_prefill_reference,
)
from production_stack_tpu_torch.ops.paged_attention import (
    HEAD_DIMS,
    _DTYPES,
    _ptr,
    launch_shape,
    page_operands,
)

KERNEL = "prefill_attention"
MAX_GROUP = 64  # query heads per kv head (the f32 mode's 64-row blocks)


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.prefill_attention_launch
    # q, k, v, k_scales, v_scales, tables, positions, totals, out;
    # 11 ints; the stream.
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k_pages, v_pages, block_tables, positions, total_lens,
                 layer: int):
    """Raise on anything the kernel does not take (it is never skipped);
    returns ``paged_attention.page_operands``."""
    if not q.is_cuda:
        raise ValueError("cached prefill kernel needs CUDA tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"cached prefill: unsupported dtype {q.dtype}")
    for name, t in (("block_tables", block_tables),
                    ("positions", positions), ("total_lens", total_lens)):
        if t.device != q.device:
            raise ValueError(f"cached prefill: {name} on {t.device}, "
                             f"q on {q.device}")
    pages = page_operands("cached prefill", q, k_pages, v_pages)
    k_pages = pages[0]
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
    return pages


def cached_prefill_attention(
    q: torch.Tensor,  # [B, T, H, D] the chunk's query tokens
    k_pages,  # [L, NB, bs, KVH, D] or int8 (data, scales), chunk written
    v_pages,
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
    k_data, v_data, k_scales, v_scales = check_inputs(
        q, k_pages, v_pages, block_tables, positions, total_lens, layer)
    quantized = k_scales is not None
    B, T, H, D = q.shape
    L, NB, bs, KVH, _ = k_data.shape
    qs = (q * scale).to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    total = total_lens.to(torch.int32).contiguous()
    out = torch.empty_like(qs)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.prefill_attention_launch(
            _ptr(qs), _ptr(k_data), _ptr(v_data), _ptr(k_scales),
            _ptr(v_scales), _ptr(bt), _ptr(pos), _ptr(total), _ptr(out), B,
            T, H, KVH, D, NB, bs, bt.shape[1], layer, _DTYPES[q.dtype],
            int(quantized), ctypes.c_void_p(stream))
    _build.check(lib, rc, KERNEL)
    if quantized:
        cached_prefill_attention.launches_int8 += 1
    else:
        cached_prefill_attention.launches += 1
    shape = launch_shape(H, KVH, D, q.dtype, quantized)
    cached_prefill_attention.launches_by_shape[shape] = (
        cached_prefill_attention.launches_by_shape.get(shape, 0) + 1)
    return out


cached_prefill_attention.launches = 0
cached_prefill_attention.launches_int8 = 0
# Launches by "H{H}/KVH{KVH}/D{D}/<q dtype>/<page dtype>": a
# tensor-parallel rank's heads.
cached_prefill_attention.launches_by_shape = {}
