"""Paged decode attention: wrapper of the CUDA kernel in
``csrc/paged_attention.cu``.

Replaces ``production_stack_tpu/ops/pallas_paged_attention.py::
pallas_paged_attention`` in both of its modes: pages in q's dtype, and
int8 ``(data, scales)`` pages (``quantized=True`` there), which the
kernel dequantizes as it loads them. On a CPU tensor the wrapper runs
the plain version, ``ops/attention.py::paged_attention_reference``; on a
CUDA tensor it launches the kernel or raises — it never falls back.

With bf16 q the kernel is split-K: :func:`split_plan` cuts each
sequence's table into runs of whole pages (a pure function of the
shapes; ``context_lens`` stay on the device), one block per (kv head,
split, sequence) keeps ``(acc, m, l)`` of its run, and the last block of
each (sequence, kv head) merges them in the same launch.
:func:`split_partials_reference` and :func:`merge_split_partials` are
the plain model of that split and merge. f32 q is a check mode: one
block per (kv head, sequence), no split.
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
    NEG_INF,
    _gather_ctx,
    kv_page_data,
    paged_attention_reference,
)

KERNEL = "paged_attention"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The split plan: each sequence's table is cut into as many runs of whole
# pages as keep the grid within one wave of resident blocks
# (BLOCKS_PER_SM an SM: the bf16 kernel's two-stage ring at D = 128 lets
# three share an SM), with no more runs than SPLIT_MIN_TOKENS-token runs
# fill the table, and at most MAX_SPLITS (the kernel's limit).
SPLIT_MIN_TOKENS = 256
BLOCKS_PER_SM = 3
MAX_SPLITS = 64
ROW_TILE = 16  # query rows of a kv head one block holds (an MMA tile)
_sm_counts = {}
_tickets = {}


def _ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.paged_attention_launch
    # q, k, v, k_scales, v_scales, tables, lens, out, part_o, part_ml,
    # tickets; 11 ints; the stream.
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def split_plan(B: int, KVH: int, MAXB: int, bs: int, *, row_tiles: int = 1,
               sms: int = 132) -> int:
    """The number of splits of each sequence's table: runs of
    ``split_pages(MAXB, splits)`` whole pages, the last one shorter.
    ``row_tiles`` blocks serve each kv head (``ceil(G / 16)``); ``sms``
    is the card's SM count. One split when the table holds at most
    ``SPLIT_MIN_TOKENS`` tokens, or when one wave is full without
    splitting. The plan sees the table's width, not the context lengths,
    which stay on the device."""
    min_pages = -(-SPLIT_MIN_TOKENS // bs)
    wave = (BLOCKS_PER_SM * sms) // (B * KVH * row_tiles)
    return max(1, min(MAX_SPLITS, -(-MAXB // min_pages), wave))


def split_pages(MAXB: int, splits: int) -> int:
    """Pages of each split's run (the kernel's own arithmetic)."""
    return -(-MAXB // splits)


def split_partials_reference(q, k_pages, v_pages, block_tables,
                             context_lens, layer: int, *, scale: float,
                             splits: int):
    """Plain model of the kernel's splits: each split's unnormalised
    ``(acc [B, H, splits, D], m [B, H, splits], l [B, H, splits])`` in
    float32 over its run of tokens below ``context_len``; a split with no
    such token has m = NEG_INF, l = 0 and acc = 0."""
    B, H, D = q.shape
    k_data = kv_page_data(k_pages)
    bs, KVH = k_data.shape[2], k_data.shape[3]
    MAXB = block_tables.shape[1]
    G = H // KVH
    span = split_pages(MAXB, splits) * bs
    k_ctx = _gather_ctx(k_pages, block_tables, layer, out_dtype=q.dtype)
    v_ctx = _gather_ctx(v_pages, block_tables, layer, out_dtype=q.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(B, KVH, G, D).float(),
                          k_ctx.float()) * scale
    tok = torch.arange(MAXB * bs, device=q.device)
    live = tok[None, :] < context_lens.to(q.device)[:, None]  # [B, S]
    which = tok // span  # [S] the split of each token
    accs, ms, ls = [], [], []
    for s in range(splits):
        mask = (live & (which == s)[None, :])[:, None, None, :]
        sc = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m = sc.amax(dim=-1)
        p = torch.where(mask, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p.to(v_ctx.dtype),
                                 v_ctx).float().reshape(B, H, D))
        ms.append(m.reshape(B, H))
        ls.append(p.sum(dim=-1).reshape(B, H))
    return (torch.stack(accs, dim=2), torch.stack(ms, dim=2),
            torch.stack(ls, dim=2))


def merge_split_partials(acc, m, l, dtype):
    """Flash recombination of split partials ``(acc [B, H, S, D], m, l
    [B, H, S])`` into ``[B, H, D]`` in ``dtype``: splits with l = 0 (no
    live token) weigh 0, as in the kernel's merge."""
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(dim=-1,
                                                               keepdim=True)
    w = torch.where(live, torch.exp(m - M), torch.zeros_like(m))
    L = (w * l).sum(dim=-1)
    out = (w[..., None] * acc).sum(dim=2) / torch.clamp(L, min=1e-30)[
        ..., None]
    return out.to(dtype)


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _ticket_buffer(device, n: int) -> torch.Tensor:
    """The per-device int32 merge counters (at least ``n``), made with
    zeros only when they must grow; the kernel leaves them at 0."""
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


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
    MAXB = bt.shape[1]
    part_o = part_ml = tickets = None
    splits = 1
    if q.dtype == torch.bfloat16:
        row_tiles = -(-(H // KVH) // ROW_TILE)
        splits = split_plan(B, KVH, MAXB, bs, row_tiles=row_tiles,
                            sms=_sm_count(q.device))
        if splits > 1:
            heads = KVH * row_tiles
            part_o = torch.empty((B, heads, splits, ROW_TILE, D),
                                 dtype=torch.float32, device=q.device)
            part_ml = torch.empty((B, heads, splits, 2, ROW_TILE),
                                  dtype=torch.float32, device=q.device)
            tickets = _ticket_buffer(q.device, B * heads)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            _ptr(qs), _ptr(k_data), _ptr(v_data), _ptr(k_scales),
            _ptr(v_scales), _ptr(bt), _ptr(ctx), _ptr(out), _ptr(part_o),
            _ptr(part_ml), _ptr(tickets), B, H, KVH, D, NB, bs, MAXB, layer,
            _DTYPES[q.dtype], int(quantized), splits,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, KERNEL)
    if quantized:
        paged_attention.launches_int8 += 1
    else:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.launches_int8 = 0
