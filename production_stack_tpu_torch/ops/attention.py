"""Attention ops: plain PyTorch versions + kernel dispatch.

The port of ``production_stack_tpu/ops/attention.py``. Public functions
keep the JAX package's layouts so the two can be compared directly:

- prefill: causal self-attention over a fresh prompt chunk from its own
  K/V (never a kernel in either package; plain torch ops here);
- cached prefill: a chunk's queries over its paged prefix plus its own
  K/V, all read from the pages — :func:`context_prefill_attention`
  launches the CUDA kernel of ``ops/prefill_attention.py`` for CUDA
  tensors;
- decode: one query per sequence over its KV pages —
  :func:`paged_decode_attention` launches the CUDA kernel of
  ``ops/paged_attention.py`` for CUDA tensors.

On CPU tensors the dispatchers run the plain versions below, which are
also what the kernels are held against on the card. All softmax
accumulation is float32 regardless of compute dtype. KV pages are either
a bare ``[L, NB, bs, KVH, D]`` tensor per side (bf16/f32 cache) or the
JAX package's int8 ``(data, scales)`` pair (see :func:`kv_page_data`),
byte for byte in its layout.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

# _context_prefill_reference switches to the chunked online-softmax path
# when its f32 scores tensor would exceed this (tests lower it to force
# the chunked path at toy shapes).
_CHUNKED_SCORE_BYTES = 1 << 30
_CHUNKED_SCORE_SPAN = 1024


def kv_page_data(pages):
    """The tensor leaf of a KV page operand.

    Pages are either a bare ``[L, NB, bs, KVH, D]`` tensor (bf16/f32
    cache) or an ``(data, scales)`` pair (int8 cache): ``data`` is the
    int8 pages tensor and ``scales`` a float32 ``[L, NB, bs * KVH]``
    per-slot, per-kv-head symmetric scale, flat and token-major, so it
    views as ``(L * NB * bs, KVH)`` with the same flat slot index as the
    data: the scale of token ``t`` of page ``p``, kv head ``h``, layer
    ``l`` sits at ``((l * NB + p) * bs + t % bs) * KVH + h``."""
    return pages[0] if isinstance(pages, tuple) else pages


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(token, kv-head) int8 quantization of [..., KVH, D]
    values: scale = amax / 127 over D, with amax taken as 1.0 where the
    row is all-zero (so such a row gets scale 1/127 and codes 0), codes
    rounded half to even and clipped to [-127, 127]. The JAX function's
    arithmetic, in the same order."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)  # [..., KVH]
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def prefill_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, KVH, D]
    v: torch.Tensor,  # [B, T, KVH, D]
    *,
    scale: float,
    seq_lens: torch.Tensor | None = None,  # [B] valid lengths
) -> torch.Tensor:
    """Causal attention over a prompt chunk. Returns [B, T, H, D]."""
    B, T, H, D = q.shape
    KVH = k.shape[2]
    group = H // KVH
    qg = q.reshape(B, T, KVH, group, D)
    scores = torch.einsum(
        "btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :, None] >= pos[None, None, :])  # [1, T, S]
    if seq_lens is not None:
        valid = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]
        mask = mask & valid
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(B, T, H, D)


def _gather_ctx(pages, block_tables: torch.Tensor, layer: int,
                out_dtype=None) -> torch.Tensor:
    """Gather a batch's context from stacked pages [L, NB, bs, KVH, D]
    through page indices into the (L*NB)-page flat view, without
    materialising a whole layer. int8 ``(data, scales)`` pages are
    gathered page-wise too, then dequantized (an f32 multiply) before
    the cast. Returns [B, MAXB*bs, KVH, D] in ``out_dtype`` (float32
    when not given) for both encodings."""
    data = kv_page_data(pages)
    L, NB, bs, KVH, D = data.shape
    B, MAXB = block_tables.shape
    flat = data.reshape(L * NB, bs, KVH, D)
    idx = (layer * NB + block_tables.to(device=data.device,
                                        dtype=torch.long))
    ctx = flat[idx].reshape(B, MAXB * bs, KVH, D)
    if isinstance(pages, tuple):
        ctx_s = pages[1].reshape(L * NB, bs, KVH)[idx].reshape(
            B, MAXB * bs, KVH)
        ctx = ctx.float() * ctx_s[..., None]
    return ctx.to(out_dtype if out_dtype is not None else torch.float32)


def context_prefill_attention(
    q: torch.Tensor,  # [B, T, H, D] suffix queries
    k_pages: torch.Tensor,  # [L, NB, bs, KVH, D] stacked pages
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MAXB]
    positions: torch.Tensor,  # [B, T] absolute positions of the queries
    total_lens: torch.Tensor,  # [B] full context length (cached + suffix)
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Prefill attention for a chunk whose cached prefix (and its own
    K/V, written one op earlier) live in the pages: the query at absolute
    position p attends to positions 0..p. Returns [B, T, H, D].

    CUDA tensors go to the cached-prefill kernel, which reads the chunk's
    own K/V back from the pages as the plain version does (the JAX
    function's ``k_new``/``v_new``/``suffix_lens`` are not needed);
    CPU tensors run :func:`_context_prefill_reference`."""
    from production_stack_tpu_torch.ops.prefill_attention import (
        cached_prefill_attention,
    )

    return cached_prefill_attention(
        q, k_pages, v_pages, block_tables, positions, total_lens, layer,
        scale=scale)


def _context_prefill_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MAXB]
    positions: torch.Tensor,  # [B, T]
    total_lens: torch.Tensor,  # [B]
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Plain version: gather the whole padded context (suffix included —
    it was scattered to the pages by write_kv_pages one op earlier), mask
    causally against ``positions``, softmax. Past ~1 GB of f32 scores the
    context streams in chunks with an online softmax instead (same math,
    bounded temporaries)."""
    B, T, H, D = q.shape
    k_data = kv_page_data(k_pages)
    bs, KVH = k_data.shape[2], k_data.shape[3]
    MAXB = block_tables.shape[1]
    group = H // KVH
    dev = q.device
    positions = positions.to(dev)
    total_lens = total_lens.to(dev)
    k_ctx = _gather_ctx(k_pages, block_tables, layer, out_dtype=q.dtype)
    v_ctx = _gather_ctx(v_pages, block_tables, layer, out_dtype=q.dtype)
    qg = q.reshape(B, T, KVH, group, D)
    S = MAXB * bs
    scores_bytes = 4 * B * KVH * group * T * S
    chunk = _CHUNKED_SCORE_SPAN
    if scores_bytes > _CHUNKED_SCORE_BYTES and S > chunk:
        # Ragged tails pad with zero pages (their span indices exceed
        # every total_len, so the mask drops them).
        nc = -(-S // chunk)
        if nc * chunk != S:
            pad = nc * chunk - S
            k_ctx = torch.nn.functional.pad(k_ctx, (0, 0, 0, 0, 0, pad))
            v_ctx = torch.nn.functional.pad(v_ctx, (0, 0, 0, 0, 0, pad))
        m = torch.full((B, KVH, group, T, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KVH, group, T, 1), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, KVH, group, T, D), dtype=torch.float32,
                          device=dev)
        for ci in range(nc):
            k_c = k_ctx[:, ci * chunk:(ci + 1) * chunk]
            v_c = v_ctx[:, ci * chunk:(ci + 1) * chunk]
            s = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                             k_c.float()) * scale
            span_c = ci * chunk + torch.arange(chunk, device=dev)
            causal = span_c[None, None, :] <= positions[:, :, None]
            valid = span_c[None, None, :] < total_lens[:, None, None]
            s = torch.where((causal & valid)[:, None, None, :, :], s,
                            torch.full_like(s, NEG_INF))
            m_cur = s.amax(dim=-1, keepdim=True)
            m_new = torch.maximum(m, m_cur)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            upd = torch.einsum("bkgts,bskd->bkgtd", p.to(v_c.dtype),
                               v_c).float()
            acc = acc * alpha + upd
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
        return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)

    scores = torch.einsum(
        "btkgd,bskd->bkgts", qg.float(), k_ctx.float()) * scale
    span = torch.arange(S, device=dev)
    causal = span[None, None, :] <= positions[:, :, None]  # [B, T, S]
    valid = span[None, None, :] < total_lens[:, None, None]
    mask = causal & valid
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v_ctx.dtype), v_ctx)
    return out.reshape(B, T, H, D)


def valid_slots(slot_mapping: torch.Tensor, device) -> tuple:
    """``(rows, slots)`` of the non-negative entries of a flat-slot map,
    on ``device``. Found on the map's own device (the engine builds it on
    the host, so no device sync) and moved once per forward."""
    flat = slot_mapping.reshape(-1)
    rows = torch.nonzero(flat >= 0).reshape(-1)
    slots = flat[rows].to(torch.long)
    return to_device(rows, device), to_device(slots, device)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``. A host tensor bound for a card goes through
    pinned memory as an asynchronous copy, so the host does not wait for
    the work already queued on the card (a plain copy from pageable
    memory synchronises the stream)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def scatter_kv_pages(k_pages, v_pages, k_new, v_new, valid, layer: int):
    """The in-place scatter behind :func:`write_kv_pages`, for a
    ``valid`` pair already computed by :func:`valid_slots`. int8 pages
    quantize here, on the scatter, with the live rows selected first
    (equivalent to the JAX order, quantize all then drop: quantization
    is per (token, head)); the data and the ``(L*NB*bs, KVH)`` view of
    the scales take the same slots."""
    rows, slots = valid
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        data = kv_page_data(pages)
        L, NB, bs, KVH, D = data.shape
        flat = data.view(L * NB * bs, KVH, D)
        src = new.reshape(-1, KVH, D)[rows]
        dst = slots + layer * NB * bs
        if isinstance(pages, tuple):
            src, src_scales = quantize_kv(src)
            pages[1].view(L * NB * bs, KVH).index_copy_(0, dst, src_scales)
        flat.index_copy_(0, dst, src.to(data.dtype))
    return k_pages, v_pages


def write_kv_pages(
    k_pages: torch.Tensor,  # [L, NB, bs, KVH, D] stacked pages
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, KVH, D]
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, T] flat slot ids (layer 0); <0 = skip
    layer: int,
):
    """Scatter fresh K/V into their page slots, addressing the stacked
    pool through its flat ``[L*NB*bs, KVH, D]`` view; negative slots are
    dropped; int8 ``(data, scales)`` pages quantize on the scatter.
    Unlike the JAX version, which is functional and returns new arrays,
    this updates ``k_pages``/``v_pages`` IN PLACE (and returns the same
    operands) — the pool is never copied."""
    valid = valid_slots(slot_mapping, kv_page_data(k_pages).device)
    return scatter_kv_pages(k_pages, v_pages, k_new, v_new, valid, layer)


def paged_attention_reference(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [L, NB, bs, KVH, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MAXB] page ids
    context_lens: torch.Tensor,  # [B]
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Plain version: gather the padded context, mask, softmax. [B, H, D]."""
    B, H, D = q.shape
    k_data = kv_page_data(k_pages)
    bs, KVH = k_data.shape[2], k_data.shape[3]
    MAXB = block_tables.shape[1]
    group = H // KVH
    k_ctx = _gather_ctx(k_pages, block_tables, layer, out_dtype=q.dtype)
    v_ctx = _gather_ctx(v_pages, block_tables, layer, out_dtype=q.dtype)
    qg = q.reshape(B, KVH, group, D)
    scores = torch.einsum(
        "bkgd,bskd->bkgs", qg.float(), k_ctx.float()) * scale
    span = torch.arange(MAXB * bs, device=q.device)
    mask = span[None, :] < context_lens.to(q.device)[:, None]  # [B, S]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_ctx.dtype), v_ctx)
    return out.reshape(B, H, D)


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    from production_stack_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    return paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                           layer, scale=scale)
