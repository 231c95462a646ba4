"""Llama-family decoder (Llama 2/3, Mistral, TinyLlama via config) in
PyTorch, serving from a paged KV pool.

The port of ``production_stack_tpu/models/llama.py``:

- parameters are a dict of tensors with the JAX package's leaf names and
  per-layer leaves stacked on a leading axis; weights keep the ``[in,
  out]`` orientation (``h @ W``), so a JAX parameter tree crosses over
  without transposes (``models/convert.py``);
- the layer loop is a Python loop that hands the integer layer index to
  every page operation on the stacked pool ``[L, NB, bs, KVH, D]``; no
  per-layer copy of the pool is ever sliced out;
- every forward first writes its fresh K/V into the pages (in place),
  then attends causally within the chunk (prefill), over the cached
  prefix plus the chunk (prefill_cached) or over the pages (decode);
- norms, RoPE and softmax accumulate in float32;
- weights may be int8 with per-output-channel scales
  (``models/quantize.py``): the product runs over a copy of the weight
  in the activation dtype and the scale applies to its result, as the
  JAX model leaves it to XLA; the KV pool may be int8 ``(data, scales)``
  pairs, which the page ops quantize and dequantize.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.quantize import quantize_tensor
from production_stack_tpu_torch.ops.attention import (
    context_prefill_attention,
    kv_page_data,
    paged_decode_attention,
    prefill_attention,
    scatter_kv_pages,
    valid_slots,
)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_tables(positions: torch.Tensor,  # [B, T]
                head_dim: int, theta: float):
    """(cos, sin) [B, T, 1, D/2] float32 of the rotary embedding; the
    same for every layer, so a forward computes them once."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / torch.pow(theta, exponent)
    angles = positions[..., None].float() * inv_freq  # [B, T, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor,  # [B, T, H, D]
         positions: torch.Tensor,  # [B, T]
         theta: float) -> torch.Tensor:
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    device,
    *,
    lora_slots: int = 0,
    lora_rank: int = 16,
    quantization: Optional[str] = None,
    quantize_embeddings: bool = False,
) -> Dict:
    """Random-init parameter dict with layer-stacked leaves: the shapes
    and scales of the JAX ``init_params`` (normal / sqrt(fan_in), 0.02 for
    the embedding, unit norms, zero LoRA slots), drawn from ``generator``
    (which must live on ``device``). The values differ from the JAX
    init's. Every leaf is drawn straight in the working dtype and scaled
    in place, so no float32 temporary of a stacked weight ever exists.

    With ``quantization="int8"`` each weight leaf (the embedding table
    and ``lm_head`` too with ``quantize_embeddings``) is quantized as soon
    as it is drawn and its working-dtype copy dropped, giving the leaves
    of the JAX ``quantize_tree`` (``<name>`` int8 plus ``<name>_scale``)
    from the same draws as the unquantized init."""
    if quantization not in (None, "int8"):
        raise ValueError(f"unsupported quantization {quantization!r}")
    dtype = cfg.torch_dtype
    H, KVH, D, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    I, L, V = cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    quantize = quantization == "int8"
    quantize_emb = quantize and quantize_embeddings

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=dtype)
        return t.mul_(std)

    def put(tree, name, w, reduce_axis, on):
        if on:
            w, tree[name + "_scale"] = quantize_tensor(w, reduce_axis)
        tree[name] = w

    params = {}
    put(params, "embed", normal((V, Hd), 0.02), -1, quantize_emb)
    layers = {"attn_norm": torch.ones((L, Hd), dtype=dtype, device=device),
              "mlp_norm": torch.ones((L, Hd), dtype=dtype, device=device)}
    for name, shape, fan_in in (
            ("wq", (Hd, H * D), Hd), ("wk", (Hd, KVH * D), Hd),
            ("wv", (Hd, KVH * D), Hd), ("wo", (H * D, Hd), H * D),
            ("w_gate", (Hd, I), Hd), ("w_up", (Hd, I), Hd),
            ("w_down", (I, Hd), I)):
        put(layers, name, normal((L,) + shape, fan_in ** -0.5), -2, quantize)
    params["layers"] = layers
    params["final_norm"] = torch.ones((Hd,), dtype=dtype, device=device)
    if not cfg.tie_word_embeddings:
        put(params, "lm_head", normal((Hd, V), Hd ** -0.5), -2, quantize_emb)
    if lora_slots > 0:
        S, R = lora_slots, lora_rank

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        params["lora"] = {
            "wq_a": zeros((L, S, Hd, R)),
            "wq_b": zeros((L, S, R, H * D)),
            "wv_a": zeros((L, S, Hd, R)),
            "wv_b": zeros((L, S, R, KVH * D)),
            "scaling": zeros((S,), torch.float32),
        }
    return params


def _proj(h: torch.Tensor, p: Dict, name: str) -> torch.Tensor:
    """``h @ W`` for a weight leaf that may be int8-quantized
    (models/quantize.py): the int8 product runs over a copy of the weight
    in h's dtype, and the per-output-channel scale applies to the
    [B, T, out] result, in h's dtype, as the JAX model computes it."""
    w = p[name]
    if w.dtype == torch.int8:
        out = h @ w.to(h.dtype)
        return out * p[name + "_scale"][0].to(h.dtype)
    return h @ w


def _lora_delta(h, a, b, scaling, adapter_ids):
    """Per-sequence LoRA delta: h [B,T,Hd] @ A[sel] @ B[sel] * scale."""
    a_sel = a[adapter_ids]  # [B, Hd, R]
    b_sel = b[adapter_ids]  # [B, R, out]
    s_sel = scaling[adapter_ids]  # [B]
    mid = torch.einsum("bth,bhr->btr", h, a_sel)
    out = torch.einsum("btr,bro->bto", mid, b_sel)
    return out * s_sel[:, None, None].to(out.dtype)


def attend(mode: str, q, k, v, kv: tuple, valid: tuple, layer: int,
           positions, block_tables, context_lens, seq_lens,
           scale: float) -> torch.Tensor:
    """One layer's attention of every model: write the fresh K/V ``[B,
    T, KVH, D]`` into the stacked pages ``kv`` (in place), then attend
    causally within the chunk (prefill), over the cached prefix plus the
    chunk read back from the pages (prefill_cached: after a prefix-cache
    hit or an earlier chunk) or over the pages (decode). Returns ``[B,
    T, H, D]``."""
    k_pages, v_pages = kv
    scatter_kv_pages(k_pages, v_pages, k, v, valid, layer)
    if mode == "prefill":
        return prefill_attention(q, k, v, scale=scale, seq_lens=seq_lens)
    if mode == "prefill_cached":
        return context_prefill_attention(
            q, k_pages, v_pages, block_tables, positions, context_lens,
            layer, scale=scale)
    if mode == "decode":
        return paged_decode_attention(
            q[:, 0], k_pages, v_pages, block_tables, context_lens, layer,
            scale=scale)[:, None]
    raise ValueError(f"unknown mode {mode!r}")


def _layer(
    cfg: ModelConfig,
    mode: str,
    x: torch.Tensor,  # [B, T, Hd]
    p: Dict,  # one layer's leaves (views of the stacked tensors)
    lora: Optional[Dict],  # one layer's LoRA leaves, or None
    kv: tuple,  # STACKED pages (bare tensors or int8 (data, scales))
    layer: int,
    positions: torch.Tensor,
    rotary: tuple,  # (cos, sin) of rope_tables(positions)
    valid: tuple,  # (rows, slots) of the live page writes
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    seq_lens: torch.Tensor,
    lora_scaling: Optional[torch.Tensor],
    adapter_ids: Optional[torch.Tensor],
) -> torch.Tensor:
    B, T, Hd = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / (D ** 0.5)

    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q_flat = _proj(h, p, "wq")
    v_flat = _proj(h, p, "wv")
    if lora is not None:
        q_flat = q_flat + _lora_delta(
            h, lora["wq_a"], lora["wq_b"], lora_scaling, adapter_ids)
        v_flat = v_flat + _lora_delta(
            h, lora["wv_a"], lora["wv_b"], lora_scaling, adapter_ids)
    q = q_flat.reshape(B, T, H, D)
    k = _proj(h, p, "wk").reshape(B, T, KVH, D)
    v = v_flat.reshape(B, T, KVH, D)
    q = apply_rope(q, *rotary)
    k = apply_rope(k, *rotary)
    attn = attend(mode, q, k, v, kv, valid, layer, positions, block_tables,
                  context_lens, seq_lens, scale)
    x = x + _proj(attn.reshape(B, T, H * D), p, "wo")

    h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    gate = F.silu(_proj(h, p, "w_gate").float()).to(h.dtype)
    return x + _proj(gate * _proj(h, p, "w_up"), p, "w_down")


def embed_tokens(params: Dict, cfg: ModelConfig, token_ids: torch.Tensor,
                 adapter_ids: Optional[torch.Tensor]):
    """Shared forward preamble: input embeddings + LoRA leaf plumbing.
    Returns (x, lora_layers, lora_scaling, adapter_ids). Ids past the
    vocabulary read its last row, as the JAX gather clamps them."""
    emb = params["embed"]
    token_ids = token_ids.clamp(0, emb.shape[0] - 1)
    if emb.dtype == torch.int8:
        # Row-quantized table: dequantize only the gathered rows.
        x = (emb[token_ids].to(cfg.torch_dtype)
             * params["embed_scale"][token_ids].to(cfg.torch_dtype))
    else:
        x = emb[token_ids].to(cfg.torch_dtype)
    lora = params.get("lora")
    lora_scaling = lora["scaling"] if lora is not None else None
    if lora is not None and adapter_ids is None:
        adapter_ids = torch.zeros((token_ids.shape[0],), dtype=torch.long,
                                  device=token_ids.device)
    lora_layers = (
        {k: v for k, v in lora.items() if k != "scaling"}
        if lora is not None else None)
    return x, lora_layers, lora_scaling, adapter_ids


def project_out(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                output_hidden: bool) -> torch.Tensor:
    """Shared forward tail: final norm, then hidden states or logits."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if output_hidden:
        return x.float()
    head = params.get("lm_head")
    if head is not None:
        if head.dtype == torch.int8:
            # [Hd, V] int8 with scale [1, V]: scale per vocab channel.
            logits = (x @ head.to(x.dtype)).float()
            return logits * params["lm_head_scale"][0]
        return (x @ head).float()
    emb = params["embed"]
    if emb.dtype == torch.int8:
        # Tied head: the embedding's row scales [V, 1] are per-vocab
        # output scales of embed.T.
        logits = (x @ emb.T.to(x.dtype)).float()
        return logits * params["embed_scale"][:, 0]
    return (x @ emb.T).float()


def apply(
    params: Dict,
    cfg: ModelConfig,
    token_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    kv_pages: tuple,  # stacked [L,NB,bs,KVH,D] each, or (data, scales)
    slot_mapping: torch.Tensor,  # [B, T] flat slots; <0 = no write
    block_tables: torch.Tensor,  # [B, MAXB]
    context_lens: torch.Tensor,  # [B]
    seq_lens: torch.Tensor,  # [B] valid prompt lengths (prefill mask)
    *,
    mode: str,  # "prefill" | "prefill_cached" | "decode"
    adapter_ids: Optional[torch.Tensor] = None,  # [B] LoRA slot per row
    output_hidden: bool = False,
    last_token: Optional[torch.Tensor] = None,  # [B] position to keep
) -> Tuple[torch.Tensor, tuple]:
    """Full forward. Returns (logits [B, T, V] float32, kv_pages), the
    pages updated in place. With ``last_token`` the hidden states are
    sliced to that position before the norm and the vocab projection
    (prefill samples one position only). ``slot_mapping`` may live on the
    host: its live entries are found there once per forward."""
    x, lora_layers, lora_scaling, adapter_ids = embed_tokens(
        params, cfg, token_ids, adapter_ids)
    k_all, v_all = kv_pages
    k_data = kv_page_data(k_all)
    valid = valid_slots(slot_mapping, k_data.device)
    rotary = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    L = k_data.shape[0]
    for layer in range(L):
        p = {k: v[layer] for k, v in layers.items()}
        lora_p = (None if lora_layers is None
                  else {k: v[layer] for k, v in lora_layers.items()})
        x = _layer(cfg, mode, x, p, lora_p, (k_all, v_all), layer,
                   positions, rotary, valid, block_tables, context_lens,
                   seq_lens, lora_scaling, adapter_ids)
    if last_token is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_token][:, None]
    return project_out(params, cfg, x, output_hidden), (k_all, v_all)
