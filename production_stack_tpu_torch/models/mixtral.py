"""Mixtral-style sparse-MoE decoder in PyTorch (Mixtral-8x7B).

The port of ``production_stack_tpu/models/mixtral.py``: Llama attention
(``rms_norm``, ``rope`` and ``attend`` of ``models/llama.py``: the paged
decode and cached-prefill kernels on the card) and a top-k routed expert
MLP, with
the JAX tree's leaf names and ``[in, out]`` orientation and a separate
``lm_head``.

The expert MLP is the JAX function's dense all-expert form: every token
runs every expert and the outputs are combined under the routing weights
(zero for an expert outside the token's top k), float32 softmax over the
top-k router logits, SiLU in float32. A routed form that runs only the
chosen experts is later work. The top k breaks ties toward the lower
expert index, as ``jax.lax.top_k`` does (``torch.topk`` promises no order
on ties, and the bf16 router logits tie often).

No LoRA slots and no int8 weights (the JAX engine gives both to the
Llama family only); ``adapter_ids`` is ignored.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.llama import (
    apply_rope,
    attend,
    rms_norm,
    rope_tables,
)
from production_stack_tpu_torch.ops.attention import kv_page_data, valid_slots


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                **_unused) -> Dict:
    """Random-init parameter dict with the shapes and scales of the JAX
    ``init_params`` (normal / sqrt(fan_in), 0.02 for the embedding, unit
    norms), drawn from ``generator`` in the working dtype. Each stacked
    leaf is allocated once and drawn one layer at a time into it, so no
    temporary larger than one layer's slice ever exists (a ``w_gate`` of
    24 Mixtral-8x7B layers is 22.5 GB in bf16). The values differ from
    the JAX init's."""
    dtype = cfg.torch_dtype
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Hd, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    V, E = cfg.vocab_size, cfg.num_experts

    def normal(shape, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        for part in (t if len(shape) > 2 else (t,)):
            part.normal_(generator=generator).mul_(std)
        return t

    layers = {"attn_norm": torch.ones((L, Hd), dtype=dtype, device=device),
              "mlp_norm": torch.ones((L, Hd), dtype=dtype, device=device)}
    for name, shape, fan_in in (
            ("wq", (Hd, H * D), Hd), ("wk", (Hd, KVH * D), Hd),
            ("wv", (Hd, KVH * D), Hd), ("wo", (H * D, Hd), H * D),
            ("router", (Hd, E), Hd), ("w_gate", (E, Hd, I), Hd),
            ("w_up", (E, Hd, I), Hd), ("w_down", (E, I, Hd), I)):
        layers[name] = normal((L,) + shape, fan_in ** -0.5)
    return {
        "embed": normal((V, Hd), 0.02),
        "layers": layers,
        "final_norm": torch.ones((Hd,), dtype=dtype, device=device),
        "lm_head": normal((Hd, V), Hd ** -0.5),
    }


def top_k_lower_index(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    ties broken toward the lower index (``jax.lax.top_k``'s order): a
    stable descending sort keeps equal entries in index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_mlp(cfg: ModelConfig, p: Dict, h: torch.Tensor) -> torch.Tensor:
    """Top-k routed expert MLP, dense over all experts. h: [B, T, Hd] ->
    [B, T, Hd]. One layer's leaves: ``router [Hd, E]``, ``w_gate`` and
    ``w_up [E, Hd, I]``, ``w_down [E, I, Hd]``."""
    B, T, Hd = h.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    router_logits = (h @ p["router"]).float()  # [B, T, E]
    topk_vals, topk_idx = top_k_lower_index(router_logits, K)
    topk_w = torch.softmax(topk_vals, dim=-1)  # [B, T, K]
    # The routing weight of every expert (0 off the top k); the k
    # indices of a token are distinct, so the scatter is the JAX one-hot
    # contraction exactly.
    dense_w = torch.zeros((B, T, E), dtype=torch.float32, device=h.device)
    dense_w.scatter_(-1, topk_idx, topk_w)
    # All-expert products, expert-major: [E, BT, Hd] @ [E, Hd, I].
    x = h.reshape(1, B * T, Hd)
    gate = torch.matmul(x, p["w_gate"])
    up = torch.matmul(x, p["w_up"])
    act = F.silu(gate.float()).to(h.dtype) * up
    del gate, up
    out = torch.matmul(act, p["w_down"])  # [E, BT, Hd]
    del act
    combined = torch.einsum("enh,ne->nh", out.float(),
                            dense_w.reshape(B * T, E))
    return combined.to(h.dtype).reshape(B, T, Hd)


def _layer(cfg: ModelConfig, mode: str, x: torch.Tensor, p: Dict, kv: tuple,
           layer: int, positions, rotary, valid, block_tables, context_lens,
           seq_lens) -> torch.Tensor:
    B, T, Hd = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / (D ** 0.5)

    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q = apply_rope((h @ p["wq"]).reshape(B, T, H, D), *rotary)
    k = apply_rope((h @ p["wk"]).reshape(B, T, KVH, D), *rotary)
    v = (h @ p["wv"]).reshape(B, T, KVH, D)
    attn = attend(mode, q, k, v, kv, valid, layer, positions, block_tables,
                  context_lens, seq_lens, scale)
    x = x + attn.reshape(B, T, H * D) @ p["wo"]

    h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return x + moe_mlp(cfg, p, h)


def apply(
    params: Dict,
    cfg: ModelConfig,
    token_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T]
    kv_pages: tuple,
    slot_mapping: torch.Tensor,  # [B, T]; <0 = no write
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    mode: str,
    adapter_ids: Optional[torch.Tensor] = None,
    output_hidden: bool = False,
    last_token: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, tuple]:
    """Full forward, with ``models/llama.py::apply``'s signature and
    returns. ``adapter_ids`` is ignored (no LoRA slots)."""
    del adapter_ids
    emb = params["embed"]
    x = emb[token_ids.clamp(0, emb.shape[0] - 1)].to(cfg.torch_dtype)
    k_all, v_all = kv_pages
    k_data = kv_page_data(k_all)
    valid = valid_slots(slot_mapping, k_data.device)
    rotary = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    for layer in range(k_data.shape[0]):
        p = {k: v[layer] for k, v in layers.items()}
        x = _layer(cfg, mode, x, p, (k_all, v_all), layer, positions, rotary,
                   valid, block_tables, context_lens, seq_lens)
    if last_token is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_token][:, None]
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if output_hidden:
        return x.float(), (k_all, v_all)
    return (x @ params["lm_head"]).float(), (k_all, v_all)
