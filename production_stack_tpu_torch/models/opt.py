"""OPT decoder (facebook/opt-*) in PyTorch, serving from a paged KV pool.

The port of ``production_stack_tpu/models/opt.py``: the JAX tree's leaf
names and ``[in, out]`` weight orientation (so a JAX parameter tree
crosses over through ``models/convert.py`` untouched), and the same
forward:

- learned positional embeddings read at ``position + POS_OFFSET`` (OPT's
  quirk), the index clamped to the table as the JAX gather clamps it (the
  engine fills padding columns with ascending positions, which can pass
  the table's end);
- LayerNorm in float32 with the population variance (``jnp.var``);
- biases on every projection, ReLU MLP, multi-head attention (``num_kv_heads
  == num_heads``), no RoPE;
- a head tied to the embedding: ``x @ embed.T`` in the model dtype, then
  float32.

OPT takes no LoRA slots and no int8 weights (the JAX engine gives both to
the Llama family only); ``adapter_ids`` is ignored. Attention is the
Llama model's ``attend``: the paged decode and cached-prefill kernels on
the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.llama import (
    LeafDrawer,
    attend,
    row_parallel,
)
from production_stack_tpu_torch.ops.attention import kv_page_data, valid_slots
from production_stack_tpu_torch.parallel.sharding import local_shape

POS_OFFSET = 2  # OPT's learned-position quirk


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the population variance, as the JAX
    model computes it (``torch.var``'s default is the unbiased one)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator, device, *,
                rank: int = 0, tp: int = 1, **_unused) -> Dict:
    """Random-init parameter dict with the shapes and scales of the JAX
    ``init_params`` (normal / sqrt(fan_in), 0.02 for both embeddings,
    unit norm weights, zero biases), drawn from ``generator`` in the
    working dtype. The values differ from the JAX init's. With ``tp > 1``
    each leaf is drawn whole and rank ``rank``'s slice kept, as
    ``models/llama.py::init_params`` does."""
    dtype = cfg.torch_dtype
    H, D, Hd = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    I, L, V = cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    draw = LeafDrawer(cfg, generator, device, rank, tp)

    def const(key, shape, value):
        return torch.full(local_shape(key, shape, cfg, rank, tp), value,
                          dtype=dtype, device=device)

    layers = {}
    for name, shape, fan_in in (
            ("wq", (Hd, H * D), Hd), ("wk", (Hd, H * D), Hd),
            ("wv", (Hd, H * D), Hd), ("wo", (H * D, Hd), H * D),
            ("fc1", (Hd, I), Hd), ("fc2", (I, Hd), I)):
        draw.whole(layers, ("layers", name), (L,) + shape, fan_in ** -0.5,
                   None)
        layers[name + "_b"] = const(("layers", name + "_b"), (L, shape[1]),
                                    0.0)
    for name in ("ln1", "ln2"):
        layers[name + "_w"] = const(("layers", name + "_w"), (L, Hd), 1.0)
        layers[name + "_b"] = const(("layers", name + "_b"), (L, Hd), 0.0)
    params = {}
    draw.whole(params, ("embed",), (V, Hd), 0.02, None)
    draw.whole(params, ("pos_embed",), (cfg.max_position + POS_OFFSET, Hd),
               0.02, None)
    params.update(layers=layers,
                  final_ln_w=torch.ones((Hd,), dtype=dtype, device=device),
                  final_ln_b=torch.zeros((Hd,), dtype=dtype, device=device))
    return params


def _layer(cfg: ModelConfig, mode: str, x: torch.Tensor, p: Dict, kv: tuple,
           layer: int, positions, valid, block_tables, context_lens,
           seq_lens, tp) -> torch.Tensor:
    B, T, Hd = x.shape
    D = cfg.head_dim
    scale = 1.0 / (D ** 0.5)

    # A rank's heads: the widths of its weight slices. The row-parallel
    # biases are added once, after the ranks' partial sums.
    h = layer_norm(x, p["ln1_w"], p["ln1_b"])
    q = (h @ p["wq"] + p["wq_b"]).reshape(B, T, -1, D)
    k = (h @ p["wk"] + p["wk_b"]).reshape(B, T, -1, D)
    v = (h @ p["wv"] + p["wv_b"]).reshape(B, T, -1, D)
    attn = attend(mode, q, k, v, kv, valid, layer, positions, block_tables,
                  context_lens, seq_lens, scale)
    x = x + row_parallel(attn.reshape(B, T, -1) @ p["wo"], tp) + p["wo_b"]

    h = layer_norm(x, p["ln2_w"], p["ln2_b"])
    h = torch.relu(h @ p["fc1"] + p["fc1_b"])
    return x + row_parallel(h @ p["fc2"], tp) + p["fc2_b"]


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
    tp=None,
) -> Tuple[torch.Tensor, tuple]:
    """Full forward, with ``models/llama.py::apply``'s signature and
    returns (``tp``: a rank's slice of a sharded model; the tied head
    is replicated, so every rank computes the whole logits).
    ``adapter_ids`` is ignored (no LoRA slots)."""
    del adapter_ids
    dtype = cfg.torch_dtype
    emb, pos_emb = params["embed"], params["pos_embed"]
    # Out-of-range ids and positions read the last row, as the JAX
    # gather clamps them.
    x = emb[token_ids.clamp(0, emb.shape[0] - 1)].to(dtype)
    pos = (positions.to(torch.long) + POS_OFFSET).clamp(
        0, pos_emb.shape[0] - 1)
    x = x + pos_emb[pos].to(dtype)
    k_all, v_all = kv_pages
    k_data = kv_page_data(k_all)
    valid = valid_slots(slot_mapping, k_data.device)
    layers = params["layers"]
    for layer in range(k_data.shape[0]):
        p = {k: v[layer] for k, v in layers.items()}
        x = _layer(cfg, mode, x, p, (k_all, v_all), layer, positions, valid,
                   block_tables, context_lens, seq_lens, tp)
    if last_token is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_token][:, None]
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    if output_hidden:
        return x.float(), (k_all, v_all)
    return (x @ emb.T).float(), (k_all, v_all)
