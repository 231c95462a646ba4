"""Frozen operation and byte counts, and the card's published peaks.

Counted from the model's shapes and the benchmark's own log of what it
sent and received, never from the program's counters, so a later change
to the program cannot move the yardstick. Each count is what the inputs
need (a causal token attends over the positions up to its own; a
decode token reads its sequence's cached keys and values once), not
what a kernel happens to do, so a share of a peak cannot pass 100% by
counting.
"""

from __future__ import annotations

import math

from portbench.spec import Shape

# NVIDIA H100 SXM data sheet, dense rates: bfloat16 tensor cores and
# HBM3. At the card's full 700 W; the run reports its power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes


def matmul_params_per_token(s: Shape) -> int:
    """Weights one token multiplies in one layer: attention projections
    and the MLP (for a routed MoE the router and its top-k experts only,
    not the all-expert work of a dense implementation)."""
    attn = s.hidden * s.head_dim * (2 * s.heads + 2 * s.kv_heads)
    mlp = 3 * s.hidden * s.intermediate
    if s.experts:
        return attn + s.hidden * s.experts + s.top_k * mlp
    return attn + mlp


def attention_flops(s: Shape, ctx: int) -> float:
    """One token's attention in every layer over ``ctx`` positions: the
    scores and the weighted sum, 2 operations a multiply-add each."""
    return 4.0 * s.layers * s.heads * s.head_dim * ctx


def head_flops(s: Shape) -> float:
    return 2.0 * s.hidden * s.vocab


def token_flops(s: Shape, ctx: int, head: bool) -> float:
    """Model operations of one token at context ``ctx`` (its position
    plus one): every layer's products, its attention and, for a token
    whose logits are taken, the output head."""
    f = 2.0 * s.layers * matmul_params_per_token(s) + attention_flops(s, ctx)
    return f + (head_flops(s) if head else 0.0)


def prefill_flops(s: Shape, prompt: int, skipped: int) -> float:
    """Prompt positions ``skipped .. prompt - 1`` computed, the last one
    through the head. Closed form of the per-token sum."""
    n = prompt - skipped
    if n <= 0:
        return 0.0
    ctx_sum = (skipped + 1 + prompt) * n / 2.0
    return (2.0 * s.layers * matmul_params_per_token(s) * n
            + 4.0 * s.layers * s.heads * s.head_dim * ctx_sum
            + head_flops(s))


def cached_prefill_flops(s: Shape, prompt: int, skipped: int,
                         chunk: int) -> float:
    """Attention operations that a cached prefill computes: the prompt
    positions past the cached prefix whose chunk has a context before
    it (all of them after a prefix hit; from the second chunk on for a
    prompt computed from the start, whose first chunk attends within
    itself)."""
    first = skipped if skipped > 0 else min(chunk, prompt)
    n = prompt - first
    if n <= 0:
        return 0.0
    ctx_sum = (first + 1 + prompt) * n / 2.0
    return 4.0 * s.layers * s.heads * s.head_dim * ctx_sum


def decode_token_bytes(s: Shape, ctx: int, block: int) -> float:
    """Bytes the paged decode attention of one token needs in every
    layer: the ``ctx`` cached keys and values, its query and output, its
    block table and context length."""
    kv = 2 * s.kv_heads * s.head_dim * BF16 * ctx
    q_out = 2 * s.heads * s.head_dim * BF16
    table = 4 * math.ceil(ctx / block) + 4
    return float(s.layers * (kv + q_out + table))
