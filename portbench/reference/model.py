"""Plain float32 forward of the benchmark's models, written from the
published descriptions (Mistral-7B and Mixtral-8x7B as their
``config.json`` and model cards define them): RMSNorm, rotary position
embedding on half-split pairs, grouped-query causal attention, a SiLU
gated MLP, and for Mixtral a softmax router whose top-k experts' outputs
are summed under their renormalised weights.

No kernels, no cache, no batching: one sequence at a time, layer by
layer, with each layer's weights drawn again from the seed
(``portbench/weights.py``), so nothing the program made is read. TF32 is
switched off while it runs. With ``precision="fp8"`` every weight matrix
is rounded to float8 e4m3 with a scale per output channel first: the
control, one precision step below the served bfloat16. With
``precision="bf16"`` it computes at the served dtype itself: a witness
of how far an honest bfloat16 forward lies from the float32 one.

Sliding-window attention (Mistral's ``sliding_window`` 4096) is not
applied: every sequence the benchmark sends is shorter than the window,
where full attention is the same.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from portbench import weights
from portbench.spec import Shape

FP8_MAX = 448.0  # largest finite float8 e4m3 value
# The activations' dtype by precision: float8 weights are rounded and
# then computed on in float32; "bf16" is a witness at the served dtype
# (bfloat16 weights and activations, norms and softmax in float32).
ACT = {"fp32": torch.float32, "fp8": torch.float32, "bf16": torch.bfloat16}


@contextlib.contextmanager
def no_tf32():
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` (``[..., in, out]``) rounded to float8 e4m3 with one scale
    per output channel, back in float32."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    # The norm weights are ones (the init's), so only the normalisation.
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(
        x.dtype)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [T, heads, D] at positions 0..T-1."""
    T, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float64) / D)
    ang = torch.arange(T, device=x.device, dtype=torch.float64)[:, None] \
        * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1).float()[:, None, :]
    half = D // 2
    xf = x.float()
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * ang.cos() + rot * ang.sin()).to(x.dtype)


def attention(h: torch.Tensor, w: dict, s: Shape) -> torch.Tensor:
    T = h.shape[0]
    D = s.head_dim
    q = rotary((h @ w["wq"]).view(T, s.heads, D), s.rope_theta)
    k = rotary((h @ w["wk"]).view(T, s.kv_heads, D), s.rope_theta)
    v = (h @ w["wv"]).view(T, s.kv_heads, D)
    group = s.heads // s.kv_heads
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("thd,shd->hts", q, k).float() / D ** 0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).triu(1)
    scores.masked_fill_(mask, float("-inf"))
    out = torch.einsum("hts,shd->thd", scores.softmax(-1).to(v.dtype), v)
    return out.reshape(T, s.heads * D) @ w["wo"]


def router_margin(router_logits: torch.Tensor, k: int) -> torch.Tensor:
    """How far each row's k-th largest router logit lies above its
    (k+1)-th: under this the expert choice flips with rounding."""
    top = router_logits.float().topk(k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def mlp(h: torch.Tensor, w: dict, s: Shape, margin=None) -> torch.Tensor:
    """The MLP; for a MoE with ``margin`` (a list), the rows' router
    margins (``router_margin``) are appended to it."""
    def silu(x):
        return torch.nn.functional.silu(x.float()).to(x.dtype)

    if not s.experts:
        return (silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
    router_logits = h @ w["router"]
    if margin is not None:
        margin.append(router_margin(router_logits, s.top_k))
    probs = router_logits.float().softmax(-1)
    top_w, top_i = probs.topk(s.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(s.experts):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = (silu(x @ w["w_gate"][e]) * (x @ w["w_up"][e])) @ w["w_down"][e]
        out.index_add_(0, rows, (y.float() * top_w[rows, slot, None]).to(
            h.dtype))
    return out


def _cast(w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return fp8_round(w)
    return w.to(ACT[precision])


def _layer_weights(s: Shape, seed: int, layer: int, device,
                   precision: str) -> dict:
    w = {}
    for name, _, _ in weights.layer_leaves(s):
        t = weights.draw_layer(s, seed, name, layer, getattr(torch, s.dtype),
                               device)
        w[name] = _cast(t, precision)
        del t
    return w


@torch.no_grad()
def next_token_logits(s: Shape, seed: int, seqs: Sequence[List[int]],
                      starts: Sequence[int], device,
                      precision: str = "fp32",
                      margins: Optional[list] = None) -> List[torch.Tensor]:
    """For each sequence, the float32 logits ``[len - start, vocab]``
    that follow each of its positions from ``start`` on: row ``j``
    predicts the token at ``start + j + 1``. For a MoE, a ``margins``
    list receives for each sequence the smallest router margin over the
    layers at the same rows (``router_margin``)."""
    with no_tf32():
        dtype = getattr(torch, s.dtype)
        emb = weights.draw_whole(s, seed, "embed", dtype, device)
        act = ACT[precision]
        xs = [emb[torch.tensor(ids, device=device)].to(act) for ids in seqs]
        del emb
        least = [None] * len(xs)
        for layer in range(s.layers):
            w = _layer_weights(s, seed, layer, device, precision)
            for i, x in enumerate(xs):
                x = x + attention(rms_norm(x, s.eps), w, s)
                m = [] if margins is not None and s.experts else None
                xs[i] = x + mlp(rms_norm(x, s.eps), w, s, margin=m)
                if m:
                    got = m[0][starts[i]:]
                    least[i] = got if least[i] is None else torch.minimum(
                        least[i], got)
            del w
        if margins is not None and s.experts:
            margins.extend(least)
        head = weights.draw_whole(s, seed, "lm_head", dtype, device)
        head = _cast(head, precision)
        return [(rms_norm(x[start:], s.eps) @ head).float()
                for x, start in zip(xs, starts)]
