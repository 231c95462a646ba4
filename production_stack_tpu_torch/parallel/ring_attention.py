"""Ring attention: causal attention over a sequence split across a group
of ranks (sequence parallelism for long prompts).

The port of ``production_stack_tpu/parallel/ring_attention.py``, whose
body is ``einsum``s, not Pallas, so plain tensor operations are the port.
Each rank of the group holds one contiguous chunk of Q/K/V; the K/V
chunks rotate around the ring (``PPGroup.rotate``: ``isend``/``irecv``
to the neighbours) while a float32 online softmax accumulates, so a rank
holds ``O(T/sp * T/sp)`` scores instead of ``O(T * T)``.

Layout contract: the global sequence is split into ``sp`` contiguous
chunks; rank ``i`` of the group holds chunk ``i`` (positions ``[i*C,
(i+1)*C)``). Causality is enforced chunk to chunk: a query chunk attends
fully to earlier chunks, causally within its own chunk, and not at all
to later chunks (those steps contribute -inf and wash out of the online
softmax).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunk_scores(q, k, scale):
    """q [B,C,KVH,G,D] x k [B,C,KVH,D] -> scores [B,KVH,G,Cq,Ck] (f32)."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def ring_attention_fwd(q: torch.Tensor,  # [B, C, H, D] local query chunk
                       k: torch.Tensor,  # [B, C, KVH, D] local key chunk
                       v: torch.Tensor,  # [B, C, KVH, D] local value chunk
                       group, scale: float) -> torch.Tensor:
    """Causal ring attention of this rank's chunk over ``group`` (this
    rank's ``PPGroup``, whose stage index is the chunk index). Returns the
    attention output of the local query chunk ``[B, C, H, D]``."""
    B, C, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    sp, me = group.size, group.stage
    dev = q.device
    qg = q.reshape(B, C, KVH, G, D)
    pos_q = me * C + torch.arange(C, device=dev)
    m = torch.full((B, KVH, G, C), float("-inf"), device=dev)
    l = torch.zeros((B, KVH, G, C), device=dev)
    o = torch.zeros((B, KVH, G, C, D), device=dev)
    k_cur, v_cur = k, v
    for s in range(sp):
        # After s rotations this rank holds the chunk of the rank s hops
        # behind it on the ring.
        k_idx = (me - s) % sp
        pos_k = k_idx * C + torch.arange(C, device=dev)
        mask = (pos_k[None, :] <= pos_q[:, None])[None, None, None]
        scores = torch.where(mask, _chunk_scores(qg, k_cur, scale),
                             torch.tensor(NEG_INF, device=dev))
        new_m = torch.maximum(m, scores.amax(dim=-1))
        # Guard fully-masked rows: keep exp() finite.
        safe_m = torch.where(torch.isfinite(new_m), new_m,
                             torch.zeros_like(new_m))
        correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                                 torch.zeros_like(m))
        p = torch.where(mask, torch.exp(scores - safe_m[..., None]),
                        torch.zeros_like(scores))
        l = l * correction + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cur.dtype),
                          v_cur).float()
        o = o * correction[..., None] + pv
        m = new_m
        if s + 1 < sp:
            # Rotate K/V one hop (i -> i+1): the next step sees the chunk
            # rank i-1 held.
            k_cur = group.rotate(k_cur, tag=2 * s)
            v_cur = group.rotate(v_cur, tag=2 * s + 1)
    out = o / torch.clamp(l, min=1e-30)[..., None]  # [B,KVH,G,C,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, D).to(q.dtype)


def make_ring_attention(group, scale: float):
    """Ring attention over whole arrays: ``run(q, k, v)`` takes global q
    ``[B, T, H, D]`` and k/v ``[B, T, KVH, D]`` (T divisible by the group's
    size), runs this rank's chunk around the ring and returns the global
    output ``[B, T, H, D]`` on every rank of the group (each chunk's
    output shared from its rank)."""

    def run(q, k, v):
        sp, me = group.size, group.stage
        C = q.shape[1] // sp
        rows = slice(me * C, (me + 1) * C)
        local = ring_attention_fwd(q[:, rows], k[:, rows], v[:, rows],
                                   group, scale)
        chunks = []
        for i in range(sp):
            chunk = local if i == me else torch.empty_like(local)
            chunks.append(group.share_from(chunk, i))
        return torch.cat(chunks, dim=1)

    return run


def reference_causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """Single-process causal attention (for numerics comparison)."""
    B, T, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, T, KVH, G, D)
    scores = _chunk_scores(qg, k, scale)
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, None, None]
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", probs.to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)
