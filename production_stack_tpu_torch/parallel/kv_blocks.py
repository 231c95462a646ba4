"""A rank's part of a whole KV block, and the whole block from the parts.

Whole blocks travel block-major, as the TKV2 payload holds them
(``kv/offload.py``): ``[N, L, bs, KVH, D]`` pages, and for an int8 pool
``(data, scales)`` with float32 scales ``[N, L, bs*KVH]``, slot-major
(``bs*KVH`` is ``bs`` slots of ``KVH`` heads). A rank of a sharded
engine holds the layers of its pipeline stage and its KV heads
(``parallel/sharding.py``): :func:`block_slice` cuts that part out of a
whole payload (what every rank writes when the leader installs one), and
:func:`assemble` puts the parts of one replica back together (what the
leader returns when the ranks have gathered theirs).

Where ``tp > num_kv_heads`` each rank holds the one KV head its q heads
read, and ``tp / num_kv_heads`` ranks hold copies of each head:
:func:`assemble` keeps the first rank's copy. Under data parallelism
every replica holds the same pages, so one replica's parts make the
block.
"""

from __future__ import annotations

from typing import Sequence

import torch

from production_stack_tpu_torch.parallel.sharding import (
    kv_head_start,
    kv_heads_local,
    stage_layers,
)


def _heads_view(scales: torch.Tensor, bs: int) -> torch.Tensor:
    """``[N, L, bs*KVH]`` scales as ``[N, L, bs, KVH]`` (a view)."""
    return scales.reshape(scales.shape[:2] + (bs, -1))


def block_slice(payload, cfg, rank: int, tp: int, stage: int = 0,
                pp: int = 1):
    """Rank ``rank`` (tp index) of stage ``stage``'s part of a whole-block
    payload: the stage's layers and the rank's KV heads (views; an int8
    scale leaf is copied, its heads being a strided slice of the
    slot-major axis)."""
    layers = stage_layers(cfg.num_layers, stage, pp)
    h0, n = kv_head_start(cfg, rank, tp), kv_heads_local(cfg, tp)
    if isinstance(payload, (tuple, list)):
        data, scales = payload
        bs = data.shape[2]
        s = _heads_view(scales[:, layers.start:layers.stop], bs)
        s = s[..., h0:h0 + n]
        return (data[:, layers.start:layers.stop, :, h0:h0 + n],
                s.reshape(s.shape[:2] + (-1,)))
    return payload[:, layers.start:layers.stop, :, h0:h0 + n]


def assemble(parts: Sequence, cfg, tp: int, pp: int = 1):
    """The whole-block payload from one replica's parts, ``parts[stage *
    tp + rank]`` (rank order), each a :func:`block_slice` of it. Where
    ranks hold copies of a KV head, the first rank's copy is kept."""
    keep = []  # the tp ranks whose heads make the whole head axis
    for r in range(tp):
        if kv_head_start(cfg, r, tp) == sum(
                kv_heads_local(cfg, tp) for _ in keep):
            keep.append(r)
    int8 = isinstance(parts[0], (tuple, list))

    def heads(stage_parts, leaf):
        """The stage's parts of one leaf, joined on the head axis."""
        got = [stage_parts[r][leaf] if int8 else stage_parts[r]
               for r in keep]
        if leaf == 1:  # scales: join [N, L, bs, n] on the heads
            bs = parts[0][0].shape[2]
            got = [_heads_view(g, bs) for g in got]
            whole = torch.cat(got, dim=3)
            return whole.reshape(whole.shape[:2] + (-1,))
        return torch.cat(got, dim=3)

    stages = [parts[s * tp:(s + 1) * tp] for s in range(pp)]
    if int8:
        return tuple(torch.cat([heads(sp, leaf) for sp in stages], dim=1)
                     for leaf in (0, 1))
    return torch.cat([heads(sp, 0) for sp in stages], dim=1)
