"""Pipeline parallelism: layer stages over a group of ranks, a GPipe
schedule around any per-layer function.

The port of ``production_stack_tpu/parallel/pipeline.py``. Layer-stacked
parameters shard on the layer axis: stage ``s`` of ``pp`` holds the
contiguous layers ``[s*L/pp, (s+1)*L/pp)`` (:func:`stage_params`).
Microbatches ride the pipeline: stage 0 takes each from the input, the
other stages receive it from the stage before (``parallel/pp.py``),
every stage runs its layers over it and hands it on, and the last
stage's outputs of all microbatches are shared with every rank. The JAX
schedule's bubble ticks (every stage computing on garbage while the
pipeline fills and drains) have no counterpart: each rank is its own
process and waits for its input.

:func:`pipeline_forward` is exercised standalone (tests, the card's
smoke run); the serving forward is ``parallel/pp_serving.py``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from production_stack_tpu_torch.parallel.sharding import stage_layers


def stage_params(params: Dict, stage: int, pp: int) -> Dict:
    """Stage ``stage``'s layers (views) of layer-stacked ``params``, whose
    leaves share their leading length L, divisible by ``pp``."""
    out = {}
    for name, leaf in params.items():
        layers = stage_layers(leaf.shape[0], stage, pp)
        out[name] = leaf[layers.start:layers.stop]
    return out


def _apply_layers(layer_fn: Callable, params: Dict, x: torch.Tensor):
    n = next(iter(params.values())).shape[0]
    for i in range(n):
        x = layer_fn(x, {k: v[i] for k, v in params.items()})
    return x


def pipeline_forward(layer_fn: Callable, group):
    """The pipelined forward over ``group`` (this rank's ``PPGroup``):
    ``run(params, x)`` takes this stage's layers of the layer-stacked
    params (leaves ``[L/pp, ...]``, :func:`stage_params`) and ``x`` of
    shape ``[M, ...]`` (M microbatches; each rides the pipeline whole,
    and ``layer_fn`` keeps its shape), and returns the forward's output
    ``[M, ...]`` on every rank of the group."""

    def run(params: Dict, x: torch.Tensor) -> torch.Tensor:
        M = x.shape[0]
        outs = []
        for m in range(M):
            if group.first:
                xm = x[m]
            else:
                xm = group.recv_prev(group.post_recv(x.shape[1:], x.dtype,
                                                     tag=m))
            y = _apply_layers(layer_fn, params, xm)
            if group.last:
                outs.append(y)
            else:
                group.send_next(y, tag=m)
        group.wait_sends()
        out = torch.stack(outs) if group.last else torch.empty_like(x)
        return group.share_last(out)

    return run


def reference_forward(layer_fn: Callable):
    """Sequential single-process forward over the whole params, for
    parity checks: each microbatch through every layer."""

    def run(params: Dict, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([_apply_layers(layer_fn, params, x[m])
                            for m in range(x.shape[0])])

    return run
