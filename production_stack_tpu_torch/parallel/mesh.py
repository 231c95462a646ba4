"""Rank layout of a sharded engine (dp x pp x tp).

The port's own copy of ``mesh_shape_for`` and ``build_mesh`` of
``production_stack_tpu/parallel/mesh.py``. Where the JAX engine builds a
``jax.sharding.Mesh`` over its devices, the port runs one process a rank,
so :func:`build_mesh` gives a :class:`RankLayout`: the axis sizes, the
device of each rank, and the coordinates and groups of the ranks, in the
JAX mesh's order (dp outermost, pp in the middle, tp innermost).

- a **tp group** is the ranks of one pipeline stage of one replica: they
  split every weight and add their partial sums (``parallel/tp.py``);
- a **pp group** is the ranks of one replica at one tp index, one a
  stage: activations pass along it (``parallel/pp.py``);
- a **replica** is the ``pp x tp`` ranks of one dp index: it holds the
  model whole. No leaf and no pool names ``dp``, so every replica
  computes what the others do, as on the JAX mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def mesh_shape_for(
    n_devices: int,
    tensor_parallel_size: int = 1,
    data_parallel_size: int = 0,
    pipeline_parallel_size: int = 1,
) -> "tuple[int, int, int]":
    """Resolve (dp, pp, tp) from requested sizes and available devices."""
    tp = max(tensor_parallel_size, 1)
    pp = max(pipeline_parallel_size, 1)
    if n_devices % (tp * pp) != 0:
        raise ValueError(
            f"tensor_parallel_size {tp} x pipeline_parallel_size {pp} "
            f"does not divide device count {n_devices}"
        )
    dp = data_parallel_size or n_devices // (tp * pp)
    if dp * pp * tp != n_devices:
        raise ValueError(
            f"dp*pp*tp = {dp}*{pp}*{tp} != available devices {n_devices}"
        )
    return dp, pp, tp


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Axis sizes and the device of each rank (rank-major, tp
    innermost: rank ``r`` is tp index ``r % tp``, stage
    ``(r // tp) % pp``, replica ``r // (pp * tp)``)."""

    shape: Dict[str, int]
    devices: List[torch.device]

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank]

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """``(dp, pp, tp)`` indices of ``rank``."""
        pp, tp = self.shape["pp"], self.shape["tp"]
        return rank // (pp * tp), (rank // tp) % pp, rank % tp

    def rank_of(self, dp: int, pp: int, tp: int) -> int:
        return (dp * self.shape["pp"] + pp) * self.shape["tp"] + tp

    def tp_groups(self) -> List[List[int]]:
        """Every tp group, in rank order."""
        s = self.shape
        return [[self.rank_of(d, p, t) for t in range(s["tp"])]
                for d in range(s["dp"]) for p in range(s["pp"])]

    def pp_groups(self) -> List[List[int]]:
        """Every pp group (stage 0 first), in rank order of stage 0."""
        s = self.shape
        return [[self.rank_of(d, p, t) for p in range(s["pp"])]
                for d in range(s["dp"]) for t in range(s["tp"])]

    def replicas(self) -> List[List[int]]:
        """Every replica's ranks."""
        n = self.shape["pp"] * self.shape["tp"]
        return [list(range(d * n, (d + 1) * n))
                for d in range(self.shape["dp"])]

    def tp_group(self, rank: int) -> List[int]:
        return next(g for g in self.tp_groups() if rank in g)

    def pp_group(self, rank: int) -> List[int]:
        return next(g for g in self.pp_groups() if rank in g)

    def replica(self, rank: int) -> List[int]:
        return next(g for g in self.replicas() if rank in g)


def default_devices(device: str, n: int) -> List[torch.device]:
    """A device a rank on one host: rank ``r`` on ``cuda:(r % cards)``
    (ranks share cards when there are fewer cards than ranks), or every
    rank on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            f"(pass device='cpu' to run on the CPU)")
    return [torch.device("cuda", r % cards) for r in range(n)]


def build_mesh(
    tensor_parallel_size: int = 1,
    data_parallel_size: int = 0,
    pipeline_parallel_size: int = 1,
    devices: Optional[Sequence] = None,
) -> RankLayout:
    """The rank layout over ``devices`` (a device a rank). dp outermost,
    pp in the middle, tp innermost, as the JAX mesh orders them."""
    devices = [torch.device(d) for d in devices]
    dp, pp, tp = mesh_shape_for(
        len(devices), tensor_parallel_size, data_parallel_size,
        pipeline_parallel_size)
    return RankLayout({"dp": dp, "pp": pp, "tp": tp}, devices)
