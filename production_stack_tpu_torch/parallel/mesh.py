"""Rank layout of a sharded engine (dp x pp x tp).

The port's own copy of ``mesh_shape_for`` and ``build_mesh`` of
``production_stack_tpu/parallel/mesh.py``. Where the JAX engine builds a
``jax.sharding.Mesh`` over its devices, the port runs one process a rank,
so :func:`build_mesh` gives a :class:`RankLayout`: the axis sizes and the
device of each rank, tp innermost. Tensor parallelism is the only axis
that may exceed 1 here (data and pipeline parallelism are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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
    innermost: rank ``r`` is tp index ``r % tp``)."""

    shape: Dict[str, int]
    devices: List[torch.device]

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank]


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
    if dp > 1 or pp > 1:
        raise NotImplementedError(
            "data and pipeline parallelism are not supported by the torch "
            "engine yet")
    return RankLayout({"dp": dp, "pp": pp, "tp": tp}, devices)
