"""The collectives of a tensor-parallel forward.

One :class:`TPGroup` a rank, made once by every rank of the job
(:meth:`TPGroup.create`). Its backend follows from the device map, which
the ranks exchange on the job's gloo group: NCCL where every rank has a
card of its own, gloo where ranks share a card or run on the CPU (NCCL
refuses two ranks on one device). The choice is no fallback: a
collective that fails raises, and the engine's step fails with it.

The model calls two collectives, in the same order on every rank:

- :meth:`TPGroup.all_reduce`: the sum of the row-parallel products
  (after ``wo`` and after the MLP's down projection; Mixtral's expert
  sums), reduced in float32 and cast back to the activation dtype, so a
  bf16 model adds its partial sums in float32 as a single-card product
  accumulates them;
- :meth:`TPGroup.gather_last`: the vocab shards of the logits, into the
  full vocabulary on every rank (an all-reduce of a zero-filled
  full-vocab buffer, which gloo and NCCL both run on card tensors), so
  sampling runs replicated, on the same bits everywhere.

With ``timing`` on, each collective synchronizes the card before and
after it and adds its host seconds to ``collective_s``: the share of a
step spent in the collectives (off while serving).
"""

from __future__ import annotations

import socket
import time
from typing import List, Tuple

import torch
import torch.distributed as dist


class TPGroup:
    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, group, sharing: int):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.group = group  # None: the job's default (gloo) group
        # Ranks placed on this rank's device (itself included).
        self.sharing = sharing
        self.collectives_total = 0
        self.collective_s = 0.0
        self.timing = False

    @classmethod
    def create(cls, rank: int, size: int,
               device: torch.device) -> "TPGroup":
        """Every rank of a job of ``size`` processes, all one tp group,
        calls this once, in the same order: the ranks exchange (host,
        device) and pick the backend. An engine whose job also has
        pipeline stages or data-parallel replicas makes its groups with
        :func:`production_stack_tpu_torch.parallel.pp.create_groups`."""
        if not dist.is_initialized() or dist.get_world_size() != size:
            raise RuntimeError(
                f"tensor_parallel_size {size} needs a torch.distributed job "
                f"of {size} processes (multihost.initialize_from_env)")
        device = torch.device(device)
        backend, sharing = job_backend(device)
        group = member_group([list(range(size))], backend)
        return cls(rank, size, device, backend, group, sharing)

    def _run(self, fn, *args):
        if not self.timing:
            fn(*args, group=self.group)
            self.collectives_total += 1
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn(*args, group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.collective_s += time.perf_counter() - t0
        self.collectives_total += 1

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, added in float32, in x's dtype
        (a float32 ``x`` is reduced in place)."""
        y = x.float().contiguous()
        self._run(dist.all_reduce, y)
        return y.to(x.dtype)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' shards of the last axis, concatenated in rank order
        (float32)."""
        n = x.shape[-1]
        full = torch.zeros(x.shape[:-1] + (n * self.size,),
                           dtype=torch.float32, device=x.device)
        full[..., self.rank * n:(self.rank + 1) * n] = x
        self._run(dist.all_reduce, full)
        return full

    def min_int(self, value: int) -> int:
        """The least of the ranks' ``value``."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())

    def barrier(self) -> None:
        """Wait for every rank (a one-element all-reduce, card work
        included where the backend orders it)."""
        self.min_int(0)


def job_backend(device: torch.device) -> Tuple[str, int]:
    """The backend of the job's groups and how many ranks share this
    rank's device. Every rank of the job calls this once, in the same
    order: the ranks exchange (host, device) on the job's gloo group.
    NCCL where every rank has a card of its own, gloo otherwise."""
    world = dist.get_world_size()
    ident = (socket.gethostname(), str(device))
    idents: List = [None] * world
    dist.all_gather_object(idents, ident)
    sharing = sum(1 for i in idents if i == ident)
    nccl = (device.type == "cuda" and len(set(idents)) == world
            and dist.is_nccl_available())
    return ("nccl" if nccl else "gloo"), sharing


def member_group(groups: List[List[int]], backend: str):
    """The ``torch.distributed`` group of this rank among ``groups`` (each
    a list of global ranks; together they cover the job). Every rank calls
    this with the same lists in the same order, since ``new_group`` must
    be called by every rank for every group, or the job hangs. None
    stands for the job's own (gloo) group; a group of one rank gets no
    handle."""
    me, world = dist.get_rank(), dist.get_world_size()
    mine = None
    for ranks in groups:
        if len(ranks) < 2:
            continue
        if backend == "gloo" and len(ranks) == world:
            handle = None
        else:
            handle = dist.new_group(ranks=list(ranks), backend=backend)
        if me in ranks:
            mine = handle
    return mine

