"""The point-to-point transfers of a pipeline-parallel forward.

One :class:`PPGroup` a rank: the ranks of one replica at one tp index,
one a stage, in stage order (``parallel/mesh.py``). The engine makes its
groups with :func:`create_groups`, once on every rank, in the same order
(``new_group`` must be called by every rank for every group, or the job
hangs). The backend follows ``TPGroup``'s choice (``parallel/tp.py``):
NCCL where every rank has a card of its own, gloo where ranks share a
card or run on the CPU. The choice is no fallback: a transfer that fails
raises, and the engine's step fails with it.

A forward calls, in the same order on every rank of the group:

- :meth:`PPGroup.send_next` / :meth:`PPGroup.recv_prev`: one
  microbatch's activations, from a stage to the next. Sends are
  asynchronous (``isend``), so a stage goes on to its next microbatch
  while the next stage still receives; :meth:`PPGroup.wait_sends` ends a
  forward's sends;
- :meth:`PPGroup.share_last`: the last stage's hidden states, broadcast
  to every stage, so sampling runs replicated on the same bits, as under
  tensor parallelism. (The JAX engine shares them by a float32 ``psum``
  that only the last stage feeds, which is exact too.)

Every transfer moves the tensor's bytes (a ``uint8`` view), so any dtype
crosses bit for bit. gloo has no point-to-point on card tensors (its
``send``/``recv`` take CPU tensors only), so under gloo a card tensor is
staged through pinned host memory: the sender copies it out and waits
for the copy, the receiver copies it in on its stream. gloo's broadcast
takes card tensors and stages them itself. NCCL moves card tensors as
they are; its communicators connect lazily, so :func:`create_groups`
warms every pair before the first forward.

With ``timing`` on, each transfer synchronizes the card before and after
it and adds its host seconds to ``p2p_s`` or ``share_s`` (off while
serving): what the point-to-point and the share cost a step.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from production_stack_tpu_torch.parallel.tp import (
    TPGroup,
    job_backend,
    member_group,
)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as a flat ``uint8`` view (contiguous)."""
    return x.contiguous().view(-1).view(torch.uint8)


class PPGroup:
    def __init__(self, stage: int, ranks: List[int], device: torch.device,
                 backend: str, group):
        self.stage = stage
        self.size = len(ranks)
        self.ranks = list(ranks)  # global ranks, stage order
        self.device = torch.device(device)
        self.backend = backend
        self.group = group  # None: the job's default (gloo) group
        self.first = stage == 0
        self.last = stage == self.size - 1
        self.prev = None if self.first else ranks[stage - 1]
        self.next = None if self.last else ranks[stage + 1]
        # Card tensors cross gloo's point-to-point through the host.
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.sends_total = 0
        self.recvs_total = 0
        self.shares_total = 0
        self.p2p_bytes = 0
        self.p2p_s = 0.0
        self.share_s = 0.0
        self.timing = False
        self._sends: list = []  # (work, buffer) of the sends in flight

    @classmethod
    def create(cls, ranks: List[int], device: torch.device) -> "PPGroup":
        """A group of ``ranks`` (stage order) of a job in which every rank
        calls this once, in the same order, with the same list (a job of
        one pipeline: ``ranks`` covers it)."""
        device = torch.device(device)
        backend, _ = job_backend(device)
        group = member_group([list(ranks)], backend)
        out = cls(list(ranks).index(dist.get_rank()), ranks, device,
                  backend, group)
        out.warm()
        return out

    # -- transport ---------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _isend(self, x: torch.Tensor, dst: int, tag: int):
        """Start sending ``x`` to global rank ``dst``: (work, the buffer
        that must live until the work ends)."""
        buf = _bytes(x)
        if self.staged:
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            # gloo reads the buffer from its own thread: the copy (and the
            # work that made x) must be done first.
            torch.cuda.current_stream(self.device).synchronize()
            buf = host
        self.p2p_bytes += buf.numel()
        return dist.isend(buf, dst=dst, group=self.group, tag=tag), buf

    def _irecv(self, shape, dtype, src: int, tag: int):
        """Start receiving a ``shape``/``dtype`` tensor from ``src``:
        (work, byte buffer, the tensor the buffer's bytes make)."""
        out = torch.empty(shape, dtype=dtype, device=self.device)
        buf = _bytes(out)
        if self.staged:
            buf = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        return dist.irecv(buf, src=src, group=self.group, tag=tag), buf, out

    def _finish_recv(self, pending) -> torch.Tensor:
        work, buf, out = pending
        work.wait()
        if self.staged:
            _bytes(out).copy_(buf, non_blocking=True)
        return out

    # -- the pipeline's transfers -----------------------------------------
    def send_next(self, x: torch.Tensor, tag: int = 0) -> None:
        """Send one microbatch's activations to the next stage (returns at
        once; :meth:`wait_sends` ends the sends)."""
        if self.timing:
            self._sync()
            t0 = time.perf_counter()
            work, buf = self._isend(x, self.next, tag)
            work.wait()
            self._sync()
            self.p2p_s += time.perf_counter() - t0
        else:
            self._sends.append(self._isend(x, self.next, tag))
        self.sends_total += 1

    def post_recv(self, shape, dtype, tag: int = 0):
        """Post the receive of one microbatch from the previous stage;
        :meth:`recv_prev` waits for it."""
        return self._irecv(shape, dtype, self.prev, tag)

    def recv_prev(self, pending) -> torch.Tensor:
        """The activations of a posted receive, on this rank's device."""
        t0 = time.perf_counter()
        out = self._finish_recv(pending)
        if self.timing:
            self._sync()
            self.p2p_s += time.perf_counter() - t0
        self.recvs_total += 1
        return out

    def wait_sends(self) -> None:
        """Wait for every send in flight."""
        for work, _buf in self._sends:
            work.wait()
        self._sends = []

    def share_last(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's ``x`` on every stage (``x`` is the last
        stage's value there, and a buffer of its shape and dtype
        elsewhere)."""
        return self.share_from(x, self.size - 1)

    def share_from(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """Stage ``stage``'s ``x`` on every stage (a broadcast)."""
        if self.timing:
            self._sync()
        t0 = time.perf_counter()
        x = x.contiguous()
        dist.broadcast(_bytes(x), src=self.ranks[stage], group=self.group)
        if self.timing:
            self._sync()
            self.share_s += time.perf_counter() - t0
        self.shares_total += 1
        return x

    def rotate(self, x: torch.Tensor, tag: int = 0) -> torch.Tensor:
        """A ring step: send ``x`` to the next rank of the group (the last
        to the first) and return what the previous one sent (ring
        attention's K/V rotation)."""
        nxt = self.ranks[(self.stage + 1) % self.size]
        prv = self.ranks[(self.stage - 1) % self.size]
        if self.timing:
            self._sync()
        t0 = time.perf_counter()
        if self.backend == "nccl":
            # Grouped, so that every rank's send meets its peer's receive.
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x.contiguous(), nxt, self.group),
                   dist.P2POp(dist.irecv, out, prv, self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        else:
            pending = self._irecv(x.shape, x.dtype, prv, tag)
            work, _buf = self._isend(x, nxt, tag)
            out = self._finish_recv(pending)
            work.wait()
        if self.timing:
            self._sync()
            self.p2p_s += time.perf_counter() - t0
        self.sends_total += 1
        self.recvs_total += 1
        return out

    def warm(self) -> None:
        """One transfer over every link the forward uses (and the share):
        NCCL connects a pair at its first transfer."""
        one = torch.zeros((1,), dtype=torch.float32, device=self.device)
        pending = None if self.first else self.post_recv((1,), one.dtype)
        if not self.last:
            self.send_next(one)
        if pending is not None:
            self.recv_prev(pending)
        self.wait_sends()
        self.share_last(one)
        self._sync()
        self.reset_counters()

    def reset_counters(self) -> None:
        self.sends_total = self.recvs_total = self.shares_total = 0
        self.p2p_bytes = 0
        self.p2p_s = self.share_s = 0.0

    def counters(self) -> dict:
        return {"sends_total": self.sends_total,
                "recvs_total": self.recvs_total,
                "shares_total": self.shares_total,
                "p2p_bytes": self.p2p_bytes,
                "p2p_s": self.p2p_s, "share_s": self.share_s}


def create_groups(layout, rank: int, device: torch.device
                  ) -> Tuple[Optional[TPGroup], Optional[PPGroup], str, int]:
    """This rank's tensor-parallel and pipeline groups of ``layout``
    (``parallel/mesh.py``; None where that axis is 1), the backend and how
    many ranks share this rank's device. Every rank of the job calls this
    once, in the same order: it creates every tp group, then every pp
    group, on every rank."""
    device = torch.device(device)
    backend, sharing = job_backend(device)
    tp_handle = member_group(layout.tp_groups(), backend)
    pp_handle = member_group(layout.pp_groups(), backend)
    _dp, stage, tp_index = layout.coords(rank)
    tpg = ppg = None
    if layout.shape["tp"] > 1:
        tpg = TPGroup(tp_index, layout.shape["tp"], device, backend,
                      tp_handle, sharing)
    if layout.shape["pp"] > 1:
        ppg = PPGroup(stage, layout.pp_group(rank), device, backend,
                      pp_handle)
        ppg.warm()
    return tpg, ppg, backend, sharing
