"""Step flight recorder: per-engine-step records + roofline accounting.

The port's own copy of ``production_stack_tpu/obs/steps.py`` (the port
imports nothing of the JAX package). ``EngineCore._loop`` appends one
record per model step (prefill, budgeted prefill chunk step or decode
burst) carrying the batch composition, the scheduled token count, the
measured wall time and an *estimated* device-memory byte count from a
small roofline model:

    bytes ~ forwards x param_bytes            (weight reads)
          + kv_read_tokens  x kv_token_bytes  (paged-attention KV reads)
          + kv_write_tokens x kv_token_bytes  (KV page writes)

The derived ``tpu:model_bandwidth_utilization`` gauge is the achieved
bytes/s over the recent step window against the card's memory rate.
The series keep the JAX engine's ``tpu:`` names, so the router and the
dashboards read them unchanged.

A step's record also carries its ``phases`` (the port's own addition):
the engine thread's :class:`PhaseClock` splits the step as it runs into
contiguous phases, from the wait for the step lock to the record's end
(``ts_unix``), each stored as ``[name, start, wall_s, cpu_s]``:

- ``start`` on ``time.time()``'s clock, the clock a device trace is
  aligned to, so a phase can be laid over the card's idle gaps;
- ``wall_s`` the phase's wall time (``perf_counter``, monotonic);
- ``cpu_s`` the engine thread's CPU time over the phase
  (``time.thread_time()``): wall time without it is time spent waiting
  for the interpreter lock or descheduled.

A decode burst's phases, in order: ``lock`` (from the scheduler's choice
to holding the step lock), ``plan`` (the burst width, block accounting
and preemption, offload spills), ``flush_prefills`` (deferred first
tokens handed out, each one's wait for the card a ``readback`` of its
own), ``build`` (the per-row host arrays), ``launch`` (the dispatch of
the burst's forwards), ``readback`` (the wait for the previous burst's
tokens) and ``emit`` (handing them to their streams). Prefill,
prefill-chunk and fused steps mark the same names where they apply. The
record's own ``wall_s`` still starts where the step lock is held.

The recorder keeps per-kind, per-phase rollups of both (``phases`` in
``/debug/steps``' summary; ``tpu:step_phase_seconds_total{kind,phase}``
and ``tpu:step_phase_cpu_seconds_total{kind,phase}`` at ``/metrics``, a
phase's series appearing with the first step that has it). No flag of
its own: without the recorder no phase is stored and no thread CPU
clock is read. The engine's ``dispatch_enqueue_s`` (launch phases),
``flush_time_total`` (``readback`` and ``flush_prefills``),
``decode_time_total`` and ``prefill_time_total`` (a record's bounds)
take their seconds from the same stamps.

Everything here is stdlib-only and cheap: one dict append under a lock
per engine step, two clock reads a phase.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Step kinds, in scheduling order, the JAX engine's: a speculative verify
# burst is "spec_verify", a step plan and a decode burst launched as one
# dispatch (--fused-step) is "fused".
STEP_KINDS = ("prefill", "prefill_chunk", "decode_burst", "spec_verify",
              "fused")

# Device memory rate (bytes/s) for the utilization gauge: the NVIDIA H100
# SXM's 3.35 TB/s HBM3 (the figure the port's kernel bounds use,
# ``probes/common.py::HBM_BYTES_PER_S``); override per deployment with
# TPU_STACK_HBM_GBS (decimal bytes/s).
DEFAULT_HBM_BYTES_PER_S = 3.35e12


def device_hbm_bytes_per_s() -> float:
    try:
        return float(os.environ.get("TPU_STACK_HBM_GBS", "") or
                     DEFAULT_HBM_BYTES_PER_S)
    except ValueError:
        return DEFAULT_HBM_BYTES_PER_S


class PhaseClock(threading.local):
    """The phases of the step the calling thread runs, contiguous by
    construction: :meth:`mark` closes the open phase and opens the next
    at one stamp. Each phase is ``[name, start, wall_s, cpu_s]``:
    ``start`` on ``time.time()``'s clock, ``wall_s`` its wall seconds,
    ``cpu_s`` the thread's CPU seconds over it (``time.thread_time()``;
    0 when ``cpu`` is off). Stamps are ``perf_counter`` readings moved
    onto ``time.time()``'s clock by one offset read when the step
    starts, so durations stay monotonic.

    Thread-local: only the thread that started a step sees it running,
    so another thread's call into the same code (one that holds the step
    lock between steps, say) marks nothing. Outside a step :meth:`mark`
    and :meth:`close` do nothing and return None."""

    def __init__(self, cpu: bool = True):
        self.cpu = cpu
        self.phases: List[list] = []
        self._open: Optional[list] = None
        self._offset = 0.0
        self._cpu0 = 0.0

    @property
    def current(self) -> Optional[str]:
        """The open phase's name; None outside a step."""
        return self._open[0] if self._open is not None else None

    def start(self, name: str) -> float:
        """Begin a step with phase ``name``; returns its start."""
        self.phases = []
        self._open = None
        self._offset = time.time() - time.perf_counter()
        return self._next(name)

    def mark(self, name: str) -> Optional[float]:
        """Close the open phase and open ``name``; returns the open
        phase's start (the stamp; a mark of the phase already open
        continues it and reads no clock)."""
        ph = self._open
        if ph is None:
            return None
        if ph[0] == name:
            return ph[1]
        return self._next(name)

    def close(self) -> Optional[float]:
        """Close the open phase and end the step; returns the stamp."""
        if self._open is None:
            return None
        return self._next(None)

    def _next(self, name: Optional[str]) -> float:
        t = time.perf_counter() + self._offset
        c = time.thread_time() if self.cpu else 0.0
        ph = self._open
        if ph is not None:
            ph[2] = t - ph[1]
            ph[3] = c - self._cpu0
        if name is None:
            self._open = None
        else:
            self._open = [name, t, 0.0, 0.0]
            self.phases.append(self._open)
        self._cpu0 = c
        return t


class StepRecorder:
    """Bounded ring buffer of per-step records plus per-kind rollups.

    Thread-safe: the engine thread records, ``/metrics`` and
    ``/debug/steps`` read concurrently from the event loop.
    """

    def __init__(
        self,
        capacity: int = 1024,
        param_bytes: int = 0,
        kv_token_bytes: int = 0,
        hbm_bytes_per_s: Optional[float] = None,
        window_s: float = 60.0,
    ):
        self.capacity = max(1, int(capacity))
        # Roofline constants. param_bytes is often unknown at construction
        # (weights load after the recorder exists); the core fills it in
        # lazily before the first record.
        self.param_bytes = int(param_bytes)
        self.kv_token_bytes = int(kv_token_bytes)
        self.hbm_bytes_per_s = float(
            hbm_bytes_per_s if hbm_bytes_per_s is not None
            else device_hbm_bytes_per_s())
        self.window_s = float(window_s)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        # kind -> [wall_s_sum, count, tokens, hbm_bytes]
        self._kinds: Dict[str, List[float]] = {
            k: [0.0, 0, 0, 0] for k in STEP_KINDS}
        # kind -> phase -> [wall_s_sum, cpu_s_sum]
        self._phases: Dict[str, Dict[str, List[float]]] = {}
        self.recorded_total = 0

    # -- recording --------------------------------------------------------

    def record(
        self,
        kind: str,
        wall_s: float,
        *,
        rows: int = 0,
        tokens: int = 0,
        forwards: int = 1,
        kv_read_tokens: int = 0,
        kv_write_tokens: int = 0,
        batched: bool = False,
        phases: Optional[List[list]] = None,
        end: Optional[float] = None,
    ) -> dict:
        """Append one step record; returns it (tests inspect the shape).
        ``end`` is the step's end on ``time.time()``'s clock (now when
        omitted), ``phases`` its :class:`PhaseClock` phases."""
        hbm_bytes = (
            forwards * self.param_bytes
            + (kv_read_tokens + kv_write_tokens) * self.kv_token_bytes
        )
        with self._lock:
            self.recorded_total += 1
            rec = {
                "step": self.recorded_total,
                "ts_unix": time.time() if end is None else end,
                "kind": kind,
                "wall_s": round(wall_s, 6),
                "rows": rows,
                "tokens": tokens,
                "forwards": forwards,
                "kv_read_tokens": kv_read_tokens,
                "kv_write_tokens": kv_write_tokens,
                "hbm_bytes": hbm_bytes,
                "batched": batched,
                "phases": phases or [],
            }
            self._ring.append(rec)
            agg = self._kinds.setdefault(kind, [0.0, 0, 0, 0])
            agg[0] += wall_s
            agg[1] += 1
            agg[2] += tokens
            agg[3] += hbm_bytes
            for name, _start, wall, cpu in rec["phases"]:
                tot = self._phases.setdefault(kind, {}).setdefault(
                    name, [0.0, 0.0])
                tot[0] += wall
                tot[1] += cpu
        return rec

    # -- retrieval --------------------------------------------------------

    def snapshot(self, limit: Optional[int] = None,
                 kind: Optional[str] = None) -> List[dict]:
        """Newest-first list of records, optionally filtered by kind."""
        with self._lock:
            recs = list(self._ring)
        out = []
        for rec in reversed(recs):
            if kind is not None and rec["kind"] != kind:
                continue
            out.append(rec)
            if limit is not None and len(out) >= limit:
                break
        return out

    def kind_stats(self) -> Dict[str, dict]:
        """Lifetime per-kind rollups (every known kind always present, so
        the Prometheus series never vanish between scrapes)."""
        with self._lock:
            return {
                k: {"wall_s": v[0], "count": v[1], "tokens": v[2],
                    "hbm_bytes": v[3]}
                for k, v in self._kinds.items()
            }

    def phase_stats(self) -> Dict[str, Dict[str, dict]]:
        """Lifetime per-kind, per-phase wall and CPU seconds (a phase
        appears with the first record that carries it)."""
        with self._lock:
            return {
                kind: {name: {"wall_s": v[0], "cpu_s": v[1]}
                       for name, v in by_phase.items()}
                for kind, by_phase in self._phases.items()
            }

    def bandwidth_utilization(self, now: Optional[float] = None) -> float:
        """Achieved HBM bytes/s over the recent step window divided by the
        device floor: estimated bytes moved by steps that STARTED inside
        the window, over their summed wall time (model-active seconds, not
        wall-clock — idle gaps between steps are not a bandwidth claim)."""
        if now is None:
            now = time.time()
        cutoff = now - self.window_s
        with self._lock:
            wall = 0.0
            moved = 0
            for rec in self._ring:
                if rec["ts_unix"] - rec["wall_s"] >= cutoff:
                    wall += rec["wall_s"]
                    moved += rec["hbm_bytes"]
        if wall <= 0.0 or self.hbm_bytes_per_s <= 0.0:
            return 0.0
        return (moved / wall) / self.hbm_bytes_per_s

    def summary(self) -> dict:
        """Header block for /debug/steps (everything but the records)."""
        return {
            "capacity": self.capacity,
            "recorded_total": self.recorded_total,
            "param_bytes": self.param_bytes,
            "kv_token_bytes": self.kv_token_bytes,
            "hbm_bytes_per_s": self.hbm_bytes_per_s,
            "window_s": self.window_s,
            "bandwidth_utilization": round(self.bandwidth_utilization(), 6),
            "kinds": self.kind_stats(),
            "phases": self.phase_stats(),
        }
