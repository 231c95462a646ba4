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

Everything here is stdlib-only and cheap: one dict append under a lock
per engine step.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Step kinds, in scheduling order. "spec_verify" and "fused" are steps
# this engine does not take yet; they stay so the /debug/steps schema and
# the Prometheus label set equal the JAX engine's.
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
    ) -> dict:
        """Append one step record; returns it (tests inspect the shape)."""
        hbm_bytes = (
            forwards * self.param_bytes
            + (kv_read_tokens + kv_write_tokens) * self.kv_token_bytes
        )
        with self._lock:
            self.recorded_total += 1
            rec = {
                "step": self.recorded_total,
                "ts_unix": time.time(),
                "kind": kind,
                "wall_s": round(wall_s, 6),
                "rows": rows,
                "tokens": tokens,
                "forwards": forwards,
                "kv_read_tokens": kv_read_tokens,
                "kv_write_tokens": kv_write_tokens,
                "hbm_bytes": hbm_bytes,
                "batched": batched,
            }
            self._ring.append(rec)
            agg = self._kinds.setdefault(kind, [0.0, 0, 0, 0])
            agg[0] += wall_s
            agg[1] += 1
            agg[2] += tokens
            agg[3] += hbm_bytes
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
        }
