"""The device trace of a traced run's window, kept as aggregates.

``torch.profiler`` records the card's activity (CUDA only: no CPU-op
recording slows the engine thread) from the window's opening to its
close. Only the device activities are read back, straight from the
profiler's results (no full event tree, no trace file): their names,
starts and durations. A marker kernel on a side stream at each end of
the window ties the trace's clock to ``time.time()``.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

# Frozen name patterns (``re.search`` on the demangled kernel name).
MATMUL = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|matmul|splitKreduce",
                    re.IGNORECASE)
PAGED_DECODE = re.compile(r"\bpaged_decode_(mma|f32)_kernel")
CACHED_PREFILL = re.compile(r"\bprefill_(mma|f32)_kernel")
MARKER = re.compile(r"bucketize", re.IGNORECASE)


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    # (name, start on time.time()'s clock in s, duration in s) of every
    # device activity but the markers.
    events: List[Tuple[str, float, float]]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((s, s + d) for _, s, d in self.events)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def seconds(self, pattern: re.Pattern) -> float:
        return sum(d for n, _, d in self.events if pattern.search(n))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, _, d in self.events:
            out[n] = out.get(n, 0.0) + d
        return out

    def idle_gaps(self, t_open: float, t_close: float):
        """(start, length) of each stretch of the window with nothing
        running on the card."""
        gaps, t = [], t_open
        for a, b in self.busy_intervals():
            a, b = max(a, t_open), min(b, t_close)
            if b <= a:
                continue
            if a > t:
                gaps.append((t, a - t))
            t = max(t, b)
        if t_close > t:
            gaps.append((t, t_close - t))
        return gaps


class Tracer:
    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device=device) if self.cuda else None
        self.prof = None
        self.marks: List[float] = []

    def _mark(self) -> None:
        if not self.cuda:  # a CPU rehearsal: no device, no marker
            return
        with torch.cuda.stream(self.stream):
            x = torch.zeros(8, device=self.device)
            self.marks.append(time.time())
            torch.bucketize(x, x)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[
            ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        self.prof.start()
        self._mark()

    def stop(self) -> None:
        self._mark()
        self.prof.stop()

    def result(self, t_open: float, t_close: float) -> DeviceTrace:
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            raw.append((ev.name(), ev.start_ns() * 1e-9,
                        ev.duration_ns() * 1e-9))
        self.prof = None
        return align(raw, self.marks, t_open, t_close)


def align(raw, marks: List[float], t_open: float,
          t_close: float) -> DeviceTrace:
    """Device events on ``time.time()``'s clock: shifted by the first
    marker's device start minus its host launch time (no shift when the
    trace is on that clock already or has no marker), markers dropped,
    clipped to the window."""
    marker_starts = sorted(s for n, s, _ in raw if MARKER.search(n))
    shift = 0.0
    if marker_starts and marks:
        off = marker_starts[0] - marks[0]
        # A trace already on the epoch clock needs no shift.
        if abs(off) > 5.0:
            shift = off
    events = []
    for n, s, d in raw:
        if MARKER.search(n):
            continue
        s -= shift
        a, b = max(s, t_open), min(s + d, t_close)
        if b > a:
            events.append((n, a, b - a))
    return DeviceTrace(window_s=t_close - t_open, events=events)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def label_gaps(gaps, steps: List[dict], t_open: float,
               n: int = 10) -> List[list]:
    """The window's idle time by what the engine's thread was doing on
    the host (the step record running at a gap's middle, or ``between
    steps``): the total of each, then the longest single gaps, ``n``
    entries in all."""
    spans = sorted((r["start"], r["end"], r["kind"]) for r in steps)

    def what(start, length):
        mid = start + length / 2
        for a, b, kind in spans:
            if a <= mid <= b:
                return f"in {kind} steps"
        return "between steps"

    labelled = [(what(s, g), s, g) for s, g in gaps]
    totals: Dict[str, list] = {}
    for label, _, g in labelled:
        t = totals.setdefault(label, [0.0, 0])
        t[0] += g
        t[1] += 1
    out = [[f"idle {label}: all {k} gaps", t]
           for label, (t, k) in sorted(totals.items(), key=lambda kv:
                                        -kv[1][0])]
    for label, s, g in sorted(labelled, key=lambda x: -x[2]):
        if len(out) >= n:
            break
        out.append([f"longest, {label} at +{s - t_open:.3f} s", g])
    return out[:n]


def kernel_seconds(trace: Optional[DeviceTrace],
                   pattern: re.Pattern) -> Optional[float]:
    if trace is None:
        return None
    s = trace.seconds(pattern)
    return s if s > 0 else None
