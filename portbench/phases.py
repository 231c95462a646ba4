"""The engine's step phases, as the phase readers of ``metrics/`` use
them.

Each step record carries ``phases`` (``obs/steps.py::PhaseClock`` in the
port): contiguous ``[name, start, wall_s, cpu_s]`` from the wait for the
step lock (``lock``) to the record's end, ``start`` on ``time.time()``'s
clock (the clock ``devtrace.align`` puts the device trace on) and
``cpu_s`` the engine thread's CPU seconds over the phase. A decode
burst's phases, in order: ``lock``, ``plan``, (``flush_prefills``, the
deferred first tokens, each one's wait for the card a ``readback``),
``build``, ``launch``, ``readback``, ``emit``.

Decode-burst steps are those begun in the traced window, as
``metrics/decode_ms_per_forward.py`` counts them, that also end inside
it: the step still running at the profiler's stop waits out the
profiler's processing of the window (tens of seconds of the engine
thread off the CPU), which would outweigh the rest of the window. Every
function returns None where the run has nothing to read: no step record
with phases (a program without the phase clock), no trace, no device
activity.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from portbench import layer

DECODE = ("decode_burst",)


def decode_steps(run) -> List[dict]:
    """The decode-burst steps with phases that begin and end inside the
    traced window."""
    return [s for s in run.steps
            if s["kind"] in DECODE and s.get("phases")
            and run.dev_open <= s["start"] and s["end"] <= run.dev_close]


def phase_seconds(steps, name: str) -> float:
    return sum(p[2] for s in steps for p in s["phases"] if p[0] == name)


def launch_ms_per_forward(run) -> Optional[float]:
    steps = decode_steps(run)
    forwards = sum(s["forwards"] for s in steps)
    if forwards <= 0:
        return None
    return 1000.0 * phase_seconds(steps, "launch") / forwards


def emit_us_per_token(run) -> Optional[float]:
    steps = decode_steps(run)
    tokens = sum(s["tokens"] for s in steps)
    if tokens <= 0:
        return None
    return 1e6 * phase_seconds(steps, "emit") / tokens


def offcpu_pct(run) -> Optional[float]:
    """The share of the engine thread's wall time in decode bursts, every
    phase but the readback waits, in which it ran on no CPU: waiting for
    the interpreter lock, for the step lock, or descheduled."""
    wall = cpu = 0.0
    for s in decode_steps(run):
        for name, _start, w, c in s["phases"]:
            if name != "readback":
                wall += w
                cpu += c
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_launch_pct(run) -> Optional[float]:
    """The traced window's device idle seconds that fall inside the
    launch phases of decode bursts (any burst's: the idle gaps are
    clipped to the window), over all its idle seconds."""
    if not layer._traced(run):
        return None
    launches = sorted((p[1], p[1] + p[2]) for s in run.steps
                      if s["kind"] in DECODE
                      for p in s.get("phases") or () if p[0] == "launch")
    if not launches:
        return None
    gaps = [(s, s + g) for s, g in
            run.trace.idle_gaps(run.dev_open, run.dev_close)]
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    return 100.0 * _overlap(gaps, launches) / idle


def kernels_per_forward(run) -> Optional[float]:
    """Device activities (kernels, copies, fills) that start inside the
    spans of decode bursts, from the start of a burst's first phase to
    its record's end, over those bursts' forwards."""
    if not layer._traced(run):
        return None
    steps = decode_steps(run)
    forwards = sum(s["forwards"] for s in steps)
    if forwards <= 0:
        return None
    starts = sorted(st for _, st, _ in run.trace.events)
    count = 0
    for s in steps:
        a, b = s["phases"][0][1], s["end"]
        count += bisect.bisect_left(starts, b) - bisect.bisect_left(starts,
                                                                    a)
    return count / forwards
