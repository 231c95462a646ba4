"""Interpreter-lock lag monitor, stall watchdog and component timers.

The port's counterpart of ``production_stack_tpu/obs/looplag.py`` (the
port imports nothing of the JAX package). The JAX server is one asyncio
event loop, and its monitor measures how late a ``call_later`` tick
fires on that loop. The port's server runs a thread for each connection
beside the engine thread, with no event loop; what every one of those
threads waits on instead is the interpreter lock. So here:

``LoopMonitor``
    A ticker thread of its own asks to wake every ``interval_s`` and
    records how late it woke into a bounded ring, with p50/p99/max
    rollups and stall counters bucketed by multiples of the threshold
    (the JAX monitor's ring, rollups and buckets). A woken thread must
    take the interpreter lock before it runs, so the lag is the lock
    wait that every server thread pays when another thread holds it:
    the engine thread's dispatch (its Python launches), a request
    handler's JSON, the structured-output mask rows built on the host.
    Whatever else delays a wake-up on a shared host (the OS scheduler)
    shows in it too.

``BlockingCallDetector``
    The watchdog, run by the ticker itself: when a tick wakes later than
    the stall threshold, it takes every other thread's stack
    (``sys._current_frames()``) and charges the lateness to the innermost
    frame (``file:line:func``) of each thread that runs Python, told by
    its CPU clock (``pthread_getcpuclockid``): a thread that
    gets CPU while the watchdog releases the lock for ``settle_s``, and
    none while the watchdog holds it for ``hold_s``, runs only with the
    lock. A thread parked in a call that releases the lock (a socket
    read, ``Condition.wait``, ``time.sleep``) gets no CPU, and one that
    spins without it (``torch.cuda.synchronize``, a torch CPU kernel)
    gets CPU while the watchdog holds the lock: neither is charged.
    Where the CPU times cannot be read, a thread is charged when its top
    frame or instruction moves while the lock is released. (A separate
    watchdog thread, as in the JAX module, would wait for the same lock
    as the ticker and see the same stalls no sooner.)

``LoopComponentTimers``
    Cumulative seconds per named component: ``add``, ``measure`` (a
    context manager around a synchronous section) and ``stats``. The
    JAX class's ``wrap`` drives a coroutine resume by resume to time the
    slices that hold the event loop; the port has no coroutines and no
    loop, so it has no ``wrap``.

``observe()`` and ``sample()`` take explicit ``now`` values (and
``sample()`` an explicit frame), as in the JAX module, so tests replay
stalls without live threads. Standard library only. The engine server
exports the rollups as the JAX server's ``tpu:event_loop_lag_*`` and
``tpu:loop_stalls_total{bucket}`` series and serves them at ``GET
/debug/loop`` (``--loop-monitor``).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: Stall severity buckets: (label, multiple of the stall threshold).
#: Each stall increments exactly one bucket, the highest it reaches, so
#: the buckets are disjoint and their sum is the total stall count.
STALL_BUCKETS = (("1x", 1.0), ("5x", 5.0), ("20x", 20.0))

#: Default stall threshold.
DEFAULT_STALL_THRESHOLD_S = 0.1

#: Default tick interval: lag resolution is one interval.
DEFAULT_TICK_INTERVAL_S = 0.05

#: Attribution key of a stall in which no other thread ran Python.
UNATTRIBUTED = "unattributed"


def _frame_location(frame) -> str:
    """``file:line:func`` with the filename shortened to its last two
    path components."""
    code = frame.f_code
    parts = code.co_filename.replace("\\", "/").split("/")
    short = "/".join(parts[-2:])
    return f"{short}:{frame.f_lineno}:{code.co_name}"


def _stack(frame) -> tuple:
    """``(key, stack)``: the innermost frame's location and up to eight
    locations outward."""
    stack = []
    while frame is not None and len(stack) < 8:
        stack.append(_frame_location(frame))
        frame = frame.f_back
    return stack[0], stack


def _cpu_ns(threads) -> Dict[int, int]:
    """CPU nanoseconds of each live thread of ``threads`` whose clock
    can be read (``pthread_getcpuclockid``)."""
    out = {}
    getclock = getattr(time, "pthread_getcpuclockid", None)
    if getclock is None:
        return out
    for t in threads:
        if not t.is_alive():
            continue
        try:
            out[t.ident] = time.clock_gettime_ns(getclock(t.ident))
        except (OSError, OverflowError, TypeError):
            pass
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class LoopComponentTimers:
    """Cumulative seconds per named component."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}

    def add(self, component: str, seconds: float) -> None:
        with self._lock:
            self._seconds[component] = (
                self._seconds.get(component, 0.0) + seconds)
            self._calls[component] = self._calls.get(component, 0) + 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {
                comp: {
                    "seconds": round(self._seconds[comp], 6),
                    "calls": self._calls.get(comp, 0),
                }
                for comp in sorted(self._seconds)
            }

    def measure(self, component: str):
        """Context manager timing a synchronous section."""
        return _MeasureCtx(self, component)


class _MeasureCtx:
    __slots__ = ("_timers", "_component", "_t0")

    def __init__(self, timers: LoopComponentTimers, component: str):
        self._timers = timers
        self._component = component

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc_info):
        self._timers.add(self._component,
                         time.perf_counter() - self._t0)
        return False


class BlockingCallDetector:
    """The stall watchdog (see the module docstring). ``sample`` is its
    one pass, which the ticker calls at each tick and a test calls with
    explicit ``now`` and ``frame`` to replay a stall: the JAX detector's
    pass and its watermark rule (``now - max(last_tick, previous
    pass)``). The ticker's ``last_tick`` is the time its tick was due,
    so at a tick the stall test is the lateness against the threshold,
    and each late tick charges its lateness."""

    def __init__(self, monitor: "LoopMonitor"):
        self.monitor = monitor
        # A late tick's watchdog holds the lock for hold_s, then releases
        # it for settle_s, and reads every thread's CPU time around both.
        self.hold_s = 0.0005
        self.settle_s = 0.002
        self._lock = threading.Lock()
        # key -> {"stalls", "samples", "stall_s", "stack"}; "stalls"
        # counts the stall episodes in which the key was charged.
        self._blockers: Dict[str, dict] = {}
        self._stalled = False
        self._stall_keys: set = set()
        self._watermark: Optional[float] = None
        self.samples_total = 0
        self.stall_s_attributed = 0.0
        self.stall_s_unattributed = 0.0

    def positions(self) -> Dict[int, tuple]:
        """(id of the top frame, instruction offset) of every thread but
        the caller's."""
        me = threading.get_ident()
        return {tid: (id(f), f.f_lasti)
                for tid, f in sys._current_frames().items() if tid != me}

    def running_frames(self) -> list:
        """Top frames of the threads (this one and the ticker excepted)
        that run Python (see the module docstring)."""
        skip = {threading.get_ident(), self.monitor.loop_thread_id}
        threads = [t for t in threading.enumerate() if t.ident not in skip]
        held = _cpu_ns(threads)
        first = self.positions()
        end = time.perf_counter() + self.hold_s
        while time.perf_counter() < end:  # holds the lock throughout
            pass
        released = _cpu_ns(threads)
        time.sleep(self.settle_s)
        after = _cpu_ns(threads)
        frames = sys._current_frames()
        out = []
        for tid, f in frames.items():
            if tid in skip or tid not in first:
                continue
            cpu = [c.get(tid) for c in (held, released, after)]
            if None in cpu:
                ran = first[tid] != (id(f), f.f_lasti)
            else:
                ran = (cpu[1] - cpu[0] < 0.2e9 * self.hold_s
                       and cpu[2] - cpu[1] > 0.2e9 * self.settle_s)
            if ran:
                out.append(f)
        frames = f = None
        return out

    def sample(self, now: Optional[float] = None, frame=None) -> bool:
        """One watchdog pass: a stall when ``now`` is the threshold or
        more past the monitor's last tick, charged to ``frame`` when one
        is given, else to the threads that run Python (unattributed when
        none does, or when no ticker runs). Returns whether it saw a
        stall."""
        mon = self.monitor
        last = mon.last_tick()
        if last is None:
            return False
        if now is None:
            now = time.monotonic()
        if (now - last) < mon.stall_threshold_s:
            self._stalled = False
            self._stall_keys.clear()
            self._watermark = None
            return False
        new_stall = not self._stalled
        self._stalled = True
        if frame is not None:
            frames = [frame]
        elif mon.loop_thread_id is not None:
            frames = self.running_frames()
        else:
            frames = []
        charges = [_stack(f) for f in frames] or [(UNATTRIBUTED, [])]
        frame = frames = None
        # Charge the stall time since the last attribution point: the
        # tick that started the stall on the first pass, the previous
        # pass afterwards.
        floor = last if self._watermark is None else self._watermark
        charged = max(0.0, now - max(last, floor))
        self._watermark = now
        with self._lock:
            self.samples_total += 1
            if new_stall:
                self._stall_keys = set()
            for key, stack in charges:
                rec = self._blockers.setdefault(
                    key, {"stalls": 0, "samples": 0, "stall_s": 0.0,
                          "stack": []})
                if key not in self._stall_keys:
                    rec["stalls"] += 1
                    self._stall_keys.add(key)
                rec["samples"] += 1
                rec["stall_s"] += charged
                rec["stack"] = stack
            if charges[0][0] == UNATTRIBUTED:
                self.stall_s_unattributed += charged
            else:
                self.stall_s_attributed += charged
        return True

    def top_blockers(self, limit: int = 10) -> List[dict]:
        """Blocker table sorted by cumulative stall seconds, worst
        first."""
        with self._lock:
            items = [
                {"frame": key,
                 "stalls": rec["stalls"],
                 "samples": rec["samples"],
                 "stall_s": round(rec["stall_s"], 6),
                 "stack": list(rec["stack"])}
                for key, rec in self._blockers.items()
            ]
        items.sort(key=lambda r: r["stall_s"], reverse=True)
        return items[:limit]

    def blocker_snapshot(self) -> Dict[str, dict]:
        """Per-key counters without stacks, for deltas across a
        measurement window."""
        with self._lock:
            return {key: {"stalls": rec["stalls"],
                          "stall_s": rec["stall_s"]}
                    for key, rec in self._blockers.items()}


class LoopMonitor:
    """Ticker (lag ring and rollups) and facade over the watchdog and
    the component timers. ``start()`` starts the ticker thread;
    ``stop()`` is idempotent."""

    def __init__(self, service: str, *,
                 stall_threshold_s: float = DEFAULT_STALL_THRESHOLD_S,
                 interval_s: Optional[float] = None,
                 capacity: int = 4096):
        if stall_threshold_s <= 0:
            raise ValueError("stall_threshold_s must be positive")
        self.service = service
        self.stall_threshold_s = float(stall_threshold_s)
        self.interval_s = (float(interval_s) if interval_s is not None
                           else min(DEFAULT_TICK_INTERVAL_S,
                                    self.stall_threshold_s / 2.0))
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # (seq, t, lag)
        self.samples_total = 0
        self.lag_s_sum = 0.0
        self.stall_s_sum = 0.0
        self.stall_counts: Dict[str, int] = {
            label: 0 for label, _ in STALL_BUCKETS}
        self.components = LoopComponentTimers()
        self.detector = BlockingCallDetector(self)
        # The ticker thread's id (the JAX monitor's loop thread).
        self.loop_thread_id: Optional[int] = None
        self._ticker: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._last_tick: Optional[float] = None
        self._started = False

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Start the ticker thread (the watchdog runs on it)."""
        if self._started:
            return
        self._started = True
        self._last_tick = time.monotonic()
        self._ticker = threading.Thread(
            target=self._run, daemon=True,
            name=f"loop-ticker-{self.service}")
        self._ticker.start()

    def stop(self) -> None:
        self._started = False
        self._stop_event.set()
        th = self._ticker
        if th is not None and th.is_alive() and \
                th is not threading.current_thread():
            th.join(timeout=1.0)

    def _run(self) -> None:
        self.loop_thread_id = threading.get_ident()
        while True:
            due = time.monotonic() + self.interval_s
            if self._stop_event.wait(self.interval_s):
                return
            # Returning from the wait needed the interpreter lock: the
            # lateness is the lock wait (plus the OS scheduler's delay).
            now = time.monotonic()
            self._last_tick = due
            self.observe(max(0.0, now - due), now=now)
            self.detector.sample(now)

    # -- recording / queries ------------------------------------------

    def observe(self, lag_s: float,
                now: Optional[float] = None) -> None:
        """Record one lag sample (public for replayed stalls)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            self.samples_total += 1
            self.lag_s_sum += lag_s
            self._ring.append((self.samples_total, now, lag_s))
            if lag_s >= self.stall_threshold_s:
                self.stall_s_sum += lag_s
                label = STALL_BUCKETS[0][0]
                for name, mult in STALL_BUCKETS:
                    if lag_s >= self.stall_threshold_s * mult:
                        label = name
                self.stall_counts[label] += 1

    def last_tick(self) -> Optional[float]:
        """When the newest tick was due (the start, before the first)."""
        return self._last_tick

    def seq(self) -> int:
        """Sequence number of the newest sample (the ``since_seq``
        marker of windowed percentiles)."""
        return self.samples_total

    def percentiles(self, since_seq: int = 0,
                    window_s: Optional[float] = None,
                    now: Optional[float] = None) -> dict:
        """p50/p99/max over ring samples newer than ``since_seq`` and,
        when ``window_s`` is given, no older than that many seconds."""
        with self._lock:
            entries = list(self._ring)
        if window_s is not None:
            if now is None:
                now = time.monotonic()
            cutoff = now - window_s
            entries = [e for e in entries if e[1] >= cutoff]
        if since_seq:
            entries = [e for e in entries if e[0] > since_seq]
        lags = sorted(e[2] for e in entries)
        return {
            "count": len(lags),
            "p50": round(_percentile(lags, 0.50), 6),
            "p99": round(_percentile(lags, 0.99), 6),
            "max": round(lags[-1], 6) if lags else 0.0,
        }

    def stalls(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stall_counts)

    def summary(self, now: Optional[float] = None) -> dict:
        """One-call rollup of everything (served at /debug/loop)."""
        pct = self.percentiles(now=now)
        with self._lock:
            samples = self.samples_total
            lag_sum = self.lag_s_sum
            stall_s = self.stall_s_sum
            stalls = dict(self.stall_counts)
        det = self.detector
        return {
            "service": self.service,
            "interval_s": self.interval_s,
            "stall_threshold_s": self.stall_threshold_s,
            "capacity": self.capacity,
            "samples_total": samples,
            "lag_s_sum": round(lag_sum, 6),
            "lag": pct,
            "stalls": stalls,
            "stall_s_measured": round(stall_s, 6),
            "stall_s_attributed": round(det.stall_s_attributed, 6),
            "stall_s_unattributed": round(det.stall_s_unattributed, 6),
            "watchdog_samples": det.samples_total,
            "components": self.components.stats(),
        }
