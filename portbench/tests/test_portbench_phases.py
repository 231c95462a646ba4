"""The engine's step phases and the five readers of them: the phase
clock is contiguous; on the tiny CPU engine a decode burst's record
carries its phases from the wait for the step lock to the record's end,
the launch phases are the one timer of the launches, and without the
recorder no phase is stored and no thread CPU clock is read; each reader
gives its value on a hand-made run, and nothing without a trace or
without steps."""

import queue
import threading
import time

import pytest
import torch

from portbench import devtrace, spec
from portbench.tests.test_portbench_metrics import SECONDS, T0, make_run
from portbench.tests.tinybench import REPO
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.obs.steps import PhaseClock

torch.set_num_threads(1)

ENGINE = dict(model="tiny-llama", max_model_len=128, max_num_seqs=4,
              block_size=4, num_blocks=96, min_prefill_bucket=16,
              max_loras=0, dtype="float32", device="cpu")
READERS = ("decode_launch_ms_per_forward", "decode_emit_us_per_token",
           "engine_offcpu_pct.decode", "idle_in_launch_pct.decode",
           "decode_kernels_per_forward")


def read(name, run):
    return spec.metric_reader(REPO, name)(run)


def contiguous(phases):
    return all(a[1] + a[2] == pytest.approx(b[1], abs=1e-6)
               for a, b in zip(phases, phases[1:]))


# -- the clock ---------------------------------------------------------------

def test_phase_clock_is_contiguous():
    clock = PhaseClock()
    assert clock.current is None
    assert clock.mark("plan") is None and clock.close() is None
    t0 = clock.start("lock")
    assert clock.mark("plan") >= t0
    t_plan = clock.phases[-1][1]
    assert clock.mark("plan") == t_plan  # the open phase goes on
    for name in ("build", "launch", "readback", "emit"):
        clock.mark(name)
    end = clock.close()
    assert clock.current is None and clock.mark("x") is None
    names = [p[0] for p in clock.phases]
    assert names == ["lock", "plan", "build", "launch", "readback", "emit"]
    assert clock.phases[0][1] == t0
    assert contiguous(clock.phases)
    last = clock.phases[-1]
    assert last[1] + last[2] == pytest.approx(end, abs=1e-6)
    assert sum(p[2] for p in clock.phases) == pytest.approx(end - t0,
                                                            abs=1e-6)
    # Another thread sees no step running.
    clock.start("lock")
    seen = []
    th = threading.Thread(target=lambda: seen.append(
        (clock.current, clock.mark("emit"))))
    th.start()
    th.join()
    assert seen == [(None, None)] and clock.current == "lock"
    clock.close()
    off = PhaseClock(cpu=False)
    off.start("a")
    sum(range(10000))
    off.close()
    assert off.phases[0][3] == 0.0


# -- the engine's records ----------------------------------------------------

def _serve(eng, n=2, max_tokens=24):
    q: "queue.Queue" = queue.Queue()
    for i in range(n):
        eng.add_request(f"p{i}", [1, 2, 3, 4, 5 + i],
                        SamplingParams(temperature=0.0,
                                       max_tokens=max_tokens,
                                       ignore_eos=True),
                        lambda t, f: q.put(f))
    done, deadline = 0, time.time() + 120
    while done < n and time.time() < deadline:
        done += q.get(timeout=120) is not None
    assert done == n


def test_decode_burst_records_carry_their_phases():
    eng = EngineCore(EngineConfig(**ENGINE))
    eng.start()
    try:
        _serve(eng)
    finally:
        eng.stop()
    recs = eng.step_recorder.snapshot()

    def names(r):
        return [p[0] for p in r["phases"]]

    # Bursts that read the previous one back after their launch.
    bursts = [r for r in recs if r["kind"] == "decode_burst"
              and "readback" in names(r)[names(r).index("launch"):]]
    assert bursts
    for r in recs:
        ph = r["phases"]
        assert ph and ph[0][0] == "lock" and contiguous(ph)
        # From the lock's start to the record's end; the record's own
        # wall time starts where the lock was held.
        assert ph[-1][1] + ph[-1][2] == pytest.approx(r["ts_unix"],
                                                      abs=1e-6)
        assert ph[0][1] + ph[0][2] == pytest.approx(
            r["ts_unix"] - r["wall_s"], abs=1e-5)
        assert all(p[2] >= 0 and p[3] >= 0 for p in ph)
    for r in bursts:
        n = names(r)
        assert {"lock", "plan", "build", "launch", "emit"} <= set(n)
        launch = n.index("launch")
        assert n.index("build") < launch < n.index(
            "readback", launch) < n.index("emit", launch)
    # A deferred first token's wait for the card is a readback of its
    # own inside the emission of first tokens.
    assert any(n[i - 1:i + 2] == ["flush_prefills", "readback",
                                  "flush_prefills"]
               for n in map(names, recs) for i in range(1, len(n) - 1))
    # Rollups: every record's phases, by kind.
    stats = eng.step_recorder.phase_stats()
    launch = sum(p[2] for r in recs if r["kind"] == "decode_burst"
                 for p in r["phases"] if p[0] == "launch")
    assert stats["decode_burst"]["launch"]["wall_s"] == pytest.approx(
        launch)
    # One timer: every dispatch of these steps ran in a launch phase, so
    # the launch phases are all of dispatch_enqueue_s.
    assert eng.dispatch_enqueue_s == pytest.approx(
        sum(p[2] for r in recs for p in r["phases"] if p[0] == "launch"))
    assert eng.decode_time_total >= sum(
        r["wall_s"] for r in recs if r["kind"] == "decode_burst") - 1e-4


def test_no_step_recorder_stores_no_phase(monkeypatch):
    calls = []
    real = time.thread_time

    def counted():
        calls.append(1)
        return real()

    eng = EngineCore(EngineConfig(**dict(ENGINE, step_recorder=False)))
    monkeypatch.setattr(time, "thread_time", counted)
    eng.start()
    try:
        _serve(eng, n=1, max_tokens=12)
    finally:
        eng.stop()
    assert eng.step_recorder is None
    assert calls == []
    # The counters still take their seconds from the phase stamps.
    assert eng.dispatch_enqueue_s > 0 and eng.decode_time_total > 0


# -- the readers -------------------------------------------------------------

def burst(t, forwards=8, tokens=64):
    """A decode burst whose lock phase starts at T0 + t: 0.51 s of
    phases, 0.35 s of them launching (0.28 s of it on the CPU)."""
    a = T0 + t
    phases = [["lock", a, 0.01, 0.01], ["plan", a + 0.01, 0.02, 0.02],
              ["build", a + 0.03, 0.03, 0.03],
              ["launch", a + 0.06, 0.35, 0.28],
              ["readback", a + 0.41, 0.05, 0.0],
              ["emit", a + 0.46, 0.05, 0.04]]
    return {"kind": "decode_burst", "start": a + 0.01, "end": a + 0.51,
            "wall_s": 0.5, "forwards": forwards, "tokens": tokens,
            "phases": phases}


def steps():
    early = burst(-2.0)  # begun before the window: not counted
    chunk = dict(burst(3.0), kind="prefill_chunk")
    # Begun in the window, still running at the profiler's stop: its
    # launch waits out the profiler (30 s) and only its 0.04 s of idle
    # inside the window counts.
    stalled = burst(9.9)
    stalled["phases"][3][2] = 30.0
    stalled["end"] = T0 + 9.96 + 30.0 + 0.15
    return [early, burst(0.99), burst(1.99), chunk, stalled]


def trace():
    # Busy: [1.06, 1.10], [1.20, 1.30], [2.10, 2.30], [5.0, 6.0].
    return devtrace.DeviceTrace(window_s=SECONDS, events=[
        ("gemm", T0 + 1.06, 0.04), ("elementwise_kernel", T0 + 1.20, 0.10),
        ("gemm", T0 + 2.10, 0.20), ("copy", T0 + 5.0, 1.0)])


def test_the_readers_by_hand():
    run = make_run([], steps(), trace=trace())
    # Two bursts inside the window: 16 forwards, 128 tokens.
    assert read("decode_launch_ms_per_forward", run) == pytest.approx(
        1000 * 0.70 / 16)
    assert read("decode_emit_us_per_token", run) == pytest.approx(
        1e6 * 0.10 / 128)
    # Every phase but the readback: 0.46 s of wall, 0.38 s on the CPU.
    assert read("engine_offcpu_pct.decode", run) == pytest.approx(
        100 * (1 - 0.38 / 0.46))
    # Idle 8.66 s; inside the launches [1.05, 1.40] and [2.05, 2.40]:
    # 0.01 + 0.10 + 0.10 and 0.05 + 0.10; the stalled one's from 9.96.
    assert read("idle_in_launch_pct.decode", run) == pytest.approx(
        100 * 0.40 / 8.66)
    # The first burst's span [0.99, 1.50] holds two starts, the second's
    # [1.99, 2.50] one; the copy at 5.0 lies in no burst.
    assert read("decode_kernels_per_forward", run) == pytest.approx(3 / 16)


def test_the_readers_read_nothing_without_a_trace_or_steps():
    no_trace = make_run([], steps())
    for name in ("idle_in_launch_pct.decode", "decode_kernels_per_forward"):
        assert read(name, no_trace) is None
    assert read("decode_launch_ms_per_forward", no_trace) is not None
    for run in (make_run([], [], trace=trace()),
                # A program whose records carry no phases.
                make_run([], [{k: v for k, v in s.items() if k != "phases"}
                              for s in steps()], trace=trace())):
        for name in READERS:
            assert read(name, run) is None, name
