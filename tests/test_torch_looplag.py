"""The port's interpreter-lock lag monitor (``obs/looplag.py``) against the
JAX event-loop monitor, and its wiring in the port's server.

- Replayed lags (explicit ``now``): the same samples into both monitors
  give the same percentiles (ring, sequence and time windows), stall
  buckets, sums and ``summary()``; the replayed watchdog passes give the
  same top-blockers table and attributed seconds.
- The live server (``--loop-monitor``): a request handler that runs a
  pure-Python loop for 0.3 s is named by ``file:line:func`` in
  ``/debug/loop``'s top blockers, a handler asleep beside it is not; the
  ``/metrics`` loop series' names and labels equal the JAX server's; with
  the flag off there is no loop line and no route (the JAX server's
  ``test_engine_flag_off_no_loop_lines``).

Cost on one core: ~10 s (one port server a module, one JAX server)."""

import asyncio
import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import aiohttp
import pytest
import torch

from production_stack_tpu.obs import looplag as jax_looplag
from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.obs import looplag

torch.set_num_threads(1)

SERVER_ARGS = ["tiny-llama", "--device", "cpu", "--dtype", "float32",
               "--host", "127.0.0.1", "--port", "0", "--max-model-len",
               "128", "--block-size", "8", "--num-blocks", "64",
               "--max-loras", "0", "--no-warmup"]

# (threshold, capacity, [(lag, now), ...]) replayed into both monitors.
SCENARIOS = {
    "ring_and_windows": (0.1, 100, [(0.001, float(i)) for i in range(98)]
                         + [(0.5, 98.0), (0.5, 99.0)]),
    "buckets": (0.1, 4096, [(0.05, 0.0), (0.1, 1.0), (0.49, 2.0),
                            (0.5, 3.0), (2.0, 4.0)]),
    "bounded_ring": (0.1, 8, [(0.001 * i, float(i)) for i in range(100)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replayed_lags_give_the_jax_rollups(name):
    threshold, capacity, samples = SCENARIOS[name]
    mons = [mod.LoopMonitor("t", stall_threshold_s=threshold,
                            capacity=capacity)
            for mod in (jax_looplag, looplag)]
    marks = []
    for mon in mons:
        for lag, now in samples:
            mon.observe(lag, now=now)
        marks.append(mon.seq())
        mon.observe(0.2, now=samples[-1][1] + 1.0)
    want, got = mons
    end = samples[-1][1] + 1.0
    for query in ({}, {"since_seq": marks[0]},
                  {"window_s": 0.5, "now": end},
                  {"window_s": 50.0, "now": end}):
        assert got.percentiles(**query) == want.percentiles(**query), query
    assert got.stalls() == want.stalls()
    assert got.stall_s_sum == pytest.approx(want.stall_s_sum)
    assert got.lag_s_sum == pytest.approx(want.lag_s_sum)
    assert got.samples_total == want.samples_total
    # The watchdog's own cadence is the one key that differs by design:
    # the port's watchdog runs at each tick (``interval_s``), the JAX one
    # polls on its own thread at ``watchdog_poll_s``.
    g, w = got.summary(now=end), want.summary(now=end)
    assert "watchdog_poll_s" not in g
    w.pop("watchdog_poll_s")
    assert g == w


def _frozen_frame():
    return sys._getframe()


def test_replayed_watchdog_attribution_equals_jax():
    """The JAX detector's deterministic scenario on both, through the
    pass that the port's ticker makes at each tick: a stall's edge counts
    one episode, its passes charge the watermark, and a pass with no
    frame and no ticker goes to the unattributed key."""
    frame = _frozen_frame()
    runs = []
    for mod in (jax_looplag, looplag):
        mon = mod.LoopMonitor("t", stall_threshold_s=0.1)
        det = mon.detector
        mon._last_tick = 100.0
        mon.loop_thread_id = threading.get_ident()
        seen = [det.sample(now=100.05, frame=frame),
                det.sample(now=100.2, frame=frame),
                det.sample(now=100.3, frame=frame)]
        mon._last_tick = 101.0
        seen.append(det.sample(now=101.05, frame=frame))
        mon.loop_thread_id = None
        seen.append(det.sample(now=101.2))
        runs.append((seen, det.top_blockers(), det.stall_s_attributed,
                     det.stall_s_unattributed, det.samples_total,
                     det.blocker_snapshot()))
    assert runs[1] == runs[0]
    assert runs[1][0] == [False, True, True, False, True]


def test_component_timers_keep_add_measure_and_stats():
    """What a threaded server can use of the JAX timers; the port has no
    coroutine ``wrap``."""
    timers = [mod.LoopComponentTimers() for mod in (jax_looplag, looplag)]
    for t in timers:
        t.add("qos_admission", 0.25)
        t.add("qos_admission", 0.5)
        t.add("metrics_scrape", 0.125)
        with t.measure("relay"):
            pass
    want, got = (t.stats() for t in timers)
    assert set(got) == set(want)
    for comp in ("qos_admission", "metrics_scrape"):
        assert got[comp] == want[comp]
    assert got["relay"]["calls"] == want["relay"]["calls"] == 1
    assert got["relay"]["seconds"] >= 0.0
    assert not hasattr(looplag.LoopComponentTimers, "wrap")


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve(extra):
    httpd, core = build_server(SERVER_ARGS + extra)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, core, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def monitored():
    httpd, core, base = _serve(["--loop-monitor",
                                "--loop-stall-threshold-ms", "2"])
    yield httpd, base
    httpd.shutdown()
    httpd.server_close()
    core.stop()


def _hog(seconds):
    t0 = time.perf_counter()
    x = 0
    while time.perf_counter() - t0 < seconds:
        x += 1
    return x


def _sleepy(seconds):
    time.sleep(seconds)


def test_a_python_hog_is_named_and_a_sleeper_is_not(monitored):
    httpd, base = monitored
    eng = httpd.engine
    models, adapters = eng.models, eng.lora_adapters

    def hog_then_models():
        _hog(0.3)
        return models()

    def sleep_then_adapters():
        _sleepy(0.6)
        return adapters()

    eng.models = hog_then_models
    eng.lora_adapters = sleep_then_adapters
    try:
        named = False
        # A loaded host can hand the lock over on time for a whole run:
        # up to three runs, each with its own sleeper.
        for _ in range(3):
            sleeper = threading.Thread(
                target=_get, args=(base, "/v1/lora_adapters"))
            sleeper.start()
            time.sleep(0.05)
            assert _get(base, "/v1/models")[0] == 200
            sleeper.join()
            status, body = _get(base, "/debug/loop?blockers=1000")
            assert status == 200
            top = json.loads(body)["top_blockers"]
            frames = [row["frame"] for row in top]
            assert not any(f.endswith(":_sleepy") for f in frames), frames
            named = any(re.fullmatch(r"tests/test_torch_looplag\.py:\d+:_hog",
                                     f) for f in frames)
            if named:
                break
        assert named, frames
        health = json.loads(body)
        assert health["service"] == "tpu-stack-engine"
        assert health["stall_threshold_s"] == pytest.approx(0.002)
        assert health["stall_s_attributed"] > 0
    finally:
        del eng.models, eng.lora_adapters


def test_debug_loop_refuses_bad_blockers(monitored):
    _, base = monitored
    assert _get(base, "/debug/loop?blockers=abc")[0] == 400
    assert _get(base, "/debug/loop?blockers=0")[0] == 400


def _loop_series(exposition: str) -> set:
    """(metric or TYPE line, label names) of the loop series."""
    out = set()
    for line in exposition.splitlines():
        if "event_loop_lag" not in line and "loop_stalls" not in line:
            continue
        if line.startswith("#"):
            out.add(line)
            continue
        name, _, rest = line.partition("{")
        labels = tuple(sorted(kv.split("=")[0]
                              for kv in rest.split("}")[0].split(",")))
        bucket = re.search(r'bucket="([^"]+)"', line)
        out.add((name, labels, bucket.group(1) if bucket else None))
    return out


def test_loop_series_names_and_labels_equal_the_jax_servers(monitored):
    from production_stack_tpu.engine.config import EngineConfig
    from production_stack_tpu.engine.server import (
        EngineServer,
        run_engine_server,
    )

    _, base = monitored
    status, port_text = _get(base, "/metrics")
    assert status == 200
    server = EngineServer(EngineConfig(
        model="tiny-llama", max_model_len=128, max_num_seqs=2,
        block_size=8, num_blocks=64, max_loras=0), loop_monitor=True,
        loop_stall_threshold_ms=2.0)

    async def scrape():
        runner = await run_engine_server(server, "127.0.0.1", 0)
        port = list(runner.sites)[0]._server.sockets[0].getsockname()[1]
        try:
            await asyncio.sleep(0.05)
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/metrics") as r:
                    return await r.text()
        finally:
            await runner.cleanup()

    try:
        jax_text = asyncio.run(scrape())
    finally:
        server.core.stop()
    want = _loop_series(jax_text)
    assert len(want) == 13  # 5 TYPE lines, 5 lag series, 3 stall buckets
    assert _loop_series(port_text) == want


def test_flag_off_has_no_loop_lines_and_no_route():
    httpd, core, base = _serve([])
    try:
        assert httpd.engine.loop_monitor is None
        status, text = _get(base, "/metrics")
        assert status == 200
        assert "event_loop_lag" not in text and "loop_stalls" not in text
        assert _get(base, "/debug/loop")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()


def test_flags_match_the_jax_server():
    from production_stack_tpu.engine.server import (
        build_arg_parser as jax_parser,
    )
    from production_stack_tpu_torch.engine.server import build_arg_parser

    for argv in ([], ["--loop-monitor", "--loop-stall-threshold-ms", "25"]):
        want = jax_parser().parse_args(["tiny-llama"] + argv)
        got = build_arg_parser().parse_args(["tiny-llama"] + argv)
        assert (got.loop_monitor, got.loop_stall_threshold_ms) == (
            want.loop_monitor, want.loop_stall_threshold_ms)
