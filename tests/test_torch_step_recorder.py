"""The port's step flight recorder (``production_stack_tpu_torch/obs/
steps.py``, its own copy of the JAX package's): ring and roofline
accounting, the H100 memory rate and its override, ``/debug/steps`` on
the port's standard-library server with the JAX surface's schema,
filters and 400s, the ``tpu:step_*`` series under the JAX names, and the
engine's records and stats. Ports of tests/test_step_recorder.py's unit,
endpoint and engine tests."""

import json
import queue
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from production_stack_tpu.obs import steps as jax_steps
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.obs.steps import (
    DEFAULT_HBM_BYTES_PER_S,
    STEP_KINDS,
    StepRecorder,
    device_hbm_bytes_per_s,
)

torch.set_num_threads(1)

ENGINE = dict(model="tiny-llama", max_model_len=128, max_num_seqs=4,
              block_size=4, num_blocks=96, min_prefill_bucket=16,
              max_loras=0, dtype="float32", device="cpu")
ARGS = ["tiny-llama", "--device", "cpu", "--host", "127.0.0.1", "--port",
        "0", "--max-model-len", "128", "--block-size", "4", "--num-blocks",
        "96", "--dtype", "float32", "--max-loras", "0", "--no-warmup"]


# -- ring and roofline ---------------------------------------------------------

def test_same_kinds_as_jax_and_the_h100_rate():
    assert STEP_KINDS == jax_steps.STEP_KINDS
    assert DEFAULT_HBM_BYTES_PER_S == 3.35e12


def test_ring_truncation_newest_first():
    rec = StepRecorder(capacity=5)
    for i in range(10):
        rec.record("decode_burst", 0.01, tokens=i)
    assert rec.recorded_total == 10
    snap = rec.snapshot()
    assert len(snap) == 5
    assert [r["step"] for r in snap] == [10, 9, 8, 7, 6]
    assert [r["step"] for r in rec.snapshot(limit=2)] == [10, 9]


def test_kind_filter_and_stats_always_complete():
    rec = StepRecorder(capacity=16)
    assert set(rec.kind_stats()) == set(STEP_KINDS)
    assert all(v["count"] == 0 for v in rec.kind_stats().values())
    rec.record("prefill", 0.2, tokens=64)
    rec.record("decode_burst", 0.1, tokens=16)
    rec.record("decode_burst", 0.1, tokens=16)
    snap = rec.snapshot(kind="decode_burst")
    assert len(snap) == 2 and all(r["kind"] == "decode_burst" for r in snap)
    stats = rec.kind_stats()
    assert stats["prefill"]["count"] == 1 and stats["prefill"]["tokens"] == 64
    assert stats["decode_burst"]["count"] == 2
    assert stats["spec_verify"]["count"] == 0
    rec.record("experimental", 0.05)
    assert rec.kind_stats()["experimental"]["count"] == 1


def test_roofline_byte_estimate():
    rec = StepRecorder(param_bytes=100, kv_token_bytes=2)
    r = rec.record("decode_burst", 0.5, rows=2, tokens=8, forwards=4,
                   kv_read_tokens=10, kv_write_tokens=5)
    assert r["hbm_bytes"] == 4 * 100 + (10 + 5) * 2
    assert rec.kind_stats()["decode_burst"]["hbm_bytes"] == r["hbm_bytes"]


def test_bandwidth_utilization_window():
    rec = StepRecorder(param_bytes=0, kv_token_bytes=1,
                       hbm_bytes_per_s=1000.0, window_s=60.0)
    assert rec.bandwidth_utilization() == 0.0
    r = rec.record("decode_burst", 2.0, kv_write_tokens=1000)
    assert rec.bandwidth_utilization(now=r["ts_unix"]) == pytest.approx(0.5)
    assert rec.bandwidth_utilization(now=r["ts_unix"] + 59.0) == 0.0


def test_device_memory_rate_env_override(monkeypatch):
    monkeypatch.delenv("TPU_STACK_HBM_GBS", raising=False)
    assert device_hbm_bytes_per_s() == DEFAULT_HBM_BYTES_PER_S
    monkeypatch.setenv("TPU_STACK_HBM_GBS", "1e9")
    assert device_hbm_bytes_per_s() == 1e9
    monkeypatch.setenv("TPU_STACK_HBM_GBS", "not-a-number")
    assert device_hbm_bytes_per_s() == DEFAULT_HBM_BYTES_PER_S


# -- /debug/steps and /metrics on the port's server ----------------------------

@pytest.fixture(scope="module")
def server():
    httpd, core = build_server(ARGS)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", core
    httpd.shutdown()
    httpd.server_close()
    core.stop()
    thread.join(timeout=10)


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _with_records(core):
    rec = StepRecorder(capacity=8, param_bytes=10, kv_token_bytes=2)
    rec.record("prefill", 0.2, rows=1, tokens=64, forwards=1,
               kv_write_tokens=64)
    for _ in range(3):
        rec.record("decode_burst", 0.05, rows=2, tokens=8, forwards=4,
                   kv_read_tokens=100, kv_write_tokens=8, batched=True)
    core.step_recorder = rec
    return rec


def test_debug_steps_schema_and_filters(server):
    base, core = server
    saved = core.step_recorder
    try:
        _with_records(core)
        status, body = _get(base, "/debug/steps")
        assert status == 200
        doc = json.loads(body)
        for key in ("capacity", "recorded_total", "param_bytes",
                    "kv_token_bytes", "hbm_bytes_per_s", "window_s",
                    "bandwidth_utilization", "kinds", "steps",
                    "kv_page_occupancy"):
            assert key in doc, key
        assert doc["recorded_total"] == 4
        assert set(doc["kinds"]) >= set(STEP_KINDS)
        assert len(doc["steps"]) == 4
        for r in doc["steps"]:
            for key in ("step", "ts_unix", "kind", "wall_s", "rows",
                        "tokens", "forwards", "kv_read_tokens",
                        "kv_write_tokens", "hbm_bytes", "batched"):
                assert key in r, key
        status, body = _get(base, "/debug/steps?kind=decode_burst&limit=2")
        doc = json.loads(body)
        assert status == 200 and len(doc["steps"]) == 2
        assert all(r["kind"] == "decode_burst" for r in doc["steps"])
    finally:
        core.step_recorder = saved


def test_debug_steps_validation(server):
    base, _ = server
    status, body = _get(base, "/debug/steps?limit=abc")
    assert status == 400 and "limit" in json.loads(body)["error"]
    status, body = _get(base, "/debug/steps?limit=0")
    assert status == 400 and ">= 1" in json.loads(body)["error"]
    status, body = _get(base, "/debug/steps?kind=nope")
    assert status == 400
    assert all(k in json.loads(body)["error"] for k in STEP_KINDS)


def test_step_series_under_the_jax_names(server):
    base, core = server
    saved = core.step_recorder
    try:
        _with_records(core)
        status, text = _get(base, "/metrics")
        assert status == 200
        for kind in STEP_KINDS:
            for family in ("tpu:step_duration_seconds_sum",
                           "tpu:step_duration_seconds_count",
                           "tpu:step_scheduled_tokens_total",
                           "tpu:step_hbm_bytes_total"):
                assert f'{family}{{model_name="tiny-llama",kind="{kind}"}}' \
                    in text, (family, kind)
        assert 'tpu:step_duration_seconds_count{model_name="tiny-llama",' \
            'kind="decode_burst"} 3' in text
        assert "tpu:model_bandwidth_utilization{" in text
    finally:
        core.step_recorder = saved


# -- the engine's records ------------------------------------------------------

def _generate(engine, rid, max_tokens, timeout=120):
    q: "queue.Queue" = queue.Queue()
    engine.add_request(
        rid, [1, 2, 3, 4, 5],
        SamplingParams(temperature=0.0, max_tokens=max_tokens,
                       ignore_eos=True), lambda t, f: q.put((t, f)))
    n, deadline = 0, time.time() + timeout
    while time.time() < deadline:
        token, finish = q.get(timeout=timeout)
        n += token is not None
        if finish is not None:
            return n
    raise TimeoutError("generation did not finish")


def test_engine_populates_recorder_and_stats():
    eng = EngineCore(EngineConfig(**ENGINE))
    eng.start()
    try:
        assert _generate(eng, "sr-1", 8) == 8
        rec = eng.step_recorder
        assert rec is not None
        kinds = {r["kind"] for r in rec.snapshot()}
        assert "prefill" in kinds and "decode_burst" in kinds
        assert rec.param_bytes > 0
        assert all(r["hbm_bytes"] > 0 for r in rec.snapshot())
        stats = eng.stats()
        assert stats["step_records_total"] == rec.recorded_total > 0
        assert stats["step_kind_stats"]["prefill"]["count"] >= 1
        assert "model_bandwidth_utilization" in stats
    finally:
        eng.stop()


def test_recorder_disabled_by_config():
    eng = EngineCore(EngineConfig(**dict(ENGINE, step_recorder=False)))
    eng.start()
    try:
        assert _generate(eng, "sr-off", 4) == 4
        assert eng.step_recorder is None
        stats = eng.stats()
        assert stats["step_records_total"] == 0
        assert stats["step_kind_stats"] == {}
    finally:
        eng.stop()
