"""Tails over all requests, tokens over the window and failed requests
as missing, on hand-made logs; the device trace's busy time, idle gaps
and a kernel's roofline share by hand."""

import pytest

from portbench import devtrace, flops, harness, spec
from portbench.tests.tinybench import REPO, tiny_config

T0 = 1000.0  # window opens
SECONDS = 10.0


def req(rid, start, first=None, last=None, times=(), status=200,
        error=None, prompt=20, shared=0, in_window=True):
    return {"rid": rid, "start": start, "send": start, "due": None,
            "first": first, "last": last, "status": status, "error": error,
            "served": [7] * len(times), "token_times": list(times),
            "prompt_len": prompt, "shared": shared, "in_window": in_window,
            "engine_ttft": None if first is None else first - start - 0.002,
            "arrival": start + 0.001,
            "prefill_start": None if first is None else start + 0.011}


def make_run(requests, steps=(), stats0=None, stats1=None, trace=None):
    cfg = tiny_config()
    cell = spec.Cell(name="tiny", chips=1, config_name="tiny", config=cfg,
                     traffic_name="x", traffic={}, end_to_end=[],
                     per_layer=[], run_seconds=10, root=REPO)
    zero = {"prompt_tokens_total": 0, "cached_tokens_total": 0}
    return harness.Run(
        cell=cell, shape=cell.shape, seconds=SECONDS, t_open=T0,
        t_close=T0 + SECONDS, t_end=T0 + SECONDS + 5, setup_s=12.5,
        block=16, chunk=64, requests=list(requests), stats0=stats0 or zero,
        stats1=stats1 or zero, steps=list(steps), trace=trace,
        dev_open=T0, dev_close=T0 + SECONDS)


def read(name, run):
    return spec.metric_reader(REPO, name)(run)


def test_tails_count_every_request_and_failures_as_missing():
    reqs = [req(f"r{i}", T0 + i * 0.4, first=T0 + i * 0.4 + 0.1 * (i + 1),
                last=T0 + i * 0.4 + 2.0, times=[T0 + i * 0.4 + 1] * 11)
            for i in range(19)]
    reqs.append(req("refused", T0 + 9.0, status=503, error="busy"))
    run = make_run(reqs)
    ttft = sorted(harness.ttft_values(run))
    assert len(ttft) == 20
    # The refused one waited until the grace ended: the slowest.
    assert ttft[-1] == pytest.approx(T0 + 15.0 - (T0 + 9.0))
    # p90 of 20 by nearest rank is the 18th.
    assert read("ttft_p90_s", run) == pytest.approx(1.8)
    assert sum(harness.failed(r) for r in run.window_requests()) == 1


def test_a_tail_over_medians_is_not_used():
    # 20 requests: 17 fast, 3 slow, all three in the window's last
    # quarter. p90 (18th of 20) is slow; a median of per-quarter p90s
    # would be fast.
    reqs = [req(f"r{i}", T0 + i * 0.1, first=T0 + i * 0.1 + 0.05)
            for i in range(17)]
    reqs += [req(f"s{i}", T0 + 8 + 0.1 * i, first=T0 + 11 + 0.1 * i)
             for i in range(3)]
    assert read("ttft_p90_s", make_run(reqs)) == pytest.approx(3.0)


def test_output_tokens_over_the_window_only():
    inside = [T0 + 0.5 * k for k in range(20)]  # 20 in the window
    before = [T0 - 1.0, T0 - 0.5]
    after = [T0 + SECONDS, T0 + SECONDS + 1]
    run = make_run([req("a", T0 - 2, first=T0 - 1,
                        times=before + inside + after)])
    assert read("output_tok_s", run) == pytest.approx(20 / SECONDS)


def test_tpot_of_requests_finished_in_the_window():
    done = req("a", T0 - 3, first=T0 + 1.0, last=T0 + 3.0,
               times=[T0] * 21)  # 20 gaps over 2 s: 100 ms
    late = req("b", T0 + 1, first=T0 + 2, last=T0 + SECONDS + 2,
               times=[T0] * 5)  # finished after the window: not counted
    run = make_run([done, late])
    assert read("tpot_p90_ms", run) == pytest.approx(100.0)
    run = make_run([done, late, req("c", T0 + 2, status=503, error="x")])
    # The refused window request reads as the window's length a token.
    assert read("tpot_p90_ms", run) == pytest.approx(1000.0 * SECONDS)


def test_live_kv_by_hand():
    # Pages of 16 tokens; a page of the toy model: 2 layers x K and V x
    # 2 KV heads x 32 x 2 bytes x 16 tokens = 8192 bytes.
    a = req("a", T0 + 1, first=T0 + 2, times=[T0 + 2, T0 + 4], prompt=20)
    # From its prefill start (T0 + 1.011) 2 pages, after its first token
    # 21 tokens: still 2 pages, until its last token at T0 + 4.
    b = req("b", T0 - 5, first=T0 - 4, times=[T0 - 4, T0 + 1], prompt=40)
    # 41 tokens, 3 pages, inside the window from T0 to T0 + 1 only.
    late = req("c", T0 + SECONDS + 1, first=T0 + SECONDS + 2,
               times=[T0 + SECONDS + 2])
    page_s = 0.989 * 2 + 2.0 * 2 + 1.0 * 3
    assert read("kv_live_gb", make_run([a, b, late])) == pytest.approx(
        page_s * 8192 / SECONDS / 1e9)
    assert read("kv_live_gb", make_run([late])) is None


def test_counter_and_span_readers():
    stats0 = {"prompt_tokens_total": 1000, "cached_tokens_total": 100}
    stats1 = {"prompt_tokens_total": 5000, "cached_tokens_total": 3100}
    steps = [
        {"kind": "decode_burst", "start": T0 + 1, "end": T0 + 1.2,
         "wall_s": 0.2, "forwards": 8, "tokens": 64},
        {"kind": "decode_burst", "start": T0 - 1, "end": T0 - 0.8,
         "wall_s": 0.2, "forwards": 8, "tokens": 64},  # before: out
        {"kind": "prefill_chunk", "start": T0 + 2, "end": T0 + 2.05,
         "wall_s": 0.05, "forwards": 1, "tokens": 500}]
    reqs = [req("a", T0 + 1, first=T0 + 1.1)]
    run = make_run(reqs, steps, stats0, stats1)
    assert read("prefix_hit_pct", run) == pytest.approx(75.0)
    assert read("decode_ms_per_forward", run) == pytest.approx(25.0)
    assert read("prefill_ms_per_1k_tok", run) == pytest.approx(100.0)
    assert read("queue_wait_ms_p90", run) == pytest.approx(10.0)
    assert read("server_ttft_overhead_ms", run) == pytest.approx(2.0)
    assert read("setup_s", run) == 12.5
    # Nothing traced: the device readers read nothing.
    for name in ("paged_decode_roofline", "mfu_pct.decode",
                 "device_idle_pct.decode", "matmul_us_per_tok.decode"):
        assert read(name, run) is None


def test_device_trace_busy_idle_and_kernel_share():
    events = [("gemm_a", T0 + 0.0, 2.0), ("gemm_b", T0 + 1.0, 2.0),
              ("void paged_decode_mma_kernel<bf16>(...)", T0 + 5.0, 1.0)]
    tr = devtrace.DeviceTrace(window_s=SECONDS, events=events)
    assert tr.busy_intervals() == [(T0, T0 + 3.0), (T0 + 5.0, T0 + 6.0)]
    assert tr.busy_s() == pytest.approx(4.0)
    gaps = tr.idle_gaps(T0, T0 + SECONDS)
    assert [g[1] for g in gaps] == pytest.approx([2.0, 4.0])
    labels = devtrace.label_gaps(gaps, [{"start": T0 + 6.5, "end": T0 + 9,
                                         "kind": "decode_burst"}], T0)
    assert labels == [["idle in decode_burst steps: all 1 gaps", 4.0],
                      ["idle between steps: all 1 gaps", 2.0],
                      ["longest, in decode_burst steps at +6.000 s", 4.0],
                      ["longest, between steps at +3.000 s", 2.0]]
    # One decode token of a 20-token prompt (output index 1: ctx 21).
    r = req("a", T0, first=T0 + 0.1, times=[T0 + 0.1, T0 + 0.2],
            prompt=20)
    run = make_run([r], trace=tr)
    s = run.shape
    need = flops.decode_token_bytes(s, 21, 16)
    by_hand = s.layers * (2 * s.kv_heads * s.head_dim * 2 * 21
                          + 2 * s.heads * s.head_dim * 2 + 4 * 2 + 4)
    assert need == by_hand
    share = read("paged_decode_roofline", run)
    assert share == pytest.approx(100 * need / flops.PEAK_HBM_BYTES_PER_S
                                  / 1.0)
    assert read("device_idle_pct.decode", run) == pytest.approx(60.0)
    mm = read("matmul_us_per_tok.decode", run)
    assert mm == pytest.approx(1e6 * 4.0 / (1 + 20))


def test_align_shifts_a_trace_on_another_clock_by_the_marker():
    host = [T0 - 0.001]
    raw = [("bucketize_kernel", 5000.0, 1e-6),
           ("gemm", 5000.5, 0.25)]
    tr = devtrace.align(raw, host, T0, T0 + SECONDS)
    assert tr.events == [("gemm", pytest.approx(T0 - 0.001 + 0.5), 0.25)]
