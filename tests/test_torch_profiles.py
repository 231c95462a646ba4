"""The port's profiler legs (``production_stack_tpu_torch/probes/``)
against the JAX harness scripts in ``benchmarks/``, on the CPU at small
sizes.

- Each leg's CPU run prints one JSON line with the JAX script's metric
  name, its top-level keys and its component names where they carry
  over (``decode_profile``, ``prefill_profile --hermetic``,
  ``dispatch_accounting``, ``kernel_bs_sweep``).
- Each ablation removes its component: without attention the burst's
  logprobs change, without the page write every pool bit stays, without
  sampling the logprobs are zeros; the originals are back afterwards, an
  error inside included.
- After both profilers ran on an engine with the JAX engine's weights,
  its greedy streams still equal the JAX engine's.
- The page-size sweep's layouts: one logical context at each page size
  gives the same attention through the plain version (1e-5, float32).
- The KV handoff bench's decode engine continues with the stream of an
  engine that had no handoff; the transfer probe refuses on the CPU.

Tests that need the card carry the ``cuda`` marker and skip here.
Cost on one core: ~20 s."""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine import core as core_mod
from production_stack_tpu_torch.engine import sampling
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops import attention
from production_stack_tpu_torch.probes import (
    _profile_common as common,
    decode_profile,
    dispatch_accounting,
    kernel_bs_sweep,
    kv_handoff_bench,
    prefill_profile,
)

torch.set_num_threads(1)

REPO = str(__import__("pathlib").Path(__file__).resolve().parents[1])

# The names the ablations patch, and what they must be afterwards.
ORIGINALS = {
    (llama, "prefill_attention"): attention.prefill_attention,
    (llama, "context_prefill_attention"): attention.context_prefill_attention,
    (llama, "paged_decode_attention"): attention.paged_decode_attention,
    (llama, "scatter_kv_pages"): attention.scatter_kv_pages,
    (core_mod, "shape_logits"): sampling.shape_logits,
    (core_mod, "sample_with_gumbel"): sampling.sample_with_gumbel,
    (core_mod, "sample_tokens"): sampling.sample_tokens,
    (core_mod, "logprob_outputs"): sampling.logprob_outputs,
}


def assert_originals():
    for (mod, name), fn in ORIGINALS.items():
        assert getattr(mod, name) is fn, name


def _json_line(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, buf.getvalue()
    return json.loads(lines[0])


def test_decode_profile_has_the_jax_keys():
    out = _json_line(decode_profile.main, [
        "--device", "cpu", "--model", "tiny-llama", "--dtype", "float32",
        "--batch", "2", "--steps", "2", "--ctx", "20", "--block-size", "4",
        "--maxb", "8", "--num-blocks", "32", "--reps", "1"])
    assert out["metric"] == "decode_profile"
    assert out["device"] == "cpu"
    for key in ("model", "B", "K", "ctx", "full_s", "nosample_s",
                "noattn_s", "nowrite_s", "bare_matmul_s",
                "kernel_Llayers_1step_s", "sampling_chain_Ksteps_s",
                "components", "floors", "gap_vs_combined_floor"):
        assert key in out, key
    # The JAX leg xla_attn_s is the plain version's here, under its name.
    assert "plain_attn_s" in out and "xla_attn_s" not in out
    assert set(out["components"]) == {
        "sampling_est_s", "attention_est_s", "pagewrite_est_s",
        "bare_matmul_s", "kernel_standalone_per_burst_s",
        "sampling_standalone_per_burst_s"}
    assert set(out["floors"]) == {"weights_read_per_burst_s",
                                  "kv_read_per_burst_s", "combined_floor_s"}
    assert set(out["shares"]) == {"attention", "write", "sampling", "matmul"}
    # Every leg keeps its three runs, and each component says whether its
    # difference stands above the spread of the legs it comes from.
    assert all(len(v) == 3 for v in out["runs_s"].values())
    assert set(out["spread_s"]) == set(out["runs_s"])
    assert set(out["resolved"]) == {"attention", "write", "sampling"}
    assert_originals()


def test_scattered_table_reads_each_page_once():
    from production_stack_tpu_torch.probes import _profile_common as common

    table = common.scattered_table(np.random.default_rng(0), 843, 16, 64, 47)
    assert table.shape == (16, 64)
    live = table[:, :47].reshape(-1)
    assert len(set(live.tolist())) == live.size == 752
    assert live.min() >= 0 and live.max() < 843
    assert not table[:, 47:].any()
    with pytest.raises(ValueError):
        common.scattered_table(np.random.default_rng(0), 100, 16, 64, 47)


def test_prefill_profile_hermetic_has_the_jax_keys():
    out = _json_line(prefill_profile.main, ["--hermetic"])
    assert out["metric"] == "prefill_profile"
    assert out["hermetic"] and out["model"] == "tiny-llama"
    assert out["chunk"] == 128 and out["device"] == "cpu"
    assert [c["offset"] for c in out["chunks"]] == [0, 128]
    for row in out["chunks"]:
        assert set(row["components"]) == {"attention_est_s", "copy_est_s",
                                          "matmul_est_s"}
        for key in ("full_s", "noattn_s", "nowrite_s", "bare_matmul_s"):
            assert row[key] > 0
    assert set(out["floors"]) == {"weights_read_per_chunk_s",
                                  "kv_write_per_chunk_s"}
    ab = out["kernel_ab"]["per_chunk"]
    assert [r["context"] for r in ab] == [128, 256]
    assert all(r["kernel_ms"] is None for r in ab)  # no card, no time
    fused = out["fused_dispatch"]
    assert fused["streams_equal"]
    assert fused["dispatches_saved"] > 0
    assert fused["fused"]["fused_steps_total"] > 0
    assert_originals()


def test_dispatch_accounting_has_the_jax_keys():
    out = _json_line(dispatch_accounting.main, [
        "--device", "cpu", "--model", "tiny-llama", "--batch", "2",
        "--steps", "2", "--ctx", "20", "--block-size", "4", "--maxb", "8",
        "--prefill", "8", "--requests", "2", "--prompt", "12",
        "--max-tokens", "4", "--reps", "2"])
    assert out["metric"] == "dispatch_accounting"
    for key in ("trivial_dispatch_roundtrip_s", "trivial_dispatch_enqueue_s",
                "burst_sync_s", "burst_pipelined_s", "prefill8_sync_s",
                "prefill8_pipelined_s", "decode_tokens_per_burst",
                "burst_on_chip_s", "decode_tok_s_on_chip_ceiling",
                "decode_mfu_on_chip_ceiling", "note"):
        assert key in out, key
    assert out["burst_device_busy_s"] is None  # a CPU clock: no device time
    served = out["served"]
    assert served["dispatch_count_total"] > 0
    assert served["generation_tokens_total"] > 0
    assert "direct" not in out["note"]


@pytest.fixture(scope="module")
def engine():
    core = EngineCore(EngineConfig(
        model="tiny-llama", device="cpu", dtype="float32", max_model_len=128,
        max_num_seqs=2, decode_steps=2, block_size=4, num_blocks=32,
        max_loras=0))
    yield core
    core.stop()


def _burst(core):
    args = decode_profile.burst_args(core, 20, np.random.default_rng(0), 8)
    return decode_profile.run_burst(core, args)


def _pool(core):
    return [t.clone() for t in core.kv]


def test_each_ablation_removes_its_component(engine):
    before = _pool(engine)
    full = _burst(engine)
    written = _pool(engine)
    assert any(not torch.equal(a, b) for a, b in zip(before, written))
    with common.ablate(write=True):
        _burst(engine)
    # Without the scatter no page bit moves.
    assert all(torch.equal(a, b) for a, b in zip(written, _pool(engine)))
    with common.ablate(attn=True):
        no_attn = _burst(engine)
    assert not torch.equal(no_attn[1], full[1])  # the logprobs moved
    with common.ablate(sample=True):
        no_sample = _burst(engine)
    assert torch.count_nonzero(no_sample[1]) == 0
    with common.ablate(plain_attn=True):
        assert llama.paged_decode_attention is \
            attention.paged_attention_reference
    assert_originals()


def test_ablate_puts_the_originals_back_on_an_error():
    with pytest.raises(RuntimeError):
        with common.ablate(attn=True, write=True, sample=True):
            assert llama.scatter_kv_pages is not attention.scatter_kv_pages
            raise RuntimeError("inside")
    assert_originals()


def test_engine_streams_equal_jax_after_the_profilers():
    from test_torch_engine import GREEDY, Pair, assert_same_streams

    pair = Pair(max_loras=0)
    try:
        core = pair.torch
        res = decode_profile.profile(core, ctx=20, reps=1, maxb=8)
        assert res["noattn_s"] > 0
        rows = prefill_profile.chunk_rows(core, 16, [0, 16], reps=1)
        assert len(rows) == 2
        assert_originals()
        prompts = [[1, 5, 9, 13, 17], [2, 4, 8, 16, 32, 64, 3]]
        want, got = pair.run(prompts, GREEDY)
        assert_same_streams(pair, prompts, want[0], got[0])
    finally:
        pair.stop()


@pytest.mark.parametrize("bs", kernel_bs_sweep.PAGE_SIZES)
def test_page_size_layout_gives_the_unpaged_attention(bs):
    """One logical context (float32) laid out at ``bs``-token pages:
    the plain version over the pages equals attention over the context
    itself."""
    g = torch.Generator().manual_seed(bs)
    B, S, ctx, H, KVH, D = 2, 512, 300, 16, 8, 128
    k = torch.randn((B, S, KVH, D), generator=g)
    v = torch.randn((B, S, KVH, D), generator=g)
    q = torch.randn((B, H, D), generator=g)
    kp, vp, bt = kernel_bs_sweep.layout(k, v, bs, 2 * B * S // bs + 3,
                                        np.random.default_rng(bs))
    cl = torch.full((B,), ctx, dtype=torch.int32)
    got = attention.paged_attention_reference(q, kp, vp, bt, cl, 0,
                                              scale=D ** -0.5)
    kk = k[:, :ctx].repeat_interleave(H // KVH, dim=2)
    vv = v[:, :ctx].repeat_interleave(H // KVH, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q, kk) * D ** -0.5
    want = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1), vv)
    assert float((got - want).abs().max()) <= 1e-5


def test_page_size_sweep_cpu_rows_agree():
    out = _json_line(kernel_bs_sweep.main, ["--device", "cpu"])
    assert out["metric"] == "kernel_bs_sweep"
    assert [r["bs"] for r in out["rows"]] == [64, 128, 256, 512]
    assert all(r["max_abs_diff_vs_bs64"] <= 1e-5 for r in out["rows"])
    assert all(r["kernel_ms"] is None for r in out["rows"])


def test_kv_handoff_continues_the_stream_without_a_handoff():
    out = kv_handoff_bench.run("tiny-llama", 200, "auto", "cpu", "float32",
                               continue_tokens=8, block_size=16)
    assert out["metric"] == "kv_handoff"
    assert out["path"] == "local-device" and out["injected_blocks"] > 0
    assert out["bytes"] > 0 and out["gigabytes_per_second"] > 0
    args = kv_handoff_bench.server_args("tiny-llama", "cpu", 200, "float32",
                                        16)
    httpd, core, port = kv_handoff_bench.start_local(args)
    try:
        fresh = []
        for tokens in kv_handoff_bench.prompts(200,
                                               core.model_config.vocab_size):
            status, body = kv_handoff_bench.post(port, "/v1/completions", {
                "prompt": tokens, "max_tokens": 8, "temperature": 0.0,
                "ignore_eos": True})
            assert status == 200
            fresh.append(body["choices"][0]["text"])
        assert core.stats()["prefix_cache_hits"] == 0
    finally:
        kv_handoff_bench.stop_local(httpd, core)
    assert out["continuations"] == fresh
    assert out["prefix_cache_hits"] > 0  # the pulled pages served them


def test_transfer_probe_refuses_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "production_stack_tpu_torch.probes."
         "transfer_repro"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metric"] == "transfer_repro" and out["ok"] is False
    offer = out["handshake"]["offer"]
    assert offer["exit_code"] != 0
    assert any("CUDA" in line for line in offer["stderr_tail"]), offer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    return torch.device("cuda")


@pytest.mark.cuda
def test_page_size_sweep_on_the_card(cuda):
    for row in kernel_bs_sweep.sweep(cuda):
        if "error" in row:
            continue  # a page size the kernel refuses, recorded as such
        assert row["max_abs_err"] <= kernel_bs_sweep.BAR
        assert row["kernel_ms"] > 0 and row["bound_ms"] > 0


@pytest.mark.cuda
def test_decode_profile_on_the_card(cuda):
    out = _json_line(decode_profile.main, [
        "--model", "tiny-llama", "--batch", "4", "--steps", "4", "--ctx",
        "600", "--reps", "2"])
    assert out["device"] != "cpu" and out["power_limit"]
    assert out["kernel_Llayers_1step_s"] > 0
    assert_originals()
