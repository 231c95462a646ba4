"""A whole run at toy sizes on the CPU (the look for a card skipped):
the sound program comes out correct, and the run comes out not correct
with the timed path broken underneath in each way a served model can
be: a token altered where it is produced, and a step that leaves its
state unchanged (the KV pages never written)."""

import pytest

from portbench import harness, spec
from portbench.tests.tinybench import make_root, tiny_config

SEED = 2 ** 31 + 4242


def run(tmp_path, arch="llama", loop="closed", trace=False, device="cpu",
        **kw):
    root = make_root(str(tmp_path), arch, loop)
    cell = spec.load_cell(root, f"tiny.{loop}")
    return harness.run_cell(cell, SEED, 3.0, trace, device=device, **kw)


@pytest.mark.parametrize("arch,loop", [("llama", "closed"),
                                       ("mixtral", "open")])
def test_sound_run_is_correct(tmp_path, arch, loop):
    res = run(tmp_path, arch, loop, control=True)
    assert res["correct"] is True
    chk, got = res["check"], res["readings"]
    assert chk["max_gap"]["value"] <= chk["max_gap"]["limit"]
    assert chk["finished"]["value"] >= chk["finished"]["limit"]
    assert got["tokens"] >= tiny_config(arch)["check"]["sample_tokens"]
    # The control, judged by the same limits, fails them.
    assert got["control_max_gap"] > chk["max_gap"]["limit"]
    assert res["control_correct"] is False
    if arch == "mixtral":
        # The reference's router margins at the widest gaps.
        assert len(got["margin_at_widest"]) == len(got["widest_gaps"]) == 5
        assert all(0 <= r < 100 for r in got["margin_rank_at_widest"])
        assert got["margin_median"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    assert {"setup_s", "ttft_p90_s", "tpot_p90_ms"} <= names
    assert list(res)[-1] == "check"
    assert harness.forbidden_modules() == []


def test_traced_run_reads_the_per_layer_metrics(tmp_path):
    res = run(tmp_path, "llama", "open", trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    assert {"queue_wait_ms_p90", "prefix_hit_pct", "decode_ms_per_forward",
            "prefill_ms_per_1k_tok", "server_ttft_overhead_ms",
            "kv_live_gb"} <= set(m)
    assert m["prefix_hit_pct"]["value"] > 0  # asks reuse their document
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_altered_token_is_not_correct(tmp_path, monkeypatch):
    from production_stack_tpu_torch.engine.core import EngineCore

    emit = EngineCore._emit_token
    vocab = tiny_config()["vocab_size"]

    def altered(self, seq, token, lp=None):
        if len(seq.req.output_token_ids) == 3:
            token = (token + 1) % vocab
        return emit(self, seq, token, lp)

    monkeypatch.setattr(EngineCore, "_emit_token", altered)
    res = run(tmp_path)
    assert res["correct"] is False
    assert res["check"]["max_gap"]["value"] > res["check"]["max_gap"][
        "limit"]


def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    from production_stack_tpu_torch.models import llama

    monkeypatch.setattr(llama, "scatter_kv_pages", lambda *a, **k: None)
    res = run(tmp_path)
    assert res["correct"] is False


@pytest.mark.cuda
def test_tiny_run_on_the_card(tmp_path):
    """The same run on the card: the port's CUDA kernels on the timed
    path, the device trace read. Run on the card: ``python -m pytest -m
    cuda portbench/tests``."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = run(tmp_path, "llama", "open", trace=True, device="cuda")
    assert res["readings"]["tokens"] > 0
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert "device_idle_pct.decode" in res["metrics"]
