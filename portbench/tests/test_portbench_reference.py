"""The plain reference against the port's model at toy sizes, on the
CPU: the same weights (drawn by the benchmark from the seed), the same
tokens, float32 both. Only this test imports the port; the reference
modules do not."""

import pytest
import torch

from portbench import spec, weights
from portbench.reference import check, model
from portbench.tests.tinybench import tiny_config

SEED = 2 ** 31 + 99


def port_logits(arch, tokens):
    from production_stack_tpu_torch.models.config import ModelConfig
    from production_stack_tpu_torch.models.registry import build_model

    cfg_json = tiny_config(arch)
    s = spec.Shape.from_config(cfg_json)
    mc = ModelConfig(name="tiny", arch=s.arch, vocab_size=s.vocab,
                     hidden_size=s.hidden, num_layers=s.layers,
                     num_heads=s.heads, num_kv_heads=s.kv_heads,
                     head_dim=s.head_dim, intermediate_size=s.intermediate,
                     rope_theta=s.rope_theta, rms_norm_eps=s.eps,
                     num_experts=s.experts, experts_per_token=s.top_k,
                     dtype="float32")
    _, apply = build_model(mc)
    params = weights.draw_params(s, SEED, torch.float32, "cpu")
    T, bs = len(tokens), 16
    nb = (T + bs - 1) // bs
    pages = torch.zeros((s.layers, nb, bs, s.kv_heads, s.head_dim))
    kv = (pages, pages.clone())
    ids = torch.tensor([tokens])
    pos = torch.arange(T)[None]
    with torch.no_grad():
        logits, _ = apply(params, mc, ids, pos, kv, pos.clone(),
                          torch.arange(nb, dtype=torch.int32)[None],
                          torch.tensor([T]), torch.tensor([T]),
                          mode="prefill")
    return s, logits[0]


@pytest.mark.parametrize("arch", ["llama", "mixtral"])
def test_reference_matches_the_port(arch):
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 512, (40,), generator=g).tolist()
    s, got = port_logits(arch, tokens)
    ref = model.next_token_logits(s, SEED, [tokens], [0], "cpu")[0]
    assert ref.shape == got.shape
    assert torch.allclose(ref, got, atol=2e-4, rtol=1e-4), (
        (ref - got).abs().max())


@pytest.mark.parametrize("arch", ["llama", "mixtral"])
def test_the_control_departs_from_the_reference(arch):
    """The float8 control reads a gap that the float32 port does not."""
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, 512, (24,), generator=g).tolist()
    s = spec.Shape.from_config(tiny_config(arch))
    # Greedy tokens of the reference itself: every gap 0.
    seq = list(prompt)
    for _ in range(24):
        nxt = model.next_token_logits(s, SEED, [seq], [len(seq) - 1],
                                      "cpu")[0]
        seq.append(int(nxt[-1].argmax()))
    reqs = [{"rid": "a", "prompt": prompt, "served": seq[len(prompt):]}]
    ref = check.reference_logits(s, SEED, reqs, "cpu")
    assert check.served_gap(ref, reqs)["max_gap"] == 0.0
    ctrl = check.reference_logits(s, SEED, reqs, "cpu", precision="fp8")
    gap = check.control_gap(ref, ctrl)
    assert gap["max_gap"] > tiny_config(arch)["check"]["limits"]["max_gap"]
    assert gap["not_best_pct"] > 0


def test_fp8_rounding_has_one_scale_per_output_channel():
    w = torch.randn(64, 8) * torch.linspace(0.1, 10, 8)
    r = model.fp8_round(w)
    rel = ((r - w).abs() / w.abs().amax(0)).amax(0)
    assert torch.all(rel < 2 ** -3) and torch.all(rel > 0)


def test_sample_takes_the_longest_and_a_prefix_hit():
    reqs = [{"rid": f"r{i}", "prompt": [1] * (10 + i), "served": [2] * 5,
             "cached": 16 if i == 3 else 0} for i in range(20)]
    got = check.sample(reqs, 7, 12)
    assert got[0]["rid"] == "r19" and got[1]["rid"] == "r3"
    assert len(got) == 3  # 15 tokens >= 12
    assert check.sample(reqs, 7, 12) == got
