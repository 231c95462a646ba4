"""The frozen operation and byte counts against counts made by hand."""

import json
import os

import pytest

from portbench import flops, spec
from portbench.tests.tinybench import REPO


def shape(name):
    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as f:
        return spec.Shape.from_config(json.load(f))


def test_parameter_counts_of_the_published_models():
    m = shape("mistral-7b")
    total = (m.layers * flops.matmul_params_per_token(m)
             + 2 * m.vocab * m.hidden + (2 * m.layers + 1) * m.hidden)
    assert total == pytest.approx(7.24e9, rel=2e-3)  # Mistral-7B
    x = shape("mixtral-8x7b")
    assert x.layers == 16
    active = flops.matmul_params_per_token(x)
    # Attention 4096 x 128 x (32 + 32 + 8 + 8), router 4096 x 8, and two
    # experts of 3 x 4096 x 14336.
    assert active == 4096 * 128 * 80 + 4096 * 8 + 2 * 3 * 4096 * 14336
    # The whole layer, every expert: 1.41 B; 16 of them and the
    # embedding and head: 23.5 B parameters.
    whole = 4096 * 128 * 80 + 4096 * 8 + 8 * 3 * 4096 * 14336
    assert 16 * whole + 2 * 32000 * 4096 == pytest.approx(23.48e9,
                                                          rel=2e-3)


def test_prefill_closed_form_equals_the_token_sum():
    s = shape("mistral-7b")
    for prompt, skipped in ((300, 0), (2600, 2048), (64, 63)):
        by_token = sum(flops.token_flops(s, p + 1, p == prompt - 1)
                       for p in range(skipped, prompt))
        assert flops.prefill_flops(s, prompt, skipped) == pytest.approx(
            by_token, rel=1e-12)
    assert flops.prefill_flops(s, 100, 100) == 0.0


def test_cached_prefill_counts_only_chunks_with_a_context():
    s = shape("mistral-7b")
    per = 4.0 * s.layers * s.heads * s.head_dim
    # A 2,500-token prompt computed from the start: its first 1,024-token
    # chunk attends within itself, the rest over their whole context.
    got = flops.cached_prefill_flops(s, 2500, 0, 1024)
    assert got == pytest.approx(per * sum(p + 1 for p in range(1024, 2500)))
    # After a 2,048-token prefix hit every computed token counts.
    got = flops.cached_prefill_flops(s, 2100, 2048, 1024)
    assert got == pytest.approx(per * sum(p + 1 for p in range(2048, 2100)))
    # A prompt within one chunk never runs the cached kernel.
    assert flops.cached_prefill_flops(s, 500, 0, 1024) == 0.0


def test_decode_bytes_by_hand():
    s = shape("mistral-7b")
    ctx = 1000
    kv = 32 * 2 * 8 * 128 * 2 * 1000      # layers x K,V x heads x D x bf16
    q_out = 32 * 2 * 32 * 128 * 2
    table = 32 * (4 * 16 + 4)              # 16 pages of 64, and the length
    assert flops.decode_token_bytes(s, ctx, 64) == kv + q_out + table
    # One token's attention operations: 4 x layers x heads x D x ctx.
    assert flops.attention_flops(s, ctx) == 4 * 32 * 32 * 128 * 1000
