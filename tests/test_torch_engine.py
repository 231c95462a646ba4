"""The torch ``EngineCore`` against the JAX one: same configuration (the
``make_engine`` kwargs of tests/test_engine_core.py, float32), the JAX
engine's own weights carried over with ``params_from_numpy``, and the
same requests — the greedy token streams must be identical.

A stream may only differ at a position where JAX's top-2 logit gap is
below 1e-4 (a near-tie of random weights, where float32 summation order
decides); the check below says so when it happens."""

import dataclasses
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import build_model as jax_build_model
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

MAKE_ENGINE = dict(model="tiny-llama", max_model_len=128, max_num_seqs=4,
                   block_size=4, num_blocks=96, min_prefill_bucket=16,
                   max_loras=4, dtype="float32")
NEAR_TIE = 1e-4


class Pair:
    """A JAX engine and a torch engine with the JAX engine's weights."""

    def __init__(self, **over):
        kwargs = dict(MAKE_ENGINE, **over)
        self.jax = JaxEngineCore(JaxEngineConfig(**kwargs),
                                 devices=jax.devices()[:1])
        tree = jax.tree.map(np.asarray, self.jax.params)
        cfg = EngineConfig(device="cpu", **kwargs)
        self.torch = EngineCore(
            cfg, params=params_from_numpy(tree, cfg_model(cfg), "cpu"))
        self.jax.start()
        self.torch.start()

    def stop(self):
        self.jax.stop()
        self.torch.stop()

    def run(self, prompts, sampling, concurrent=True):
        """Streams of every prompt from both engines."""
        return ([_collect(self.jax, prompts, JaxSamplingParams(**sampling),
                          concurrent)],
                [_collect(self.torch, prompts, SamplingParams(**sampling),
                          concurrent)])


def cfg_model(cfg):
    from production_stack_tpu_torch.models import get_model_config

    return get_model_config(cfg.model).replace(dtype=cfg.dtype)


_ids = iter(range(10 ** 9))


def _collect(engine, prompts, sampling, concurrent, timeout=240):
    results = {}

    def one(i, prompt):
        q: "queue.Queue" = queue.Queue()
        engine.add_request(f"r{next(_ids)}", prompt, sampling,
                           lambda t, f: q.put((t, f)))
        tokens, deadline = [], time.time() + timeout
        while time.time() < deadline:
            try:
                t, f = q.get(timeout=5)
            except queue.Empty:
                continue
            if t is not None:
                tokens.append(t if isinstance(t, int) else t[0])
            if f is not None:
                results[i] = (tokens, f)
                return
        results[i] = (tokens, "timeout")

    if concurrent:
        threads = [threading.Thread(target=one, args=(i, p))
                   for i, p in enumerate(prompts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout + 10)
    else:
        for i, p in enumerate(prompts):
            one(i, p)
    return [results[i] for i in range(len(prompts))]


def _top2_gap(pair, tokens):
    """JAX's top-1 minus top-2 next-token logit after ``tokens`` (a full
    recompute with the JAX engine's weights)."""
    jeng = pair.jax
    cfg = jeng.model_config
    _, apply = jax_build_model(cfg)
    n = len(tokens)
    bs, nb = 4, (n + 3) // 4 + 1
    kv = tuple(jnp.zeros((cfg.num_layers, nb, bs, cfg.num_kv_heads,
                          cfg.head_dim), cfg.jnp_dtype) for _ in range(2))
    logits, _ = apply(
        jeng.params, cfg, jnp.asarray([tokens], jnp.int32),
        jnp.arange(n, dtype=jnp.int32)[None], kv,
        jnp.arange(n, dtype=jnp.int64)[None],
        jnp.arange(nb, dtype=jnp.int32)[None], jnp.asarray([n], jnp.int32),
        jnp.asarray([n], jnp.int32), mode="prefill")
    top2 = np.sort(np.asarray(logits[0, n - 1]))[-2:]
    return float(top2[1] - top2[0])


def assert_same_streams(pair, prompts, want, got):
    for prompt, (w_tok, w_fin), (g_tok, g_fin) in zip(prompts, want, got):
        assert w_fin != "timeout" and g_fin != "timeout"
        if g_tok == w_tok:
            assert g_fin == w_fin
            continue
        i = next((j for j, (a, b) in enumerate(zip(w_tok, g_tok)) if a != b),
                 min(len(w_tok), len(g_tok)))
        gap = _top2_gap(pair, list(prompt) + w_tok[:i])
        assert gap < NEAR_TIE, (
            f"streams diverge at {i} (jax {w_tok}, torch {g_tok}) where "
            f"JAX's top-2 gap is {gap}, not a near-tie")
        print(f"accepted divergence at {i}: JAX top-2 gap {gap:.2e} < "
              f"{NEAR_TIE} (near-tie of random weights)")


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.stop()


@pytest.fixture(scope="module")
def small_pair():
    """Short prefill chunks and a pool small enough to preempt."""
    p = Pair(prefill_chunk_size=16, num_blocks=24)
    yield p
    p.stop()


GREEDY = dict(temperature=0.0, max_tokens=8)


def test_one_prompt(pair):
    prompts = [[1, 2, 3, 4, 5, 6, 7]]
    (want,), (got,) = pair.run(prompts, GREEDY)
    assert_same_streams(pair, prompts, want, got)
    assert got[0][1] == "length" and len(got[0][0]) == 8


def test_three_concurrent_prompts(pair):
    prompts = [[10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28],
               list(range(40, 61))]
    (want,), (got,) = pair.run(prompts, dict(temperature=0.0, max_tokens=12))
    assert_same_streams(pair, prompts, want, got)


def test_prefix_cache_hit(pair):
    base = list(range(100, 130))  # 7 full 4-token pages + 2 tokens
    first = [base + [7, 8]]
    pair.run(first, GREEDY)
    cached_before = pair.torch.cached_tokens_total
    prompts = [base + [9, 10, 11]]
    (want,), (got,) = pair.run(prompts, GREEDY)
    assert pair.torch.cached_tokens_total - cached_before >= 28
    assert_same_streams(pair, prompts, want, got)


def test_logit_shaping_in_the_engine(pair):
    """Penalties, logit_bias, min_tokens and stop ids through both
    engines' serving paths (greedy, so the streams must agree)."""
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
    sampling = dict(temperature=0.0, max_tokens=10, presence_penalty=0.7,
                    frequency_penalty=0.4, logit_bias={5: 1.5, 300: -2.0},
                    min_tokens=4, stop_token_ids=[11])
    (want,), (got,) = pair.run(prompts, sampling)
    assert_same_streams(pair, prompts, want, got)


def test_chunked_long_prompt(small_pair):
    prompts = [list(range(200, 250))]  # 50 tokens: chunks 16+16+16+2
    chunks_before = small_pair.torch.prefill_chunks_total
    (want,), (got,) = small_pair.run(prompts, GREEDY, concurrent=False)
    assert small_pair.torch.prefill_chunks_total - chunks_before == 4
    assert_same_streams(small_pair, prompts, want, got)


def test_preemption_with_few_blocks(small_pair):
    prompts = [list(range(300 + 10 * i, 310 + 10 * i)) for i in range(4)]
    sampling = dict(temperature=0.0, max_tokens=24)
    (want,), (got,) = small_pair.run(prompts, sampling)
    assert small_pair.torch.scheduler.num_preempted_total > 0
    assert_same_streams(small_pair, prompts, want, got)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCore(EngineConfig(**dict(MAKE_ENGINE, device="cuda")))


@pytest.mark.parametrize("over", [
    # Data, pipeline and tensor parallelism construct
    # (tests/test_torch_pp.py, tests/test_torch_tp.py); the KV offload
    # tier is refused under each of them.
    dict(data_parallel_size=2, kv_offload_bytes=1 << 20),
    dict(pipeline_parallel_size=2, kv_offload_bytes=1 << 20),
    dict(tensor_parallel_size=2, kv_offload_bytes=1 << 20),
    dict(fused_step=True)])
def test_unported_features_are_refused(over):
    cfg = EngineConfig(device="cpu", **dict(MAKE_ENGINE, **over))
    with pytest.raises(NotImplementedError, match="not supported"):
        EngineCore(cfg)


def test_kv_pool_is_sized_like_jax_without_a_memory_figure():
    cfg = EngineConfig(device="cpu", **dict(MAKE_ENGINE, num_blocks=None))
    jcfg = JaxEngineConfig(**dict(MAKE_ENGINE, num_blocks=None))
    eng = EngineCore(dataclasses.replace(cfg, max_loras=0))
    # No memory figure on the CPU: the minimal 2-sequence pool, as the
    # JAX engine sizes CPU meshes.
    assert eng.num_blocks == jcfg.max_blocks_per_seq * 2
    assert eng.kv[0].shape == (2, eng.num_blocks, 4, 2, 32)
    assert eng.stats()["kv_cache_bytes_per_token"] == 2 * 2 * 2 * 32 * 4
