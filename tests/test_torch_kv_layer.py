"""KV movement in the torch ``EngineCore`` against the JAX one (tiny-llama
float32, the JAX engine's weights carried over, pages in the model dtype
or int8):

- offload and restore: one trace on both engines with a small pool and a
  host-RAM tier, whose first prompt is evicted and served again; greedy
  streams identical, the tiers' counters equal, and restores happen;
- ``extract_kv`` of either engine into the other's ``inject_kv``: the
  injected prefix serves as a hit and continues the stream that engine
  pair gives on its own prefix hit, and the installed pages are the
  source's bit for bit;
- ``inject_from_core`` between two port cores;
- a restore that misses (the store answers ``contains`` but not ``get``,
  or gives a block of the other page encoding) recomputes the same stream
  and leaves no unwritten page in the prefix map."""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
from test_torch_engine import (
    MAKE_ENGINE,
    Pair,
    _collect,
    assert_same_streams,
    cfg_model,
)

torch.set_num_threads(1)

GREEDY = dict(temperature=0.0, max_tokens=4)
# A small pool (24 blocks of 4 tokens) and a host tier that holds every
# spill: four 40-token prompts evict the first prompt's blocks.
OFFLOAD = dict(num_blocks=24, kv_offload_bytes=1 << 30,
               prefill_chunk_size=16)
PROMPT_A = list(range(100, 130))  # 7 full blocks + 2 tokens
FILLERS = [list(range(200 + 50 * i, 240 + 50 * i)) for i in range(4)]
OFFLOAD_KEYS = ("hits", "misses", "stored", "evicted", "blocks", "bytes")


@pytest.fixture(scope="module", params=["model dtype", "int8"])
def pair(request):
    over = dict(OFFLOAD)
    if request.param == "int8":
        over["kv_cache_dtype"] = "int8"
    p = Pair(**over)
    yield p
    p.stop()


def _serve(p: Pair, prompt):
    """One greedy request on each engine, in turn (the pools see the same
    sequence of allocations)."""
    (want,), (got,) = p.run([prompt], GREEDY, concurrent=False)
    assert_same_streams(p, [prompt], want, got)
    return want[0][0]


def _np(x):
    """A torch page leaf as numpy for the JAX engine (f32 or int8 pairs)."""
    if isinstance(x, tuple):
        return tuple(_np(t) for t in x)
    return x.numpy()


def _torch(x):
    if isinstance(x, tuple):
        return tuple(_torch(t) for t in x)
    return torch.from_numpy(np.array(x))


def _same_pages(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_offload_restore_matches_jax(pair):
    _serve(pair, PROMPT_A)
    hit = _serve(pair, PROMPT_A)  # a prefix hit: the stream to restore
    for f in FILLERS:
        _serve(pair, f)
    tstats = pair.torch.stats()["offload"]
    assert tstats["stored"] >= 7  # PROMPT_A's full blocks spilled
    hits_before = tstats["hits"]
    cached_before = pair.torch.cached_tokens_total
    again = _serve(pair, PROMPT_A)
    tstats = pair.torch.stats()["offload"]
    jstats = pair.jax.stats()["offload"]
    assert tstats["hits"] - hits_before >= 7, tstats
    assert pair.torch.cached_tokens_total - cached_before >= 28
    assert again == hit
    assert {k: tstats[k] for k in OFFLOAD_KEYS} == {
        k: jstats[k] for k in OFFLOAD_KEYS}
    t_occ = pair.torch.stats()["kv_page_occupancy"]
    assert t_occ == pair.jax.stats()["kv_page_occupancy"]
    assert t_occ["offload"] == tstats["blocks"] > 0


def test_jax_extract_into_port_inject(pair):
    prompt = list(range(400, 433))  # 8 full blocks + 1 token
    pair.jax.add_request("jx-fill", prompt, _jax_greedy(), lambda t, f: None)
    _wait_idle(pair.jax)
    payload = pair.jax.extract_kv(prompt)
    assert payload is not None and len(payload["hashes"]) == 8
    n = pair.torch.inject_kv(payload["hashes"], _torch(payload["k"]),
                             _torch(payload["v"]))
    assert n == 8
    cached = pair.torch.cached_tokens_total
    (got,) = [_collect(pair.torch, [prompt], SamplingParams(**GREEDY),
                       False)]
    assert pair.torch.cached_tokens_total - cached == 32
    (want,), _ = pair.run([prompt], GREEDY, concurrent=False)
    assert got[0] == want[0]  # the JAX engine's own prefix-hit stream
    back = pair.torch.extract_kv(prompt)
    _same_pages(_np(back["k"]), payload["k"])
    _same_pages(_np(back["v"]), payload["v"])


def test_port_extract_into_jax_inject(pair):
    prompt = list(range(600, 633))
    _collect(pair.torch, [prompt], SamplingParams(**GREEDY), False)
    payload = pair.torch.extract_kv(prompt)
    assert payload is not None and len(payload["hashes"]) == 8
    assert pair.jax.inject_kv(payload["hashes"], _np(payload["k"]),
                              _np(payload["v"])) == 8
    back = pair.jax.extract_kv(prompt)
    _same_pages(_np(payload["k"]), back["k"])
    _same_pages(_np(payload["v"]), back["v"])
    cached = pair.jax.cached_tokens_total
    (want,), (got,) = pair.run([prompt], GREEDY, concurrent=False)
    assert pair.jax.cached_tokens_total - cached == 32
    assert_same_streams(pair, [prompt], want, got)


def _jax_greedy():
    from production_stack_tpu.engine.sampling import (
        SamplingParams as JaxSamplingParams,
    )

    return JaxSamplingParams(**GREEDY)


def _wait_idle(core, timeout=120):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        s = core.stats()
        if not s["num_requests_running"] and not s["num_requests_waiting"]:
            return
        time.sleep(0.05)
    raise AssertionError("engine did not go idle")


def _port_core(params, **over):
    cfg = EngineConfig(device="cpu", **dict(MAKE_ENGINE, **over))
    core = EngineCore(cfg, params=params)
    core.start()
    return core


@pytest.fixture(scope="module")
def port_params(pair):
    import jax

    tree = jax.tree.map(np.asarray, pair.jax.params)
    cfg = EngineConfig(device="cpu", **MAKE_ENGINE)
    return params_from_numpy(tree, cfg_model(cfg), "cpu")


def test_inject_from_core_between_port_cores(pair, port_params):
    over = ({"kv_cache_dtype": "int8"}
            if pair.torch.config.kv_cache_dtype == "int8" else {})
    src = _port_core(port_params, **over)
    dst = _port_core(port_params, **over)
    other = _port_core(port_params, **(
        {} if over else {"kv_cache_dtype": "int8"}))
    try:
        prompt = list(range(700, 733))
        sp = SamplingParams(**GREEDY)
        _collect(src, [prompt], sp, False)
        assert other.inject_from_core(src, prompt) == 0  # encodings differ
        assert dst.inject_from_core(src, prompt) == 8
        assert dst.inject_from_core(src, prompt) == 8  # already cached
        _same_pages(_np(dst.extract_kv(prompt)["k"]),
                    _np(src.extract_kv(prompt)["k"]))
        (got,) = _collect(dst, [prompt], sp, False)
        (want,) = _collect(src, [prompt], sp, False)  # src's prefix hit
        assert dst.cached_tokens_total == 32
        assert got == want
    finally:
        for c in (src, dst, other):
            c.stop()


def _foreign_block(core):
    """A block of the other page encoding, at this pool's per-block
    shape: int8 pairs for a model-dtype pool, float32 pages for int8."""
    mc, bs = core.model_config, core.config.block_size
    shape = (mc.num_layers, bs, mc.num_kv_heads, mc.head_dim)
    if core.config.kv_cache_dtype == "int8":
        side = torch.zeros(shape)
    else:
        side = (torch.zeros(shape, dtype=torch.int8),
                torch.ones((mc.num_layers, bs * mc.num_kv_heads)))
    return side, side


@pytest.mark.parametrize("lost", ["no block", "foreign encoding"])
def test_restore_miss_recomputes(pair, port_params, lost):
    over = ({"kv_cache_dtype": "int8"}
            if pair.torch.config.kv_cache_dtype == "int8" else {})
    core = _port_core(port_params, **dict(OFFLOAD, **over))
    # The same chunking without a tier: the recompute's own path.
    ref = _port_core(port_params, **dict(OFFLOAD, kv_offload_bytes=0, **over))
    try:
        sp = SamplingParams(**GREEDY)
        (fresh,) = _collect(core, [PROMPT_A], sp, False)
        for f in FILLERS:
            _collect(core, [f], sp, False)
        store = core.offload
        assert store.contains(core.kv_mgr.allocator.chain_hash(
            core.kv_mgr.chain_root(""), tuple(PROMPT_A[:4])))
        # The store still answers contains() but has lost the blocks, or
        # holds another encoding's blocks under the same hashes.
        foreign = _foreign_block(core)
        store.get = ((lambda h: None) if lost == "no block"
                     else (lambda h: foreign))
        (again,) = _collect(core, [PROMPT_A], sp, False)
        assert again == fresh  # recomputed: the same path as the first run
        _collect(ref, [PROMPT_A], sp, False)
        got, want = core.extract_kv(PROMPT_A), ref.extract_kv(PROMPT_A)
        assert len(got["hashes"]) == 7 and got["hashes"] == want["hashes"]
        _same_pages(_np(got["k"]), _np(want["k"]))
        _same_pages(_np(got["v"]), _np(want["v"]))
    finally:
        core.stop()
        ref.stop()


def test_bad_payload_returns_the_blocks(pair):
    free = pair.torch.kv_mgr.allocator.num_free
    evictable = pair.torch.kv_mgr._evictable()
    k = torch.zeros((2, 3, 4, 5))  # no pool has this block shape
    with pytest.raises(ValueError):
        pair.torch.inject_kv([11, 12], k, k)
    assert 11 not in pair.torch.kv_mgr.allocator.prefix_map
    assert (pair.torch.kv_mgr.allocator.num_free
            + pair.torch.kv_mgr._evictable()) == free + evictable


def test_chunked_continuation_spills_before_its_forward(pair, port_params):
    """A chunked-prefill continuation that evicts cached blocks (its
    ``extend_tokens``) spills them before its own forward overwrites the
    recycled pages: the evicted prompt is later restored to its prefix-hit
    stream."""
    over = ({"kv_cache_dtype": "int8"}
            if pair.torch.config.kv_cache_dtype == "int8" else {})
    core = _port_core(port_params, **dict(
        OFFLOAD, enable_chunked_prefill=True, max_num_batched_tokens=16,
        **over))
    try:
        sp = SamplingParams(**GREEDY)
        _collect(core, [PROMPT_A], sp, False)
        (hit,) = _collect(core, [PROMPT_A], sp, False)
        chunks = core.prefill_chunks_total
        # 90 tokens in six chunks: the continuations evict A's blocks.
        _collect(core, [list(range(300, 390))], sp, False)
        assert core.prefill_chunks_total - chunks == 6
        a_chain = core.kv_mgr.chain_hashes(PROMPT_A)
        prefix_map = core.kv_mgr.allocator.prefix_map
        assert not any(h in prefix_map for h in a_chain)
        hits = core.offload.stats()["hits"]
        (again,) = _collect(core, [PROMPT_A], sp, False)
        assert core.offload.stats()["hits"] - hits == 7
        assert again == hit
    finally:
        core.stop()
