"""KV movement and the lifecycle across ranks in the torch port, against
the JAX engine.

Every rank is a process: module-scoped groups of 2 and 4 ranks join one
gloo job each (the ``Ranks`` harness of ``tests/test_torch_tp.py``), and
each engine job below runs one engine through a whole scenario, whose
results the tests read. The JAX side runs here, one process, on the same
tiny-llama float32 tree (``convert.params_from_numpy`` carries it to
every rank).

- ``parallel/kv_blocks.py``: ``block_slice`` and ``assemble`` round-trip
  whole blocks (bf16 and int8, at tp 2 and 4 and pp 2), where tp 4 holds
  each of the 2 KV heads twice and the int8 scales are a strided slice;
- extract at tp 2, pp 2, pp 2 x tp 2 and dp 2 (the ``gather_pages`` op):
  the JAX engine's payload to 1e-5, its hashes equal;
- inject at tp 2 and pp 2 (``write_pages`` in 4-block chunks): the
  continuation is the JAX engine's prefix-hit stream;
- the host-RAM tier at tp 2: every rank's store holds the same hashes in
  the same order, and the restored prefix gives the JAX engine's
  prefix-hit stream; the L3 tier (the JAX package's cache server) at tp
  2 with int8 pages restores the stream the prefix hit gave;
- sleep and wake at tp 2 and pp 2: every rank frees its weights and
  pool, and the streams after the wake are the streams before it;
- ``inject_from_core`` answers 0 under tp; a follower whose store misses
  a restore latches the engine's fault.
"""

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.kv.cache_server import CacheServer
from production_stack_tpu_torch.models import get_model_config
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.kv_blocks import (
    assemble,
    block_slice,
)
from test_torch_kv_offload import AioThread
from test_torch_tp import Ranks, _np_tree, _serve

torch.set_num_threads(1)

PAYLOAD_TOL = 1e-5
BASE = dict(model="tiny-llama", dtype="float32", max_model_len=128,
            max_num_seqs=2, block_size=4, num_blocks=24, max_loras=0,
            seed=0, prefill_chunk_size=16, min_prefill_bucket=16)
TIER = dict(kv_offload_bytes=1 << 30)
GREEDY = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
PROMPT = list(range(100, 130))  # 7 full blocks + 2 tokens
INJECTED = list(range(400, 433))  # 8 full blocks + 1 token
# Four 40-token prompts: on a 24-block pool they evict PROMPT's blocks.
FILLERS = [list(range(200 + 50 * i, 240 + 50 * i)) for i in range(4)]

# The ranks' side: join the job, then run each scenario sent on stdin.
_WORKER = r"""
import base64, pickle, sys, time, traceback, types
import numpy as np
import torch
torch.set_num_threads(1)
from production_stack_tpu_torch.parallel import multihost

env = multihost.initialize_from_env()
ctx = multihost.maybe_context()
rank = env["process_id"]


def np_leaf(x):
    if isinstance(x, (tuple, list)):
        return tuple(np_leaf(t) for t in x)
    return x.numpy().copy()


def t_leaf(x):
    if isinstance(x, (tuple, list)):
        return tuple(t_leaf(t) for t in x)
    return torch.from_numpy(np.array(x))


def serve(core, prompts):
    import queue
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    out = []
    for prompt in prompts:
        q = queue.Queue()
        core.add_request("s%d" % time.monotonic_ns(), prompt,
                         SamplingParams(**GREEDY), lambda t, f: q.put((t, f)))
        toks = []
        while True:
            t, f = q.get(timeout=60)
            if t is not None:
                toks.append(int(t))
            if f is not None:
                toks.append(f)
                break
        out.append(toks)
    return out


def act(core, name, *args):
    if name == "serve":
        return serve(core, args[0])
    if name == "extract":
        p = core.extract_kv(args[0])
        return p and dict(p, k=np_leaf(p["k"]), v=np_leaf(p["v"]))
    if name == "inject":
        hashes, k, v = args
        return core.inject_kv(hashes, t_leaf(k), t_leaf(v))
    if name == "inject_from_core":
        return [core.inject_from_core(core, args[0]),
                core.inject_from_core(types.SimpleNamespace(_mh=None),
                                      args[0])]
    if name == "sleep":
        core.sleep()
        return core.is_sleeping
    if name == "wake":
        core.wake_up()
        return core.is_sleeping
    if name == "ranks":
        return [{k: r[k] for k in ("rank", "offload_keys", "kv_pool_bytes",
                                   "weight_bytes", "sleep_freed_bytes",
                                   "kv_gathers_total")}
                for r in core.rank_stats()]
    if name == "stats":
        s = core.stats()
        return {"offload": s["offload"], "fatal": core.fatal_error,
                "cached": core.cached_tokens_total}
    raise ValueError(name)


def scenario(job):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore

    core = EngineCore(EngineConfig(**job["config"]), params=job["params"],
                      multihost=ctx)
    if rank != 0:
        if job.get("store_misses"):
            core.offload.get = lambda h: None
        try:
            core.run_follower()
        except Exception as e:
            return {"follower_error": str(e)}
        return {"follower_error": None}
    core.start()
    out = []
    try:
        for step in job["actions"]:
            out.append(act(core, *step))
    finally:
        core.stop()
    return {"results": out, "fatal": core.fatal_error}


GREEDY = None
for line in sys.stdin:
    job = pickle.loads(base64.b64decode(line))
    if job is None:
        break
    GREEDY = job.get("greedy")
    try:
        out = {"ok": scenario(job)}
    except BaseException:
        out = {"error": traceback.format_exc()}
    sys.stdout.write("RESULT " + base64.b64encode(pickle.dumps(out)).decode()
                     + "\n")
    sys.stdout.flush()
multihost.shutdown(ctx)
"""


@pytest.fixture(scope="module")
def ranks():
    groups = {2: Ranks(2, _WORKER), 4: Ranks(4, _WORKER)}
    yield groups
    for g in groups.values():
        g.close()


def _run(ranks, n, actions, params=None, job=None, **over):
    """One engine of ``n`` ranks (``BASE`` with ``over``) through
    ``actions`` on the leader: (the leader's results, the followers')."""
    res = ranks[n].run(dict(job or {}, config=dict(BASE, device="cpu",
                                                   **over),
                            params=params, actions=actions, greedy=GREEDY),
                       timeout=240)
    return res[0], res[1:]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine (one process) on tiny-llama float32: PROMPT's fresh
    and prefix-hit streams and its payload, and INJECTED's payload and
    prefix-hit stream."""
    core = JaxEngineCore(JaxEngineConfig(**BASE),
                         devices=jax.devices()[:1])
    core.start()
    try:
        reqs = [{"prompt": p, "sampling": GREEDY}
                for p in (PROMPT, PROMPT, INJECTED, INJECTED)]
        streams = _serve(core, reqs, JaxSamplingParams)
        return {"tree": _np_tree(core.params),
                "fresh": streams[0], "hit": streams[1],
                "injected_hit": streams[3],
                "payload": core.extract_kv(PROMPT),
                "injected": core.extract_kv(INJECTED)}
    finally:
        core.stop()


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(t) for t in x)
    return np.asarray(x)


def _close(got, want, tol=PAYLOAD_TOL):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _leaves(x):
    return tuple(_np(x)) if isinstance(x, (tuple, list)) else (_np(x),)


def _same_payload(got, want):
    assert [int(h) for h in got["hashes"]] == [int(h)
                                               for h in want["hashes"]]
    assert got["num_tokens"] == want["num_tokens"]
    _close(got["k"], want["k"])
    _close(got["v"], want["v"])


# -- the per-rank view of a block --------------------------------------------

def _whole(int8, n=3):
    cfg = get_model_config("tiny-llama")
    L, bs, KVH, D = cfg.num_layers, 4, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator().manual_seed(n)
    if int8:
        return cfg, (torch.randint(-127, 128, (n, L, bs, KVH, D),
                                   dtype=torch.int8, generator=g),
                     torch.rand((n, L, bs * KVH), generator=g))
    return cfg, torch.randn((n, L, bs, KVH, D), generator=g).to(
        torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tp,pp", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_block_slice_and_assemble_round_trip(int8, tp, pp):
    cfg, whole = _whole(int8)
    parts = [block_slice(whole, cfg, r, tp, s, pp)
             for s in range(pp) for r in range(tp)]
    n = sharding.kv_heads_local(cfg, tp)
    bs = 4
    for i, part in enumerate(parts):
        s, r = divmod(i, tp)
        h0 = sharding.kv_head_start(cfg, r, tp)
        lo = s * cfg.num_layers // pp
        data = part[0] if int8 else part
        # The rank's heads of its stage's layers, as its pool holds them.
        assert torch.equal(data, (whole[0] if int8 else whole)[
            :, lo:lo + cfg.num_layers // pp, :, h0:h0 + n])
        if int8:
            want = whole[1].reshape(3, cfg.num_layers, bs, -1)[
                :, lo:lo + cfg.num_layers // pp, :, h0:h0 + n]
            assert torch.equal(part[1], want.reshape(3, -1, bs * n))
    if tp > cfg.num_kv_heads:
        # Ranks r and r + 1 hold copies of one head, and they agree.
        for s in range(pp):
            for r in range(0, tp, tp // cfg.num_kv_heads):
                a, b = parts[s * tp + r], parts[s * tp + r + 1]
                for x, y in zip(a if int8 else (a,), b if int8 else (b,)):
                    assert torch.equal(x, y)
    back = assemble(parts, cfg, tp, pp)
    for x, y in zip((back if int8 else (back,)),
                    (whole if int8 else (whole,))):
        assert torch.equal(x, y)


# -- extract, inject, the host tier and the lifecycle at tp 2 ---------------

@pytest.fixture(scope="module")
def tp2(ranks, jax_ref):
    j = jax_ref["injected"]
    leader, followers = _run(ranks, 2, [
        ("serve", [PROMPT, PROMPT]),            # 0: fresh, prefix hit
        ("extract", PROMPT),                    # 1
        ("serve", FILLERS),                     # 2: PROMPT's blocks spill
        ("ranks",),                             # 3
        ("stats",),                             # 4
        ("serve", [PROMPT]),                    # 5: restored
        ("stats",),                             # 6
        ("inject", j["hashes"], j["k"], j["v"]),  # 7
        ("serve", [INJECTED]),                  # 8
        ("inject_from_core", PROMPT),           # 9
        ("sleep",),                             # 10
        ("ranks",),                             # 11
        ("wake",),                              # 12
        ("serve", [PROMPT, INJECTED]),          # 13: after the wake
        ("ranks",),                             # 14
    ], params=jax_ref["tree"], tensor_parallel_size=2, **TIER)
    assert leader["fatal"] is None
    assert followers[0]["follower_error"] is None
    return leader["results"]


def test_extract_at_tp2_equals_jax(tp2, jax_ref):
    _same_payload(tp2[1], jax_ref["payload"])
    assert tp2[0] == [jax_ref["fresh"], jax_ref["hit"]]


def test_inject_at_tp2_continues_the_jax_prefix_hit_stream(tp2, jax_ref):
    assert tp2[7] == len(jax_ref["injected"]["hashes"]) == 8
    assert tp2[8] == [jax_ref["injected_hit"]]


def test_host_tier_at_tp2_spills_in_lockstep_and_restores(tp2, jax_ref):
    stores = [r["offload_keys"] for r in tp2[3]]
    assert stores[0] == stores[1]  # the same hashes, in the same LRU order
    assert set(tp2[1]["hashes"]) <= set(stores[0])
    hits = tp2[6]["offload"]["hits"] - tp2[4]["offload"]["hits"]
    assert hits >= len(tp2[1]["hashes"])
    assert tp2[5] == [jax_ref["hit"]]
    assert tp2[4]["offload"]["stored"] == len(stores[0])


def test_inject_from_core_is_0_under_tp(tp2):
    assert tp2[9] == [0, 0]


def test_sleep_and_wake_at_tp2(tp2, jax_ref):
    assert tp2[10] is True and tp2[12] is False
    for asleep, awake in zip(tp2[11], tp2[14]):
        assert asleep["kv_pool_bytes"] == asleep["weight_bytes"] == 0
        assert asleep["sleep_freed_bytes"] == (awake["kv_pool_bytes"]
                                               + awake["weight_bytes"]) > 0
    # The sleep spilled every cached block to every rank's store first:
    # PROMPT comes back restored, INJECTED likewise.
    assert tp2[13] == [jax_ref["hit"], jax_ref["injected_hit"]]
    assert tp2[14][0]["offload_keys"] == tp2[14][1]["offload_keys"]


# -- pp 2, pp 2 x tp 2, dp 2 -------------------------------------------------

@pytest.fixture(scope="module")
def pp2(ranks, jax_ref):
    j = jax_ref["injected"]
    leader, followers = _run(ranks, 2, [
        ("serve", [PROMPT, PROMPT]),
        ("extract", PROMPT),
        ("inject", j["hashes"], j["k"], j["v"]),
        ("serve", [INJECTED]),
        ("sleep",),
        ("ranks",),
        ("wake",),
        ("serve", [PROMPT]),
    ], params=jax_ref["tree"], pipeline_parallel_size=2)
    assert leader["fatal"] is None
    assert followers[0]["follower_error"] is None
    return leader["results"]


def test_extract_and_inject_at_pp2_equal_jax(pp2, jax_ref):
    assert pp2[0] == [jax_ref["fresh"], jax_ref["hit"]]
    _same_payload(pp2[1], jax_ref["payload"])
    assert pp2[2] == 8 and pp2[3] == [jax_ref["injected_hit"]]


def test_sleep_and_wake_at_pp2(pp2, jax_ref):
    assert pp2[4] is True and pp2[6] is False
    for r in pp2[5]:
        assert r["weight_bytes"] == 0 and r["sleep_freed_bytes"] > 0
    # No tier: the prefix state went with the pool, and PROMPT is
    # computed again as at first.
    assert pp2[7] == [jax_ref["fresh"]]


@pytest.mark.parametrize("n,over", [
    (4, dict(pipeline_parallel_size=2, tensor_parallel_size=2)),
    (2, dict(data_parallel_size=2))], ids=["pp2xtp2", "dp2"])
def test_extract_across_the_job_equals_jax(ranks, jax_ref, n, over):
    leader, _ = _run(ranks, n, [("serve", [PROMPT]), ("extract", PROMPT),
                                ("ranks",)],
                     params=jax_ref["tree"], **over)
    assert leader["results"][0] == [jax_ref["fresh"]]
    _same_payload(leader["results"][1], jax_ref["payload"])
    # Replica 0 gathers; a second replica holds the same pages and sends
    # nothing.
    gathers = [r["kv_gathers_total"] for r in leader["results"][2]]
    assert gathers == ([1] * n if "pipeline_parallel_size" in over
                       else [1, 0])


# -- the L3 tier, and a diverged store ---------------------------------------

def test_l3_tier_at_tp2_with_int8_pages(ranks, jax_ref):
    srv = AioThread(lambda: CacheServer(64 << 20).make_app())
    try:
        leader, _ = _run(ranks, 2, [
            ("serve", [PROMPT, PROMPT]),
            ("serve", FILLERS),
            ("stats",),
            ("serve", [PROMPT]),
            ("stats",),
        ], params=jax_ref["tree"], tensor_parallel_size=2,
            kv_cache_dtype="int8", kv_remote_url=srv.url)
    finally:
        srv.stop()
    res = leader["results"]
    assert leader["fatal"] is None
    before, after = res[2]["offload"], res[4]["offload"]
    assert before["remote_put_blocks"] >= 7  # whole blocks, leader's store
    assert after["remote_get_blocks"] - before["remote_get_blocks"] >= 7
    assert res[3] == [res[0][1]]  # the stream the prefix hit gave


def test_a_follower_store_miss_latches_the_fault(ranks, jax_ref):
    leader, followers = _run(ranks, 2, [
        ("serve", [PROMPT]),
        ("serve", FILLERS),
        ("serve", [PROMPT]),
        ("stats",),
    ], params=jax_ref["tree"], job={"store_misses": True},
        tensor_parallel_size=2, **TIER)
    res = leader["results"]
    assert res[2] == [["error"]]
    assert "offload store diverged" in leader["fatal"]
    assert "offload store diverged" in followers[0]["follower_error"]
    assert res[3]["fatal"] == leader["fatal"]
