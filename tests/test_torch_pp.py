"""Pipeline and data parallelism in the torch port against the JAX engine.

Every rank is a process: module-scoped groups of 2 and 4 ranks join one
gloo job each (the ``Ranks`` harness of ``tests/test_torch_tp.py``) and
run the jobs this module sends them. The JAX side runs here, on the
conftest's 8-device CPU mesh.

- (a) every stage's leaf of tiny-llama at pp 2 and pp 2 x tp 2 is
  bit-equal to the JAX engine's addressable shard of it, with LoRA slots
  and with int8 weights; the seeded init and a checkpoint read of a
  stage give the stage's slice of the whole tree;
- (b) float32 logits of a prefill, a cached prefill and a decode step at
  pp 2 (pp 2 x tp 2, and pp 4 of a 4-layer tiny-llama) within 1e-4 of
  the port's pp 1 and of JAX ``make_pp_apply``, at microbatches 1 and 2,
  and each stage's pages those of pp 1 at its layers;
- (c) greedy and seeded streams at pp 2 equal to the JAX engine's at
  pp 2 in JAX's own ``test_pp_serving_parity`` scenarios: a prefix-cache
  reuse, and two concurrent sequences at microbatches 2;
- (d) pp 2 x tp 2 streams equal to the port's tp 2 and the JAX engine's
  tp 2 (the JAX engine cannot run pp x tp on this XLA build);
- (e) int8 KV with int8 weights, LoRA with embeddings, and prompt-lookup
  speculation at pp 2, each equal to the port's pp 1;
- (f) dp 2 streams equal to pp 1; in every engine job each follower's
  sampled tokens (every op's) equal the leader's;
- (g) the refusals: OPT and Mixtral under pp and ``L % pp`` raise the
  JAX engine's ``ValueError``; the offload tier, KV extract and sleep
  raise ``NotImplementedError``;
- (h) the pool is sized like the JAX engine's under pp, with and without
  a memory figure;
- the server entry serves pp 2 (its ranks started on this host) with
  the pp 1 server's text, and a lost stage latches the engine's fault.
"""

import dataclasses
import threading

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
from production_stack_tpu.models import get_model_config as jax_model_config
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.quantize import quantize_tree
from production_stack_tpu.parallel.mesh import build_mesh as jax_build_mesh
from production_stack_tpu.parallel.pp_serving import (
    make_pp_apply as jax_make_pp_apply,
)
from production_stack_tpu.parallel.sharding import param_shardings
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import (
    EngineCore,
    kv_bytes_per_block,
)
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models import build_model, get_model_config
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.models.weights import (
    load_checkpoint,
    save_checkpoint,
)
from production_stack_tpu_torch.parallel import multihost, sharding
from production_stack_tpu_torch.parallel.mesh import build_mesh
from production_stack_tpu_torch.parallel.pp_serving import _microbatch_count
from test_torch_tp import (
    BASE,
    Ranks,
    _flat,
    _np_tree,
    _requests,
    _serve,
    _three_steps,
)

torch.set_num_threads(1)

TOL = 1e-4  # float32 logits

# The ranks' side: join the job, then run each job sent on stdin.
_WORKER = r"""
import base64, pickle, sys, threading, traceback
import numpy as np
import torch
torch.set_num_threads(1)
from production_stack_tpu_torch.parallel import multihost

env = multihost.initialize_from_env()
ctx = multihost.maybe_context()
rank, size = env["process_id"], env["num_processes"]


def engine_job(job):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    core = EngineCore(EngineConfig(**job["config"]), params=job["params"],
                      multihost=ctx)
    core.sampled_log = []
    pool = core.kv[0] if not isinstance(core.kv[0], tuple) else core.kv[0][0]
    info = {"shapes": {k: tuple(v.shape)
                       for k, v in core.params["layers"].items()},
            "pool": tuple(pool.shape), "coords": core.layout.coords(rank),
            "layers": [core.layers.start, core.layers.stop],
            "num_blocks": core.num_blocks}
    if job.get("free_figure"):
        core._free_device_bytes = lambda: job["free_figure"]
        info["auto_num_blocks"] = core._auto_num_blocks()
    if rank != 0:
        core.run_follower()
        return dict(info, log=core.sampled_log)
    refusals = {}
    if job.get("refusals"):
        for name, call in (("extract", lambda: core.extract_kv([1, 2, 3])),
                           ("sleep", core.sleep)):
            try:
                call()
            except NotImplementedError as e:
                refusals[name] = str(e)
    for name, weights in job.get("loras", {}).items():
        assert core.load_lora_adapter(name, weights=weights)
    reqs = job["requests"]
    streams = [[] for _ in reqs]
    events = [threading.Event() for _ in reqs]

    def add(i):
        def cb(t, f):
            if t is not None:
                streams[i].append(int(t))
            if f is not None:
                streams[i].append(f)
                events[i].set()
        req = reqs[i]
        core.add_request("r%d" % i, req["prompt"],
                         SamplingParams(**req["sampling"]), cb,
                         adapter_name=req.get("adapter"))

    try:
        if job.get("concurrent"):
            # Every request queued before the loop starts: one schedule.
            for i in range(len(reqs)):
                add(i)
            core.start()
            for i, ev in enumerate(events):
                if not ev.wait(60):
                    raise TimeoutError("request %d" % i)
        else:
            core.start()
            for i, ev in enumerate(events):
                add(i)
                if not ev.wait(60):
                    raise TimeoutError("request %d" % i)
        embedding = (core.embed(job["embed"]) if job.get("embed")
                     else None)
        stats = core.stats()
        ranks = core.rank_stats()
    finally:
        core.stop()
    return dict(info, streams=streams, log=core.sampled_log, stats=stats,
                embedding=embedding, refusals=refusals, ranks=ranks)


def logits_job(job):
    from production_stack_tpu_torch.models import build_model
    from production_stack_tpu_torch.models import get_model_config
    from production_stack_tpu_torch.models.convert import params_from_numpy
    from production_stack_tpu_torch.parallel.mesh import build_mesh
    from production_stack_tpu_torch.parallel.pp import create_groups
    from production_stack_tpu_torch.parallel.pp_serving import make_pp_apply
    from production_stack_tpu_torch.parallel.sharding import kv_heads_local

    cfg = get_model_config(job["model"]).replace(dtype="float32",
                                                 **job["cfg"])
    pp, tp = job["pp"], job["tp"]
    layout = build_mesh(tp, 1, pp, ["cpu"] * size)
    tpg, ppg, _, _ = create_groups(layout, rank, "cpu")
    _, stage, tp_rank = layout.coords(rank)
    params = params_from_numpy(job["tree"], cfg, "cpu", tp_rank, tp, stage,
                               pp)
    apply = make_pp_apply(ppg, job["microbatches"])
    L, NB, bs = cfg.num_layers // pp, job["num_blocks"], job["block_size"]
    shape = (L, NB, bs, kv_heads_local(cfg, tp), cfg.head_dim)
    kv = (torch.zeros(shape), torch.zeros(shape))
    out = []
    with torch.inference_mode():
        for step in job["steps"]:
            args = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in step.items()}
            logits, kv = apply(params, cfg, kv_pages=kv, tp=tpg, **args)
            out.append(logits.numpy().copy())
    return {"logits": out, "pages": [side.numpy().copy() for side in kv],
            "coords": layout.coords(rank), "p2p": ppg.counters()}


RUN = {"engine": engine_job, "logits": logits_job}
for line in sys.stdin:
    job = pickle.loads(base64.b64decode(line))
    if job is None:
        break
    try:
        out = {"ok": RUN[job["kind"]](job)}
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


def _jax_init(jcfg, *, lora=False, int8=False):
    """A JAX init (float32) of ``jcfg`` as numpy: LoRA slots with
    non-zero values, or int8 weights (embeddings too)."""
    kw = dict(lora_slots=3, lora_rank=4) if lora else {}
    params = jllama.init_params(jcfg, jax.random.key(0), **kw)
    if int8:
        params = quantize_tree(params, "llama", quantize_embeddings=True)
    tree = _np_tree(params)
    if lora:
        rng = np.random.default_rng(0)
        for k in ("wq_a", "wq_b", "wv_a", "wv_b"):
            tree["lora"][k] = (0.2 * rng.normal(
                size=tree["lora"][k].shape)).astype(np.float32)
        tree["lora"]["scaling"] = np.asarray([0.0, 0.5, 2.0], np.float32)
    return tree


# -- (a) sharding parity ------------------------------------------------------

@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["lora", "int8"])
def test_stage_slices_equal_the_jax_shards(kind, pp, tp):
    jcfg = jax_model_config("tiny-llama").replace(dtype="float32")
    tcfg = get_model_config("tiny-llama").replace(dtype="float32")
    tree = _jax_init(jcfg, lora=kind == "lora", int8=kind == "int8")
    mesh = jax_build_mesh(tensor_parallel_size=tp, data_parallel_size=1,
                          pipeline_parallel_size=pp,
                          devices=jax.devices()[:pp * tp])
    placed = jax.device_put(tree, param_shardings(jcfg, mesh, tree))
    jleaves = dict(_flat(placed))
    layout = build_mesh(tp, 1, pp, ["cpu"] * (pp * tp))
    for rank in range(pp * tp):
        _, stage, tp_rank = layout.coords(rank)
        got = dict(_flat(params_from_numpy(tree, tcfg, "cpu", tp_rank, tp,
                                           stage, pp)))
        assert got.keys() == jleaves.keys()
        dev = mesh.devices[0, stage, tp_rank]
        for key, arr in jleaves.items():
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            want = np.asarray(shard.data)
            if sharding.is_stage_sharded(key):
                if want.shape[0] == tcfg.num_layers:
                    # GSPMD's fallback: a row-parallel int8 scale, whose
                    # split axis collapsed to 1, is replicated whole
                    # (every layer on every stage) under pp x tp; a
                    # stage holds its layers of it.
                    assert tp > 1 and key[-1] in ("wo_scale",
                                                  "w_down_scale"), key
                    layers = sharding.stage_layers(want.shape[0], stage, pp)
                    want = want[layers.start:layers.stop]
                assert want.shape[0] == tcfg.num_layers // pp, key
            np.testing.assert_array_equal(got[key].numpy(), want,
                                          err_msg=".".join(key))


def test_seeded_init_and_checkpoint_keep_the_stage_slice(tmp_path):
    """A stage's seeded init is its slice of the pp 1 init (every stage
    draws every leaf whole), int8 and LoRA included; a checkpoint read
    for a stage is its slice of the whole read."""
    cfg = get_model_config("tiny-llama")
    init, _ = build_model(cfg)
    kw = dict(lora_slots=2, lora_rank=4)
    for extra in ({}, dict(quantization="int8", quantize_embeddings=True)):
        full = init(cfg, torch.Generator().manual_seed(3), "cpu", **kw,
                    **extra)
        for pp, tp in ((2, 1), (2, 2)):
            for stage in range(pp):
                for rank in range(tp):
                    part = init(cfg, torch.Generator().manual_seed(3), "cpu",
                                rank=rank, tp=tp, stage=stage, pp=pp, **kw,
                                **extra)
                    want = dict(_flat(sharding.shard_params(
                        full, cfg, rank, tp, stage=stage, pp=pp)))
                    got = dict(_flat(part))
                    assert got.keys() == want.keys()
                    for key, t in got.items():
                        assert t.is_contiguous()
                        assert torch.equal(t, want[key]), (stage, key)
    full = init(cfg, torch.Generator().manual_seed(3), "cpu")
    save_checkpoint(full, cfg, str(tmp_path), shards=2)
    whole = load_checkpoint(cfg, str(tmp_path))
    for stage in range(2):
        layers = sharding.stage_layers(cfg.num_layers, stage, 2)
        got = dict(_flat(load_checkpoint(cfg, str(tmp_path),
                                         layers=layers)))
        want = dict(_flat(sharding.shard_params(whole, cfg, 0, 1,
                                                stage=stage, pp=2)))
        assert got.keys() == want.keys()
        for key, t in got.items():
            assert torch.equal(t, want[key]), key


def test_rank_layout_is_the_jax_mesh_order():
    layout = build_mesh(2, 2, 2, ["cpu"] * 8)
    jmesh = jax_build_mesh(tensor_parallel_size=2, data_parallel_size=2,
                           pipeline_parallel_size=2, devices=jax.devices())
    ids = [d.id for d in jax.devices()]
    for rank in range(8):
        dp, pp, tp = layout.coords(rank)
        assert ids.index(jmesh.devices[dp, pp, tp].id) == rank
        assert layout.rank_of(dp, pp, tp) == rank
    assert layout.tp_groups() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert layout.pp_groups() == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert layout.replicas() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [_microbatch_count(b, m) for b, m in
            ((8, 2), (6, 4), (5, 2), (1, 4), (4, 0))] == [2, 3, 1, 1, 1]


# -- (b) logits and pages ----------------------------------------------------

def _jax_pp_logits(jcfg, tree, steps, pp, microbatches, NB=16, bs=4):
    mesh = jax_build_mesh(tensor_parallel_size=1, data_parallel_size=1,
                          pipeline_parallel_size=pp,
                          devices=jax.devices()[:pp])
    apply = jax_make_pp_apply(mesh, microbatches)
    shape = (jcfg.num_layers, NB, bs, jcfg.num_kv_heads, jcfg.head_dim)
    kv = (jnp.zeros(shape), jnp.zeros(shape))
    params = jax.tree.map(jnp.asarray, tree)
    out = []
    for st in steps:
        def i32(name):
            return jnp.asarray(st[name].astype(np.int32))

        kw = {"mode": st["mode"], "adapter_ids": i32("adapter_ids")}
        if "last_token" in st:
            kw["last_token"] = i32("last_token")
        logits, kv = apply(params, jcfg, i32("token_ids"), i32("positions"),
                           kv, i32("slot_mapping"), i32("block_tables"),
                           i32("context_lens"), i32("seq_lens"), **kw)
        out.append(np.asarray(logits))
    return out


def _pp1(cfg, tree, steps, NB=16, bs=4):
    """The port's pp 1 logits and pages of ``steps``."""
    params = params_from_numpy(tree, cfg, "cpu")
    _, apply = build_model(cfg)
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads, cfg.head_dim)
    kv = (torch.zeros(shape), torch.zeros(shape))
    out = []
    with torch.inference_mode():
        for st in steps:
            args = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in st.items()}
            logits, kv = apply(params, cfg, kv_pages=kv, **args)
            out.append(logits.numpy())
    return out, [side.numpy() for side in kv]


@pytest.mark.parametrize("pp,tp,layers,microbatches", [
    (2, 1, 2, 1), (2, 1, 2, 2), (2, 2, 2, 2), (4, 1, 4, 2)])
def test_logits_and_pages_at_pp(ranks, pp, tp, layers, microbatches):
    jcfg = jax_model_config("tiny-llama").replace(dtype="float32",
                                                  num_layers=layers)
    cfg = get_model_config("tiny-llama").replace(dtype="float32",
                                                 num_layers=layers)
    tree = _jax_init(jcfg, lora=True)
    steps = _three_steps(cfg.vocab_size)
    res = ranks[pp * tp].run({
        "kind": "logits", "model": "tiny-llama",
        "cfg": {"num_layers": layers}, "tree": tree, "steps": steps,
        "num_blocks": 16, "block_size": 4, "pp": pp, "tp": tp,
        "microbatches": microbatches})
    want, pages = _pp1(cfg, tree, steps)
    jax_want = (_jax_pp_logits(jcfg, tree, steps, pp, microbatches)
                if tp == 1 else None)
    per = layers // pp
    for r in res:
        _, stage, tp_rank = r["coords"]
        for i, got in enumerate(r["logits"]):
            # Replicated: every rank holds the same logits.
            np.testing.assert_array_equal(got, res[0]["logits"][i])
            if pp * tp == 2 and microbatches == 1:
                # One microbatch at tp 1: pp 1's products, bit for bit.
                np.testing.assert_array_equal(got, want[i])
            np.testing.assert_allclose(got, want[i], rtol=TOL, atol=TOL)
            if jax_want is not None:
                np.testing.assert_allclose(got, jax_want[i], rtol=TOL,
                                           atol=TOL)
        n = sharding.kv_heads_local(cfg, tp)
        h0 = sharding.kv_head_start(cfg, tp_rank, tp)
        for side, mine in zip(pages, r["pages"]):
            np.testing.assert_allclose(
                mine, side[stage * per:(stage + 1) * per, :, :, h0:h0 + n],
                rtol=TOL, atol=TOL)
        # (pp - 1) sends of M microbatches a forward, one share each.
        M = _microbatch_count(2, microbatches)
        p2p = r["p2p"]
        assert p2p["shares_total"] == len(steps)
        assert p2p["sends_total"] == (0 if stage == pp - 1
                                      else M * len(steps))
        assert p2p["recvs_total"] == (0 if stage == 0 else M * len(steps))


# -- engine streams -----------------------------------------------------------

PP_BASE = dict(dtype="float32", max_model_len=128, max_num_seqs=2,
               block_size=8, num_blocks=64, max_loras=0, seed=0)


def _parity_requests():
    """JAX's test_pp_serving_parity prompts (rng 33, 41 tokens; rng 7, 23
    tokens) greedy for 8 tokens, and a seeded sampled request."""
    rng = np.random.default_rng(33)
    prompt = [int(t) for t in rng.integers(0, 500, size=41)]
    rng = np.random.default_rng(7)
    prompt2 = [int(t) for t in rng.integers(0, 500, size=23)]
    greedy = dict(temperature=0.0, max_tokens=8, ignore_eos=True)
    seeded = dict(temperature=0.8, top_p=0.9, seed=7, max_tokens=8,
                  ignore_eos=True)
    return prompt, prompt2, greedy, seeded


def _jax_engine(over, reqs, concurrent=False, devices=None):
    """The JAX engine's streams of ``reqs``, its tree (numpy) and the
    engine (stopped)."""
    cfg = JaxEngineConfig(**dict(PP_BASE, model="tiny-llama",
                                 data_parallel_size=1, **over))
    n = cfg.pipeline_parallel_size * cfg.tensor_parallel_size
    core = JaxEngineCore(cfg, devices=devices or jax.devices()[:n])
    tree = _np_tree(core.params)
    if not concurrent:
        core.start()
        try:
            return _serve(core, reqs, JaxSamplingParams), tree, core
        finally:
            core.stop()
    outs = [[] for _ in reqs]
    events = [threading.Event() for _ in reqs]
    for i, req in enumerate(reqs):
        def cb(t, f, i=i):
            if t is not None:
                outs[i].append(int(t))
            if f is not None:
                outs[i].append(f)
                events[i].set()
        core.add_request(f"c{i}", req["prompt"],
                         JaxSamplingParams(**req["sampling"]), cb)
    core.start()
    try:
        for ev in events:
            assert ev.wait(300)
    finally:
        core.stop()
    return outs, tree, core


def _engine(ranks, n, over, reqs, params=None, job=None, base=PP_BASE):
    """The port engine's job on ``n`` ranks; checks (f) that every
    follower's sampled tokens equal the leader's. Returns every rank's
    result, the leader's first."""
    res = ranks[n].run(dict(job or {}, kind="engine", params=params,
                            config=dict(base, model="tiny-llama",
                                        device="cpu", **over),
                            requests=reqs))
    leader = res[0]
    for follower in res[1:]:
        assert len(follower["log"]) == len(leader["log"]) > 0
        for (n0, a0), (n1, a1) in zip(leader["log"], follower["log"]):
            assert n0 == n1
            np.testing.assert_array_equal(a0, a1)
    return res


def _port_pp1(reqs, base=PP_BASE, loras=None, embed=None, **over):
    core = EngineCore(EngineConfig(**dict(base, model="tiny-llama",
                                          device="cpu", **over)))
    core.start()
    try:
        for name, weights in (loras or {}).items():
            assert core.load_lora_adapter(name, weights=weights)
        return (_serve(core, reqs, SamplingParams),
                core.embed(embed) if embed else None, core.stats())
    finally:
        core.stop()


@pytest.fixture(scope="module")
def jax_pp2():
    """The JAX engine at pp 2 in test_pp_serving_parity's scenarios: the
    prefix reuse (and a seeded request), then two concurrent sequences at
    microbatches 2; its tree, and its pool size at a memory figure."""
    prompt, prompt2, greedy, seeded = _parity_requests()
    reuse = [dict(prompt=prompt, sampling=greedy),
             dict(prompt=prompt, sampling=greedy),
             dict(prompt=prompt2, sampling=seeded)]
    want_reuse, tree, core = _jax_engine(dict(pipeline_parallel_size=2),
                                         reuse)
    assert want_reuse[0] == want_reuse[1]
    assert core.cached_tokens_total > 0
    figure = 400 << 10
    core._free_hbm_bytes = lambda: figure
    # The JAX budget: free x utilization x the pp factor over the WHOLE
    # model's bytes a block (its formula pads head_dim 32 to TPU tiles,
    # so tiny-llama's blocks are 4x the port's; the sizing rule is what
    # the port takes over).
    util, jbytes = core.config.hbm_utilization, core._kv_bytes_per_block()
    cfg = core.config
    lo, hi = cfg.max_blocks_per_seq * 2, cfg.max_blocks_per_seq * (
        cfg.max_num_seqs * 4)

    def rule(whole_bytes):
        return min(max(int(figure * util * 2 // whole_bytes), lo), hi)

    assert core._auto_num_blocks() == rule(jbytes)
    pair = reuse[:1] + [dict(prompt=prompt2, sampling=greedy)]
    want_pair, _, _ = _jax_engine(
        dict(pipeline_parallel_size=2, pp_microbatches=2), pair,
        concurrent=True)
    return {"reuse": (reuse, want_reuse), "pair": (pair, want_pair),
            "tree": tree, "figure": figure, "rule": rule}


def test_pp2_streams_equal_the_jax_engine(ranks, jax_pp2):
    """(c) the prefix reuse and a seeded request; (h) the pool sized like
    the JAX engine's at a memory figure and without one."""
    reqs, want = jax_pp2["reuse"]
    res = _engine(ranks, 2, dict(pipeline_parallel_size=2), reqs,
                  params=jax_pp2["tree"],
                  job={"free_figure": jax_pp2["figure"]})
    leader = res[0]
    assert leader["streams"] == want
    assert leader["stats"]["prefix_cache_hits"] > 0
    assert leader["stats"]["pipeline_parallel"]["size"] == 2
    assert leader["stats"]["prefill_attention_dispatch_total"]["pallas"] > 0
    cfg = get_model_config("tiny-llama")
    for stage, r in enumerate(res):
        assert r["coords"] == (0, stage, 0)
        assert r["layers"] == [stage, stage + 1]
        assert r["shapes"]["wq"][0] == 1 and r["pool"][0] == 1
        whole = kv_bytes_per_block(cfg.replace(dtype="float32"),
                                   PP_BASE["block_size"])
        assert r["auto_num_blocks"] == jax_pp2["rule"](whole)
        assert 2 * 16 < r["auto_num_blocks"] < 128  # neither clamp
    # No memory figure on the CPU: the minimal 2-sequence pool, as the
    # JAX engine sizes CPU meshes.
    jcfg = JaxEngineConfig(**dict(PP_BASE, model="tiny-llama",
                                  num_blocks=None))
    sized = _engine(ranks, 2, dict(pipeline_parallel_size=2,
                                   num_blocks=None), reqs[:1])
    assert [r["num_blocks"] for r in sized] == [jcfg.max_blocks_per_seq * 2] * 2
    # Every rank reports its layers and its transfers.
    by_rank = leader["ranks"]
    assert [r["pp"] for r in by_rank] == [0, 1]
    assert by_rank[0]["p2p"]["sends_total"] > 0
    assert by_rank[1]["p2p"]["recvs_total"] > 0
    assert by_rank[0]["weight_bytes"] == by_rank[1]["weight_bytes"]
    assert cfg.num_layers == 2


def test_pp2_concurrent_microbatched_equal_the_jax_engine(ranks, jax_pp2):
    """(c) two sequences decoding together, two microbatches a forward."""
    reqs, want = jax_pp2["pair"]
    res = _engine(ranks, 2, dict(pipeline_parallel_size=2,
                                 pp_microbatches=2), reqs,
                  params=jax_pp2["tree"], job={"concurrent": True})
    assert res[0]["streams"] == want
    assert res[0]["stats"]["pipeline_parallel"]["microbatches"] == 2


def test_pp2_tp2_streams_equal_tp2(ranks):
    """(d) pp 2 x tp 2 (four ranks) against the port's tp 2 and the JAX
    engine's tp 2, on the tp tests' requests (a prefix hit, chunk
    continuations, a seeded request)."""
    reqs = _requests()
    want, tree, _ = _jax_engine(dict(BASE, tensor_parallel_size=2), reqs)
    tp2 = _engine(ranks, 2, dict(tensor_parallel_size=2), reqs,
                  params=tree, base=BASE)
    assert tp2[0]["streams"] == want
    res = _engine(ranks, 4, dict(tensor_parallel_size=2,
                                 pipeline_parallel_size=2), reqs,
                  params=tree, base=BASE)
    assert res[0]["streams"] == want
    assert [r["coords"] for r in res] == [(0, 0, 0), (0, 0, 1), (0, 1, 0),
                                          (0, 1, 1)]
    cfg = get_model_config("tiny-llama")
    for r in res:
        assert r["shapes"]["wq"] == (1, cfg.hidden_size,
                                     cfg.num_heads // 2 * cfg.head_dim)
        assert r["pool"][0] == 1 and r["pool"][3] == 1
    assert res[0]["stats"]["mesh"] == {"dp": 1, "pp": 2, "tp": 2}


def test_int8_streams_at_pp2_equal_pp1(ranks):
    """(e) The seeded init under int8 weights and int8 KV pages: each
    stage draws and quantizes every leaf whole and keeps its layers."""
    reqs = _requests()
    over = dict(kv_cache_dtype="int8", quantization="int8")
    want, _, _ = _port_pp1(reqs, base=BASE, **over)
    res = _engine(ranks, 2, dict(pipeline_parallel_size=2, **over), reqs,
                  base=BASE)
    assert res[0]["streams"] == want
    assert res[0]["stats"]["kv_cache_dtype"] == "int8"


def test_lora_and_embeddings_at_pp2_equal_pp1(ranks):
    """(e) An adapter loaded with explicit weights (each stage keeps its
    layers) and a name-drawn one change the stream as at pp 1, and the
    pooled embedding is pp 1's."""
    cfg = get_model_config("tiny-llama")
    L, Hd, R = cfg.num_layers, cfg.hidden_size, 4
    rng = np.random.default_rng(5)
    weights = {k: (0.3 * rng.normal(size=(L,) + shape)).astype(np.float32)
               for k, shape in (("wq_a", (Hd, R)),
                                ("wq_b", (R, cfg.num_heads * cfg.head_dim)),
                                ("wv_a", (Hd, R)),
                                ("wv_b", (R, cfg.num_kv_heads
                                          * cfg.head_dim)))}
    base = _requests()[:1]
    reqs = [dict(r, adapter="ad") for r in base] + base
    over = dict(max_loras=2, max_lora_rank=R)
    prompt = list(range(3, 30))
    want, emb, _ = _port_pp1(reqs, base=BASE, loras={"ad": weights},
                             embed=prompt, **over)
    assert want[0] != want[1]  # the adapter is live
    res = _engine(ranks, 2, dict(pipeline_parallel_size=2, **over), reqs,
                  job={"loras": {"ad": weights}, "embed": prompt},
                  base=BASE)
    assert res[0]["streams"] == want
    np.testing.assert_allclose(res[0]["embedding"], emb, rtol=TOL, atol=TOL)


def test_prompt_lookup_speculation_at_pp2_equals_pp1(ranks):
    """(e) Verify bursts through the pipeline: a repetitive prompt whose
    drafts are accepted (the bias pins the phrase's tokens), and a
    request whose drafts are not."""
    phrase = [11, 12, 13, 14, 15, 16, 17, 18]
    reqs = [dict(prompt=phrase * 5, sampling=dict(
        temperature=0.0, max_tokens=24, ignore_eos=True,
        logit_bias={t: 100.0 for t in phrase})),
        dict(prompt=phrase * 3 + [40, 41, 42], sampling=dict(
            temperature=0.0, max_tokens=16, ignore_eos=True))]
    over = dict(speculative_num_tokens=4)
    want, _, stats = _port_pp1(reqs, **over)
    res = _engine(ranks, 2, dict(pipeline_parallel_size=2, **over), reqs)
    assert res[0]["streams"] == want
    assert res[0]["stats"]["spec_verify_bursts_total"] == (
        stats["spec_verify_bursts_total"]) > 0
    assert res[0]["stats"]["spec_accepted_tokens_total"] == (
        stats["spec_accepted_tokens_total"]) > 0


def test_dp2_streams_equal_pp1(ranks):
    """(f) Two replicas of the whole model replay one op stream: the
    follower replica samples the leader's tokens."""
    reqs = _requests()
    want, _, _ = _port_pp1(reqs, base=BASE)
    res = _engine(ranks, 2, dict(data_parallel_size=2), reqs, base=BASE)
    assert res[0]["streams"] == want
    assert [r["coords"] for r in res] == [(0, 0, 0), (1, 0, 0)]
    assert res[0]["stats"]["data_parallel"]["size"] == 2
    # pp 2 in each of two replicas: the 4-rank job.
    res = _engine(ranks, 4, dict(data_parallel_size=2,
                                 pipeline_parallel_size=2), reqs, base=BASE)
    assert res[0]["streams"] == want


# -- (g) refusals -----------------------------------------------------------

@pytest.mark.parametrize("model,pp", [
    ("tiny-opt", 2), ("tiny-mixtral", 2), ("tiny-llama", 4)])
def test_pp_refusals_match_the_jax_engine(model, pp):
    over = dict(model=model, pipeline_parallel_size=pp, max_loras=0)
    with pytest.raises(ValueError) as jax_err:
        JaxEngineCore(JaxEngineConfig(**over), devices=jax.devices()[:pp])
    with pytest.raises(ValueError) as err:
        EngineCore(EngineConfig(device="cpu", **over))
    assert str(err.value) == str(jax_err.value)


def test_job_sizes_and_offload_refusals():
    assert multihost.job_dp(4, 0, 2, 1) == 2  # dp fills the job
    assert multihost.job_dp(4, 1, 2, 2) == 1
    with pytest.raises(ValueError, match="covers 4 devices but the job has 6"):
        multihost.job_dp(6, 2, 2, 1)
    for over in (dict(pipeline_parallel_size=2), dict(data_parallel_size=2)):
        cfg = EngineConfig(model="tiny-llama", device="cpu", max_loras=0,
                           kv_offload_bytes=1 << 20, **over)
        with pytest.raises(NotImplementedError, match="not supported"):
            EngineCore(cfg)


def test_extract_and_sleep_are_refused_under_pp(ranks):
    reqs = _requests()[:1]
    res = _engine(ranks, 2, dict(pipeline_parallel_size=2), reqs,
                  job={"refusals": True})
    refusals = res[0]["refusals"]
    assert set(refusals) == {"extract", "sleep"}
    for msg in refusals.values():
        assert "tensor or pipeline parallelism" in msg


# -- the server entry ---------------------------------------------------------

def test_server_entry_serves_pp2():
    import json
    import urllib.error
    import urllib.request

    from production_stack_tpu_torch.engine.server import build_server

    argv = ["tiny-llama", "--device", "cpu", "--dtype", "float32",
            "--host", "127.0.0.1", "--port", "0", "--max-model-len", "256",
            "--block-size", "8", "--num-blocks", "64", "--max-loras", "2"]
    body = {"prompt": "pipeline stages", "max_tokens": 8, "temperature": 0.0}

    def post(port, path, data):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(data).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    texts = {}
    for extra in ([], ["--pipeline-parallel-size", "2"]):
        httpd, core = build_server(argv + extra)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        port = httpd.server_address[1]
        try:
            status, out = post(port, "/v1/completions", body)
            assert status == 200, out
            texts[len(extra)] = out["choices"][0]["text"]
            if extra:
                procs = httpd.ranks[1]
                assert len(procs) == 1
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health") as resp:
                    health = json.loads(resp.read())
                assert health["mesh"] == {"dp": 1, "pp": 2, "tp": 1}
                assert health["num_processes"] == 2
                status, out = post(port, "/sleep", {})
                assert status == 501, out
        finally:
            httpd.shutdown()
            httpd.server_close()
            core.stop()
            th.join(timeout=10)
        if extra:
            assert procs[0].wait(timeout=30) == 0
    assert texts[2] == texts[0]


def test_stage_config_counts_a_stages_layers():
    """The bytes a block of a stage are the model's over pp: the JAX
    budget's pp factor."""
    cfg = get_model_config("meta-llama/Llama-3-8B")
    whole = kv_bytes_per_block(cfg, 64)
    for pp in (2, 4):
        stage = cfg.replace(num_layers=len(sharding.stage_layers(
            cfg.num_layers, 0, pp)))
        assert kv_bytes_per_block(stage, 64) * pp == whole
    assert dataclasses.is_dataclass(EngineConfig)


def test_a_lost_stage_latches_the_fault():
    """Stage 1 replays three ops and dies: the leader's request ends with
    "error" well inside the limit, and a later request fails at once."""
    import json
    import os
    import subprocess
    import sys

    from test_torch_multihost import _DYING

    script = _DYING.replace("tensor_parallel_size=2",
                            "pipeline_parallel_size=2")
    assert script != _DYING
    port = multihost._free_port_pair()
    procs = []
    for rank in range(2):
        env = dict(os.environ, TPU_STACK_COORDINATOR=f"127.0.0.1:{port}",
                   TPU_STACK_NUM_PROCESSES="2",
                   TPU_STACK_PROCESS_ID=str(rank),
                   TPU_STACK_OP_TOKEN="test-op-token",
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))),
                   TPU_STACK_LOG_LEVEL="WARNING")
        env.pop("TPU_STACK_OP_PORT", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 3, outs[1][-3000:]
    line = next((ln for ln in outs[0].splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, outs[0][-3000:]
    res = json.loads(line[7:])
    assert res["finished"] and res["finish"] == "error", res
    assert res["tokens"] < 200 and res["seconds"] < 60
    assert res["fatal"], res
    assert res["late"] == ["error"]
