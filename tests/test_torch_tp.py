"""Tensor parallelism in the torch port against the JAX engine.

Every rank of a sharded engine is a process: each module-scoped group of
ranks (2 and 4) is spawned once as subprocesses that join one gloo job
(``parallel/multihost.py``, as ``tests/test_multihost.py`` starts the
JAX engine's processes) and run the jobs this module sends them, one at
a time, on every rank. The JAX side runs here, on the conftest's CPU
mesh.

- (a) every leaf's rank slice (``params_from_numpy(tree, cfg, device,
  rank, tp)``) is bit-equal to the JAX engine's addressable shard of it
  under ``param_shardings``, for tiny-llama (with LoRA slots, and with
  int8 weights and scales), tiny-opt and tiny-mixtral at tp 2 and 4.
  One deliberate difference: where ``tp > num_kv_heads`` the JAX rules
  split a KV projection inside a head (GSPMD repairs it), while a port
  rank holds the whole KV head its q heads read; those leaves are held
  to that head of the JAX leaf. The seeded init and a checkpoint read per
  rank give the slices of their whole trees;
- (b) float32 logits of a prefill, a cached prefill and a decode step at
  tp 2 within 1e-4 of the port's tp 1 and of the JAX model, and each
  rank's pages equal to the tp 1 pages at its KV heads (int8 pages and
  scales too, head by head);
- (c) greedy and seeded streams at tp 2 and 4 equal to the JAX engine's
  at tp 1 and tp 2 (JAX's own ``test_tp_parity`` scenario, with a
  prefix hit and a chunk continuation);
- (d) int8 KV pages and int8 weights: tp 2 streams equal to the port's
  tp 1 int8 streams;
- (e) Mixtral and OPT at tp 2 equal to the JAX engine's streams;
- (g) in every engine job, each follower's sampled tokens (every op's)
  equal the leader's.
"""

import base64
import os
import pickle
import queue
import subprocess
import sys
import threading
import time

import jax
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
from production_stack_tpu.models import mixtral as jmixtral
from production_stack_tpu.models import opt as jopt
from production_stack_tpu.models.quantize import quantize_tree
from production_stack_tpu.parallel.mesh import build_mesh as jax_build_mesh
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
from production_stack_tpu_torch.parallel import sharding

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4  # float32 logits: the ranks add their partial sums in another order
JOB_TIMEOUT = 120.0

# A worker's tap of its engine for a warm-up job (the ranks' scripts
# import torch before they call it).
TAP_WARMUP = r"""def tap_warmup(core):
    # The names of every op this rank runs, and whether its pool is bit
    # for bit what it was when the warm-up's closing op has run.
    def leaves():
        return [t.clone() for side in core.kv
                for t in (side if isinstance(side, tuple) else (side,))]

    before, run = leaves(), core._exec_op
    warm = {"ops": [], "pool_kept": None}

    def tap(name, static, arrays):
        out = run(name, static, arrays)
        warm["ops"].append(name)
        if name == "warmup" and static["end"]:
            warm["pool_kept"] = all(
                torch.equal(a, b) for a, b in zip(before, leaves()))
        return out

    core._exec_op = tap
    return warm
"""

# The ranks' side: join the job, then run each job sent on stdin (one
# base64 pickle a line) and answer one "RESULT <base64 pickle>" line.
_WORKER = TAP_WARMUP + r"""
import base64, pickle, sys, threading, traceback
import numpy as np
import torch
torch.set_num_threads(1)
from production_stack_tpu_torch.parallel import multihost
from production_stack_tpu_torch.parallel.tp import TPGroup

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
    shapes = {k: tuple(v.shape) for k, v in core.params["layers"].items()}
    pool = tuple(core.kv[0].shape if not isinstance(core.kv[0], tuple)
                 else core.kv[0][0].shape)
    warm = tap_warmup(core) if job.get("warmup") else None
    if rank != 0:
        core.run_follower()
        return {"log": core.sampled_log, "shapes": shapes, "pool": pool,
                "warm": warm}
    core.start()
    if warm is not None:
        core.warmup()
        warm["variants"] = dict(core.warmup_variants)
    streams = []
    try:
        for name, weights in job.get("loras", {}).items():
            assert core.load_lora_adapter(name, weights=weights)
        for req in job["requests"]:
            done = threading.Event()
            toks = []

            def cb(t, f, toks=toks, done=done):
                if t is not None:
                    toks.append(int(t))
                if f is not None:
                    toks.append(f)
                    done.set()

            core.add_request("r%d" % len(streams), req["prompt"],
                             SamplingParams(**req["sampling"]), cb,
                             adapter_name=req.get("adapter"))
            if not done.wait(60):
                raise TimeoutError("request %d" % len(streams))
            streams.append(toks)
        embedding = (core.embed(job["embed"]) if job.get("embed")
                     else None)
        stats = core.stats()
        ranks = core.rank_stats() if warm is not None else None
    finally:
        core.stop()
    return {"streams": streams, "log": core.sampled_log, "shapes": shapes,
            "pool": pool, "stats": stats, "embedding": embedding,
            "warm": warm, "ranks": ranks}



def logits_job(job):
    from production_stack_tpu_torch.models import build_model
    from production_stack_tpu_torch.models import get_model_config
    from production_stack_tpu_torch.models.convert import params_from_numpy
    from production_stack_tpu_torch.parallel.sharding import (
        kv_head_start, kv_heads_local)

    cfg = get_model_config(job["model"]).replace(dtype="float32")
    params = params_from_numpy(job["tree"], cfg, "cpu", rank, size)
    _, apply = build_model(cfg)
    tp = TPGroup.create(rank, size, torch.device("cpu"))
    L, NB, bs = cfg.num_layers, job["num_blocks"], job["block_size"]
    shape = (L, NB, bs, kv_heads_local(cfg, size), cfg.head_dim)
    if job["int8"]:
        kv = tuple((torch.zeros(shape, dtype=torch.int8),
                    torch.ones(shape[:2] + (bs * shape[3],)))
                   for _ in range(2))
    else:
        kv = (torch.zeros(shape), torch.zeros(shape))
    out = []
    h0 = kv_head_start(cfg, rank, size)
    n = kv_heads_local(cfg, size)

    def my_heads(data, scales):
        # This rank's heads of whole int8 pages (scales slot-major).
        s = scales.reshape(scales.shape[:2] + (bs, -1))[..., h0:h0 + n]
        return (torch.from_numpy(data[:, :, :, h0:h0 + n].copy()),
                torch.from_numpy(s.reshape(s.shape[:2] + (-1,)).copy()))

    with torch.inference_mode():
        for i, step in enumerate(job["steps"]):
            if job.get("pages_in"):
                # Each step on the given pages (the tp 1 pool before it).
                kv = tuple(my_heads(*side) for side in job["pages_in"][i])
            args = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in step.items()}
            logits, kv = apply(params, cfg, kv_pages=kv, tp=tp, **args)
            out.append(logits.numpy().copy())
    pages = [tuple(x.numpy().copy() for x in side) if isinstance(side, tuple)
             else side.numpy().copy() for side in kv]
    return {"logits": out, "pages": pages}


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


def _free_port_pair() -> int:
    from production_stack_tpu_torch.parallel.multihost import _free_port_pair

    return _free_port_pair()


class Ranks:
    """``n`` rank processes of one gloo job, fed jobs on stdin; each runs
    ``worker`` (a script that answers ``RESULT`` lines, by default this
    module's)."""

    def __init__(self, n: int, worker: str = _WORKER):
        self.n = n
        port = _free_port_pair()
        self.procs, self.lines = [], []
        for rank in range(n):
            env = dict(os.environ,
                       TPU_STACK_COORDINATOR=f"127.0.0.1:{port}",
                       TPU_STACK_NUM_PROCESSES=str(n),
                       TPU_STACK_PROCESS_ID=str(rank),
                       TPU_STACK_OP_TOKEN="test-op-token",
                       TPU_STACK_LOG_LEVEL="WARNING",
                       PYTHONPATH=REPO)
            env.pop("TPU_STACK_OP_PORT", None)
            proc = subprocess.Popen(
                [sys.executable, "-c", worker], env=env, cwd=REPO,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            lines: "queue.Queue" = queue.Queue()
            threading.Thread(target=self._read, args=(proc, lines),
                             daemon=True).start()
            self.procs.append(proc)
            self.lines.append(lines)

    @staticmethod
    def _read(proc, lines):
        for line in proc.stdout:
            if line.startswith("RESULT "):
                lines.put(pickle.loads(base64.b64decode(line[7:])))
        lines.put(None)  # the process ended

    def run(self, job: dict, timeout: float = JOB_TIMEOUT) -> list:
        """Every rank's result of ``job``; raises with the ranks' error
        output when one fails, dies or times out."""
        data = base64.b64encode(pickle.dumps(job)).decode() + "\n"
        for proc in self.procs:
            proc.stdin.write(data)
            proc.stdin.flush()
        out, deadline = [], time.monotonic() + timeout
        for rank, lines in enumerate(self.lines):
            try:
                res = lines.get(timeout=max(deadline - time.monotonic(), 1))
            except queue.Empty:
                res = None
            if res is None or "error" in res:
                self.close()
                errs = "\n".join(p.stderr.read()[-3000:] for p in self.procs)
                raise AssertionError(
                    f"rank {rank}: {res and res.get('error')}\n{errs}")
            out.append(res["ok"])
        return out

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    proc.stdin.write(base64.b64encode(
                        pickle.dumps(None)).decode() + "\n")
                    proc.stdin.flush()
                except OSError:
                    pass
        for proc in self.procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def ranks():
    groups = {2: Ranks(2), 4: Ranks(4)}
    yield groups
    for g in groups.values():
        g.close()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_tree(name, *, lora=False, int8=False):
    """A JAX init (float32) as numpy: LoRA slots with non-zero values,
    or int8 weights (embeddings too) from quantize_tree."""
    cfg = jax_model_config(name).replace(dtype="float32")
    mod = {"llama": jllama, "opt": jopt, "mixtral": jmixtral}[cfg.arch]
    kw = dict(lora_slots=3, lora_rank=4) if lora else {}
    params = mod.init_params(cfg, jax.random.key(0), **kw)
    if int8:
        params = quantize_tree(params, cfg.arch, quantize_embeddings=True)
    tree = _np_tree(params)
    if lora:
        rng = np.random.default_rng(0)
        for k in ("wq_a", "wq_b", "wv_a", "wv_b"):
            shape = tree["lora"][k].shape
            tree["lora"][k] = (0.2 * rng.normal(size=shape)).astype(
                np.float32)
        tree["lora"]["scaling"] = np.asarray([0.0, 0.5, 2.0], np.float32)
    return cfg, tree


# -- (a) sharding parity ------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,kind", [
    ("tiny-llama", "lora"), ("tiny-llama", "int8"), ("tiny-opt", ""),
    ("tiny-mixtral", "")])
def test_rank_slices_equal_the_jax_shards(name, kind, tp):
    jcfg, tree = _jax_tree(name, lora=kind == "lora", int8=kind == "int8")
    tcfg = get_model_config(name).replace(dtype="float32")
    mesh = jax_build_mesh(tensor_parallel_size=tp, data_parallel_size=1,
                          devices=jax.devices()[:tp])
    placed = jax.device_put(tree, param_shardings(jcfg, mesh, tree))
    jleaves = dict(_flat(placed))
    kvh = tcfg.num_kv_heads
    for rank in range(tp):
        got = dict(_flat(params_from_numpy(tree, tcfg, "cpu", rank, tp)))
        assert got.keys() == jleaves.keys()
        dev = mesh.devices.reshape(-1)[rank]
        for key, arr in jleaves.items():
            mine = got[key]
            rule = sharding.split_rule(tcfg.arch, key)
            if rule == sharding.KV and tp > kvh and mine.shape[-1] > 1:
                # The whole KV head this rank reads, cut from the JAX
                # leaf (which GSPMD splits inside the head here).
                full = np.asarray(arr)
                per = full.shape[-1] // kvh
                head = sharding.kv_head_start(tcfg, rank, tp)
                want = full[..., head * per:(head + 1) * per]
            else:
                shard = next(s for s in arr.addressable_shards
                             if s.device == dev)
                want = np.asarray(shard.data)
            assert mine.dtype == torch.from_numpy(
                np.zeros(0, want.dtype)).dtype, key
            np.testing.assert_array_equal(mine.numpy(), want,
                                          err_msg=".".join(key))


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-opt", "tiny-mixtral"])
def test_seeded_init_and_checkpoint_keep_the_rank_slice(name, tmp_path):
    """The rank's seeded init is its slice of the tp 1 init (every rank
    draws the whole leaves), int8 included; a checkpoint read per rank is
    its slice of the whole read."""
    cfg = get_model_config(name)
    init, _ = build_model(cfg)
    kw = dict(lora_slots=2, lora_rank=4) if cfg.arch == "llama" else {}
    variants = [{}] + ([dict(quantization="int8", quantize_embeddings=True)]
                       if cfg.arch == "llama" else [])
    for extra in variants:
        full = init(cfg, torch.Generator().manual_seed(3), "cpu", **kw,
                    **extra)
        for tp in (2, 4):
            for rank in range(tp):
                part = init(cfg, torch.Generator().manual_seed(3), "cpu",
                            rank=rank, tp=tp, **kw, **extra)
                want = dict(_flat(sharding.shard_params(full, cfg, rank, tp)))
                got = dict(_flat(part))
                assert got.keys() == want.keys()
                for key, t in got.items():
                    assert torch.equal(t, want[key]), (tp, rank, key)
    full = init(cfg, torch.Generator().manual_seed(3), "cpu")
    save_checkpoint(full, cfg, str(tmp_path), shards=2)
    whole = load_checkpoint(cfg, str(tmp_path))
    for rank in range(2):
        got = dict(_flat(load_checkpoint(cfg, str(tmp_path), rank, 2)))
        want = dict(_flat(sharding.shard_params(whole, cfg, rank, 2)))
        assert got.keys() == want.keys()
        for key, t in got.items():
            assert t.is_contiguous() and torch.equal(t, want[key]), key


def test_indivisible_dimensions_raise_naming_them():
    cfg = get_model_config("tiny-llama")  # 4 heads, 2 KV heads, I 256
    with pytest.raises(ValueError, match="num_heads"):
        EngineCore(EngineConfig(model="tiny-llama", device="cpu",
                                tensor_parallel_size=3, max_loras=0))
    with pytest.raises(ValueError, match="intermediate_size"):
        sharding.check_tp(cfg.replace(num_heads=8, intermediate_size=250), 4)
    with pytest.raises(ValueError, match="num_experts"):
        sharding.check_tp(get_model_config("tiny-mixtral").replace(
            num_experts=6), 4)
    with pytest.raises(ValueError, match="num_kv_heads"):
        sharding.check_tp(cfg.replace(num_heads=12, num_kv_heads=3), 4)
    with pytest.raises(ValueError, match="vocab_size"):
        sharding.check_tp(cfg.replace(vocab_size=510), 4)
    sharding.check_tp(cfg, 4)  # tp > KV heads: each rank reads one


# -- (b) logits and pages ----------------------------------------------------

def _slots(tables, positions, take, bs):
    slots = np.full(positions.shape, -1, np.int64)
    for b, n in enumerate(take):
        pos = positions[b, :n]
        slots[b, :n] = tables[b, pos // bs] * bs + pos % bs
    return slots


def _three_steps(vocab, bs=4):
    """A prefill, a cached prefill over it and a decode step (2 rows)."""
    rng = np.random.default_rng(1)
    tables = np.stack([np.arange(8), np.arange(8, 16)]).astype(np.int32)
    T, take = 16, np.asarray([16, 11], np.int64)
    pos = np.tile(np.arange(T, dtype=np.int64), (2, 1))
    adapters = np.asarray([1, 2], np.int64)
    steps = [dict(token_ids=rng.integers(0, vocab, (2, T)), positions=pos,
                  slot_mapping=_slots(tables, pos, take, bs),
                  block_tables=tables, context_lens=take, seq_lens=take,
                  mode="prefill", adapter_ids=adapters)]
    T2, take2 = 8, np.asarray([8, 5], np.int64)
    pos2 = take[:, None] + np.arange(T2)[None, :]
    steps.append(dict(token_ids=rng.integers(0, vocab, (2, T2)),
                      positions=pos2,
                      slot_mapping=_slots(tables, pos2, take2, bs),
                      block_tables=tables, context_lens=take + take2,
                      seq_lens=take2, mode="prefill_cached",
                      adapter_ids=adapters, last_token=take2 - 1))
    pos3 = (take + take2)[:, None]
    steps.append(dict(token_ids=rng.integers(0, vocab, (2, 1)),
                      positions=pos3,
                      slot_mapping=_slots(tables, pos3, [1, 1], bs),
                      block_tables=tables, context_lens=pos3[:, 0] + 1,
                      seq_lens=np.ones((2,), np.int64), mode="decode",
                      adapter_ids=adapters))
    return steps


def _jax_logits(jcfg, tree, steps, NB=16, bs=4):
    import jax.numpy as jnp

    mod = {"llama": jllama, "opt": jopt, "mixtral": jmixtral}[jcfg.arch]
    shape = (jcfg.num_layers, NB, bs, jcfg.num_kv_heads, jcfg.head_dim)
    kv = (jnp.zeros(shape), jnp.zeros(shape))
    params = jax.tree.map(jnp.asarray, tree)
    out = []
    for st in steps:
        kw = {k: (jnp.asarray(v.astype(np.int32))
                  if isinstance(v, np.ndarray) else v) for k, v in st.items()
              if k not in ("token_ids", "slot_mapping", "adapter_ids")}
        if jcfg.arch == "llama":
            kw["adapter_ids"] = jnp.asarray(st["adapter_ids"], np.int32)
        logits, kv = mod.apply(
            params, jcfg, jnp.asarray(st["token_ids"].astype(np.int32)),
            kw.pop("positions"), kv,
            jnp.asarray(st["slot_mapping"].astype(np.int32)),
            kw.pop("block_tables"), kw.pop("context_lens"),
            kw.pop("seq_lens"), **kw)
        out.append(np.asarray(logits))
    return out


def _tp1(name, tree, steps, int8, NB=16, bs=4, before=None):
    """The port's tp 1 logits and pages of ``steps``; ``before``, a list,
    takes a copy of the pool before each step."""
    cfg = get_model_config(name).replace(dtype="float32")
    params = params_from_numpy(tree, cfg, "cpu")
    _, apply = build_model(cfg)
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads, cfg.head_dim)
    if int8:
        kv = tuple((torch.zeros(shape, dtype=torch.int8),
                    torch.ones(shape[:2] + (bs * shape[3],)))
                   for _ in range(2))
    else:
        kv = (torch.zeros(shape), torch.zeros(shape))
    out = []
    with torch.inference_mode():
        for st in steps:
            if before is not None:
                before.append([tuple(x.numpy().copy() for x in side)
                               for side in kv])
            args = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                        else v) for k, v in st.items()}
            logits, kv = apply(params, cfg, kv_pages=kv, **args)
            out.append(logits.numpy())
    return out, kv


@pytest.mark.parametrize("name,int8", [
    ("tiny-llama", False), ("tiny-llama", True), ("tiny-opt", False),
    ("tiny-mixtral", False)])
def test_logits_and_pages_at_tp2(ranks, name, int8):
    jcfg, tree = _jax_tree(name, lora=name == "tiny-llama")
    steps = _three_steps(jcfg.vocab_size)
    # Under int8 the ranks' float32 sums (another order than tp 1's) can
    # put a K/V value on the other side of a rounding boundary, and a
    # flipped code moves the next step's logits past TOL: each step runs
    # on the tp 1 pool as it stood before that step (as
    # tests/test_torch_kv_quant.py holds the port to JAX's pages).
    before = [] if int8 else None
    want, kv1 = _tp1(name, tree, steps, int8, before=before)
    res = ranks[2].run({"kind": "logits", "model": name, "tree": tree,
                        "steps": steps, "num_blocks": 16, "block_size": 4,
                        "int8": int8, "pages_in": before})
    jax_want = None if int8 else _jax_logits(jcfg, tree, steps)
    cfg = get_model_config(name)
    for rank, r in enumerate(res):
        for i, got in enumerate(r["logits"]):
            # Replicated: every rank holds the same gathered logits.
            np.testing.assert_array_equal(got, res[0]["logits"][i])
            np.testing.assert_allclose(got, want[i], rtol=TOL, atol=TOL)
            if jax_want is not None:
                np.testing.assert_allclose(got, jax_want[i], rtol=TOL,
                                           atol=TOL)
        h0 = sharding.kv_head_start(cfg, rank, 2)
        n = sharding.kv_heads_local(cfg, 2)
        for side, mine in zip(kv1, r["pages"]):
            if int8:
                data, scales = side[0].numpy(), side[1].numpy()
                L, NB, bs, KVH, D = data.shape
                # The K/V of a layer after the first carry the ranks'
                # float32 sums (another order than tp 1's): the scales at
                # the logits' tolerance, and a code may flip by one where
                # a value sits on a rounding boundary (as in
                # tests/test_torch_kv_quant.py).
                diff = (mine[0].astype(np.int32)
                        - data[:, :, :, h0:h0 + n].astype(np.int32))
                assert np.abs(diff).max() <= 1
                assert (diff != 0).sum() <= 2, (diff != 0).sum()
                # Scales [L, NB, bs*KVH], token-major: head by head.
                np.testing.assert_allclose(
                    mine[1].reshape(L, NB, bs, n),
                    scales.reshape(L, NB, bs, KVH)[..., h0:h0 + n],
                    rtol=TOL, atol=0)
            else:
                np.testing.assert_allclose(
                    mine, side.numpy()[:, :, :, h0:h0 + n], rtol=TOL,
                    atol=TOL)


# -- (c, d, e, g) engine streams ---------------------------------------------

BASE = dict(dtype="float32", max_model_len=128, max_num_seqs=2, block_size=8,
            num_blocks=64, max_loras=0, seed=0, prefill_chunk_size=16,
            min_prefill_bucket=16)


def _requests():
    """JAX's test_tp_parity prompt (37 tokens, rng 21) greedy, then the
    same prompt extended (a prefix hit), and a seeded sampled request;
    the 16-token chunks make every prompt a chunk continuation."""
    rng = np.random.default_rng(21)
    prompt = [int(t) for t in rng.integers(0, 500, size=37)]
    greedy = dict(temperature=0.0, max_tokens=8, ignore_eos=True)
    seeded = dict(temperature=0.8, top_p=0.9, seed=7, max_tokens=8,
                  ignore_eos=True)
    return [{"prompt": prompt, "sampling": greedy},
            {"prompt": prompt + [7, 8, 9, 10, 11, 12, 13, 14, 15],
             "sampling": greedy},
            {"prompt": list(range(40, 61)), "sampling": seeded}]


def _serve(core, reqs, sampling_cls):
    out = []
    for i, req in enumerate(reqs):
        q: "queue.Queue" = queue.Queue()
        core.add_request(f"q{i}", req["prompt"],
                         sampling_cls(**req["sampling"]),
                         lambda t, f: q.put((t, f)),
                         adapter_name=req.get("adapter"))
        toks = []
        while True:
            t, f = q.get(timeout=60)
            if t is not None:
                toks.append(int(t if isinstance(t, int) else t[0]))
            if f is not None:
                toks.append(f)
                break
        out.append(toks)
    return out


def _jax_streams(model, tp, reqs, **over):
    kw = dict(BASE, model=model, tensor_parallel_size=tp,
              data_parallel_size=1, **over)
    core = JaxEngineCore(JaxEngineConfig(**kw), devices=jax.devices()[:tp])
    core.start()
    try:
        return ((_serve(core, reqs, JaxSamplingParams), core.stats()),
                _np_tree(core.params) if tp == 1 else None)
    finally:
        core.stop()


def _tp_engine(ranks, tp, model, reqs, params=None, job=None, **over):
    res = ranks[tp].run(dict(job or {}, kind="engine", params=params,
                             config=dict(BASE, model=model, device="cpu",
                                         tensor_parallel_size=tp, **over),
                             requests=reqs))
    leader = res[0]
    for follower in res[1:]:
        # (g) every op's sampled tokens, rank by rank.
        assert len(follower["log"]) == len(leader["log"]) > 0
        for (n0, a0), (n1, a1) in zip(leader["log"], follower["log"]):
            assert n0 == n1
            np.testing.assert_array_equal(a0, a1)
    assert leader["stats"]["tensor_parallel"]["size"] == tp
    return leader


@pytest.fixture(scope="module")
def jax_llama():
    reqs = _requests()
    (want, stats), tree = _jax_streams("tiny-llama", 1, reqs)
    (want2, stats2), _ = _jax_streams("tiny-llama", 2, reqs)
    assert want2 == want  # the JAX engine's own tp parity
    # Its KV bytes a token do not change with tp either.
    assert (stats2["kv_cache_bytes_per_token"]
            == stats["kv_cache_bytes_per_token"])
    return reqs, want, tree


@pytest.mark.parametrize("tp", [2, 4])
def test_llama_streams_equal_the_jax_engine(ranks, jax_llama, tp):
    reqs, want, tree = jax_llama
    leader = _tp_engine(ranks, tp, "tiny-llama", reqs, params=tree)
    assert leader["streams"] == want
    assert leader["stats"]["prefix_cache_hits"] > 0
    # The model's KV bytes a token, as the JAX engine reports it at any
    # tp (a rank's pool holds its heads' share of them).
    assert leader["stats"]["kv_cache_bytes_per_token"] == (
        kv_bytes_per_block(get_model_config("tiny-llama").replace(
            dtype="float32"), BASE["block_size"]) // BASE["block_size"])
    assert leader["stats"]["prefill_attention_dispatch_total"]["pallas"] > 0
    cfg = get_model_config("tiny-llama")
    heads = cfg.num_heads // tp
    assert leader["shapes"]["wq"][-1] == heads * cfg.head_dim
    assert leader["pool"][3] == sharding.kv_heads_local(cfg, tp)


def check_replayed_warmup(res, variants):
    """Every rank ran the leader's warm-up: ``variants`` programs (its
    prefill, decode and verify counts) between the two ``warmup`` ops
    that open and close it, then the same serving ops, in the leader's
    order; its pool is unchanged by them, its sampled-token log holds
    none of them, and each follower's log is the leader's."""
    warm = [r["warm"] for r in res]
    assert warm[0]["variants"] == variants
    n = variants["prefill"] + variants["decode"] + variants["spec"]
    ops = warm[0]["ops"]
    assert ops[0] == ops[n + 1] == "warmup" and "warmup" not in ops[1:n + 1]
    sampled = sum(op in ("prefill", "decode", "spec_verify")
                  for op in ops[n + 2:])
    assert sampled > 0  # the requests' ops follow
    for w, r in zip(warm, res):
        assert w["ops"] == ops
        assert w["pool_kept"] is True
        assert len(r["log"]) == sampled
        for (n0, a0), (n1, a1) in zip(res[0]["log"], r["log"]):
            assert n0 == n1
            np.testing.assert_array_equal(a0, a1)


def test_warmup_at_tp2_is_replayed_and_keeps_the_streams(ranks, jax_llama):
    """The leader's warm-up on a running tp 2 engine: the follower replays
    it from the op channel and runs none of its own; every rank's pool is
    unchanged; the streams after it are the JAX engine's."""
    reqs, want, tree = jax_llama
    res = ranks[2].run(dict(kind="engine", params=tree, warmup=True,
                            config=dict(BASE, model="tiny-llama",
                                        device="cpu",
                                        tensor_parallel_size=2),
                            requests=reqs))
    # Chunks of 16: one bucket; tables 4 to 16 blocks wide.
    check_replayed_warmup(res, {"prefill": 7, "decode": 3, "spec": 0,
                                "draft": 0})
    assert res[0]["streams"] == want
    # rank_stats' count of the ops each rank ran, the warm-up's included.
    assert res[0]["ranks"][0]["ops_total"] == res[0]["ranks"][1]["ops_total"]
    assert res[0]["ranks"][0]["ops_total"] >= len(res[0]["warm"]["ops"])


def _port_tp1(model, reqs, loras=None, embed=None, **over):
    core = EngineCore(EngineConfig(**dict(BASE, model=model, device="cpu",
                                          **over)))
    core.start()
    try:
        for name, weights in (loras or {}).items():
            assert core.load_lora_adapter(name, weights=weights)
        return (_serve(core, reqs, SamplingParams),
                core.embed(embed) if embed else None)
    finally:
        core.stop()


def test_int8_streams_at_tp2_equal_tp1(ranks):
    """(d) The seeded init under int8 weights, int8 KV pages: the tp 2
    ranks each draw and quantize every leaf whole and keep their slice,
    so their streams are the tp 1 engine's."""
    reqs = _requests()
    over = dict(kv_cache_dtype="int8", quantization="int8")
    want, _ = _port_tp1("tiny-llama", reqs, **over)
    leader = _tp_engine(ranks, 2, "tiny-llama", reqs, **over)
    assert leader["streams"] == want
    assert leader["stats"]["kv_cache_dtype"] == "int8"


def test_lora_and_embeddings_at_tp2_equal_tp1(ranks):
    """An adapter loaded with explicit weights (each rank keeps its slice
    of the B matrices) changes the stream as at tp 1, and the pooled
    embedding of the sharded model is the tp 1 one."""
    cfg = get_model_config("tiny-llama")
    L, Hd, R = cfg.num_layers, cfg.hidden_size, 4
    rng = np.random.default_rng(5)
    weights = {k: (0.3 * rng.normal(size=(L,) + shape)).astype(np.float32)
               for k, shape in (("wq_a", (Hd, R)),
                                ("wq_b", (R, cfg.num_heads * cfg.head_dim)),
                                ("wv_a", (Hd, R)),
                                ("wv_b", (R, cfg.num_kv_heads
                                          * cfg.head_dim)))}
    reqs = [dict(r, adapter="ad") for r in _requests()[:1]] + _requests()[:1]
    over = dict(max_loras=2, max_lora_rank=R)
    prompt = list(range(3, 30))
    want, emb = _port_tp1("tiny-llama", reqs, loras={"ad": weights},
                          embed=prompt, **over)
    assert want[0] != want[1]  # the adapter is live
    leader = _tp_engine(ranks, 2, "tiny-llama", reqs,
                        job={"loras": {"ad": weights}, "embed": prompt},
                        **over)
    assert leader["streams"] == want
    np.testing.assert_allclose(leader["embedding"], emb, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", ["tiny-opt", "tiny-mixtral"])
def test_opt_and_mixtral_streams_equal_the_jax_engine(ranks, model):
    reqs = _requests()
    (want, _), tree = _jax_streams(model, 1, reqs)
    leader = _tp_engine(ranks, 2, model, reqs, params=tree)
    assert leader["streams"] == want
