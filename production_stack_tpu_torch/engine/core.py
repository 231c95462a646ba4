"""Engine core: model execution + continuous batching on one device.

The main-path subset of ``production_stack_tpu/engine/core.py``: owns the
parameters, the paged KV pool, the copied scheduler, sampling, and the
engine thread that drives them. The OpenAI server
(:mod:`production_stack_tpu_torch.engine.server`) talks to this class
only, through ``add_request``/``abort_request``/``stats`` and the token
callback ``on_token(token | (token, logprobs) | None, finish | None)``.

The engine's step is the JAX engine's default step:

- a prefill: one prompt's uncached suffix in chunks of at most
  ``prefill_chunk_size`` tokens (the first through causal prefill
  attention, later ones and prefix-cache hits through the cached-prefill
  kernel); during an arrival storm of long prompts, up to
  ``prefill_batch`` of them in one ``[prefill_batch, chunk]`` cached
  prefill per chunk (storm-scoped batching);
- with chunked prefill on, a budgeted step plan of chunks
  (``prefill_step``), several rows sharing one batched dispatch;
- a decode burst: ``decode_steps`` forwards of the whole batch (fewer
  under ``decode_steps_pressure`` while a prompt waits), each attending
  through the paged decode kernel, the sampled tokens fed back on the
  device.

Dispatch and readback are pipelined: burst N+1 is launched from burst
N's tokens on the device before burst N is read back, and a prefill's
first token is read back after the next step's launches; the host copies
go out right behind their launches, so a readback waits for its own
dispatch only. Every sampled token is drawn under the JAX engine's
threefry key (``engine/prng.py``), so a seeded request samples the JAX
engine's tokens. The step recorder (``obs/steps.py``) keeps one record
per step for ``/debug/steps`` and the ``tpu:step_*`` series.

The KV pool is bf16 (the model dtype) or, with ``kv_cache_dtype="int8"``,
int8 ``(data, scales)`` pairs that the page ops quantize on the scatter
and both kernels dequantize on the card; ``quantization="int8"`` stores
the weights as int8 with per-output-channel scales.

Speculative decoding (``speculative_num_tokens > 0``) is the JAX
engine's: drafts from prompt lookup (``SpecState``) or from a draft model
(``engine/draft.py``), one verify forward of ``[last token, drafts]``
through the cached-prefill kernel that samples each position under plain
decode's shaping and key, acceptance of the longest matching prefix, and
rollback of the rejected positions' pages; the pipeline collapses while
it is on, since drafts need the true last token.

Structured output (``guided_json``, ``guided_regex``,
``response_format``) is the JAX engine's: each request's spec compiles
to a token FSM (``structured/``, cached by ``StructuredCache``), and its
current automaton state's packed mask row joins the logit shaping at
every sampling site: a prefill's first token, every step of a decode
burst (one row a sequence, constant across the burst, so a structured
row uses one step of it and collapses the pipeline), every position of
the verify (walked through the draft) and the drafter's drafts (walked
with a local cursor, one forward a draft step, under
``speculative_draft_constrain``). The automaton advances at emission,
where a token outside the grammar, or a finish mid-structure, counts a
violation.

KV movement is the JAX engine's: with ``kv_offload_bytes`` or
``kv_remote_url`` an evicted cached page spills to a host-RAM store with
an optional remote (L3) tier (``kv/offload.py``) and a later prompt over
that prefix restores it instead of recomputing; ``extract_kv``,
``inject_kv`` and ``inject_from_core`` move a prompt's cached prefix
pages out of a pool, into one, or between two pools on one card, and
``extract_kv_device`` gathers them on the card for the KV device pipe
(``kv/device_pipe.py``). Every page movement is ordered on the card's
stream against the forwards around it: a spill's gather runs before the
next forward can overwrite the recycled page, and its copy to pinned
host memory runs on a side stream (:meth:`EngineCore._pages_to_host`); a
restore or an inject is copied in and scattered before the next forward
reads it. HTTP threads that extract or inject take ``_step_lock``, which
each step holds.

The model is any architecture of ``models/registry.py`` (Llama, OPT,
Mixtral), gated as the JAX engine gates them: LoRA slots and int8
weights go to the Llama family only (``quantization`` on another arch
raises the JAX engine's ValueError); the int8 KV pool, prefix caching,
chunked prefill, storm batching, speculation, structured output and the
offload tier serve every arch.

The engine surfaces of the stack's control plane are the JAX engine's:

- LoRA hot-swap (:meth:`EngineCore.load_lora_adapter`,
  :meth:`EngineCore.unload_lora_adapter`, ``lora_slots``): an adapter
  takes a free slot of the parameter tree's LoRA leaves, written in
  place on the device between forwards (under ``_step_lock``); a
  name-only adapter draws its A matrices from ``crc32(name)`` with the
  JAX engine's threefry, so it is the JAX engine's adapter;
- :meth:`EngineCore.embed`: the mean-pooled, L2-normalised final hidden
  state of one prefill on a throwaway one-page pool, off the scheduler
  path;
- :meth:`EngineCore.sleep` / :meth:`EngineCore.wake_up`: sleep preempts
  every sequence, spills every cached prefix block to the offload tier
  (when there is one, so prefix hits survive through the restore path),
  clears the prefix state, copies the parameters to pinned host memory
  and drops them and the pool from the device; wake copies them back and
  allocates a fresh pool.

A model named by a local HF checkpoint directory serves that
directory's weights (``models/weights.py``; int8-quantized on the host
under ``quantization="int8"``), unless the caller passes ``params``. The
KV pool's allocation runs the JAX engine's shrink ladder
(``pool_shrink_retries``, ``pool_shrink_step``) on an out-of-memory
error.

Tensor parallelism (``tensor_parallel_size = N``) runs the engine as N
ranks, one process each, on one host or spread over hosts
(``parallel/multihost.py``). Each rank holds its slice of the weights
(``parallel/sharding.py``) and a pool of its KV heads, and runs the
kernels on its own heads; the model adds the ranks' partial sums and
gathers the logits (``parallel/tp.py``), so sampling runs replicated on
the same logits everywhere. Rank 0, the leader, owns the scheduler, the
block accounting and HTTP; every device op it issues goes through one
chokepoint, :meth:`EngineCore._dispatch`, which sends the op's host
arguments to the followers before running it, and the followers replay
them (:meth:`EngineCore.run_follower`) through the same
:meth:`EngineCore._exec_op`. At N = 1 the chokepoint only calls
``_exec_op``. A speculative drafter runs on the leader alone (its tokens
reach the followers inside the verify op).

Pipeline parallelism (``pipeline_parallel_size = P``, the Llama family
only) stages the layer stack over P ranks: each holds its L/P layers of
the weights and a pool of its L/P layers, and the model's ``apply`` is
swapped for the GPipe schedule of ``parallel/pp_serving.py``, which
passes each microbatch's activations from stage to stage and shares the
last stage's hidden states with every stage (``parallel/pp.py``), so
every rank samples the same tokens. Data parallelism
(``data_parallel_size = D``) runs D replicas of the ``P x T`` ranks; as
on the JAX mesh, where no leaf and no pool names ``dp``, every replica
computes what the leader's does. The job has ``D x P x T`` processes,
rank ``r`` at ``(dp, pp, tp) = (r // (P T), (r // T) % P, r % T)``
(``parallel/mesh.py``); every rank, of every stage and replica, replays
every op, and a lost rank latches the engine's fault.

KV movement and the lifecycle span the ranks as in the JAX engine. A
whole block travels block-major, and each rank holds its part of it, its
KV heads of its stage's layers (``parallel/kv_blocks.py``):

- ``write_pages`` (an inject, a restore from the L3 tier): the leader
  sends the whole payload in 4-block chunks, and every rank writes its
  part;
- ``gather_pages`` (an extract, a spill to the L3 tier): every rank of
  replica 0 copies its part to pinned host memory and sends it to the
  leader over the job's gloo group, and the leader assembles the blocks;
- the host-RAM tier alone: every rank spills its part to its own store
  and restores from it (``offload_blocks``, ``restore_blocks``); the
  stores stay in lockstep, since every rank's puts come in op order with
  the same sizes, and a block missing on any rank latches the fault;
- ``sleep`` and ``wake``: every rank stages its own parameters to pinned
  host memory and drops its pool, and reallocates it on wake. The leader
  keeps the scheduler and the prefix bookkeeping.

``inject_from_core`` and ``extract_kv_device`` answer 0 and None when a
core is a job of several ranks, as the JAX engine's do: the host relay
serves those pulls.

The fused step (``fused_step``, with chunked prefill) is the JAX
engine's: when the scheduler has both a prefill step plan and running
sequences (action ``"fused"``), the plan's chunks and the decode burst
run their usual host-side code, :meth:`EngineCore._dispatch` diverts
their ``prefill`` and ``decode`` ops into a capture list instead of
launching them, and the pair goes out as ONE ``"fused"`` op (one
dispatch, one op-channel message under tp/pp) whose constituent ops run
through :meth:`EngineCore._exec_op`, so followers replay it unchanged.
Any other op that arrives mid-capture (a counts-row rebuild, a spill or
restore of pages, a verify) first issues what was captured, one op at a
time, in order, and then runs: the step degrades to the alternating
dispatches. A sequence whose final chunk rides the fused op sits that
burst out (its first token is not readable yet) and joins the next one,
so the streams equal the alternating schedule's.

The warm-up (:meth:`EngineCore.warmup`, run by the server before it
binds its socket) is the JAX engine's set of shapes, run once on dummy
rows whose page slots are all -1 (nothing is written): every prefill
bucket at its tight table width and, cached, at each width doubling to
``max_blocks_per_seq``; the batched ``[prefill_batch, chunk]`` prefill at
each width to its cap; each decode burst width (the full burst and the
pressure width) at each table width; the verify at each table width; the
drafter's catch-up buckets and scan. Eager PyTorch compiles nothing, so
what it takes out of the first request is the kernels' build and load,
cuBLAS's first use of each product shape, the caching allocator's growth
to the largest activation and each kernel instantiation's first launch.
Its ops go through :meth:`EngineCore._dispatch` like any other, so the
followers of a sharded engine replay them; a ``warmup`` op on every rank
brackets them and puts back what they move (the penalty counts, the last
burst's feedback tokens, the kernels' launch counters), and the leader
restores its dispatch counters, so no serving counter, series or step
record sees the warm-up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import prng
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kvcache import (
    BlockAllocator,
    KVCacheManager,
)
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGIT_BIAS,
    MAX_STOP_IDS,
    SamplingParams,
    accepted_prefix_len,
    apply_fsm_mask,
    fsm_allowed,
    logprob_outputs,
    make_rng_keys,
    mask_disallowed,
    sample_tokens,
    sample_with_gumbel,
    shape_logits,
)
from production_stack_tpu_torch.engine.scheduler import (
    EngineRequest,
    RunningSeq,
    Scheduler,
    SpecState,
)
from production_stack_tpu_torch.engine.tokenizer import build_tokenizer
from production_stack_tpu_torch.kv.offload import HostKVStore
from production_stack_tpu_torch.models import build_model, get_model_config
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.obs.steps import StepRecorder
from production_stack_tpu_torch.ops.attention import to_device
from production_stack_tpu_torch.parallel import multihost as mh
from production_stack_tpu_torch.parallel.mesh import build_mesh, default_devices
from production_stack_tpu_torch.parallel.pp import PPGroup, create_groups
from production_stack_tpu_torch.parallel.pp_serving import make_pp_apply
from production_stack_tpu_torch.parallel.sharding import (
    ROW_PARALLEL,
    check_pp,
    check_tp,
    is_row_parallel,
    kv_heads_local,
    shard_params,
    slice_leaf,
    stage_layers,
)
from production_stack_tpu_torch.parallel.tp import TPGroup
from production_stack_tpu_torch.structured.api import compile_char_dfa
from production_stack_tpu_torch.structured.tokenfsm import (
    FSMState,
    StructuredCache,
    mask_row_bytes,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)


def _parallel_sizes(config: EngineConfig) -> "tuple[int, int, int]":
    """The (dp, pp, tp) sizes a configuration asks for."""
    return (max(config.data_parallel_size, 1),
            max(config.pipeline_parallel_size, 1),
            max(config.tensor_parallel_size, 1))


def _unsupported(config: EngineConfig) -> List[str]:
    """Configured features this engine does not run yet: none."""
    return []


class _FusedPlaceholder:
    """The result slot of an op diverted into a fused-step capture, filled
    when the fused dispatch (or the degraded one-op-at-a-time drain)
    runs; ``error`` carries a failed dispatch to the deferred readback
    that would otherwise wait for a value that never comes. Readbacks
    waiting on it register in ``waiters`` and start their host copies
    when it is filled."""

    __slots__ = ("value", "error", "ready", "waiters")

    def __init__(self):
        self.value = None
        self.error = None
        self.ready = False
        self.waiters: list = []

    def settle(self, value=None, error=None) -> None:
        self.value, self.error, self.ready = value, error, True
        waiters, self.waiters = self.waiters, []
        if error is None:
            for fn in waiters:
                fn(value)


def _unwrap_fused(x):
    """A dispatch result, through its placeholder if it was captured
    (raising the captured dispatch's error, if any)."""
    if isinstance(x, _FusedPlaceholder):
        if x.error is not None:
            raise x.error
        return x.value
    return x


def _job_min(value: int) -> int:
    """The least of every rank's ``value`` (the job's gloo group; a
    barrier of the job too)."""
    t = torch.tensor([int(value)], dtype=torch.int64)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return int(t.item())


def kv_bytes_per_block(model_config, block_size: int,
                       kv_cache_dtype: str = "bf16") -> int:
    """Device bytes of one block of the K and V pools over all layers of
    ``model_config`` (a stage's config counts its layers), as allocated:
    "bf16" pages hold the model dtype; "int8" pages one byte a K/V
    element plus one float32 scale per (slot, kv head). (The JAX formula
    adds TPU tile padding; at Llama-family dims, head_dim 128, it has
    none and the two agree.)"""
    mc = model_config
    slot_heads = block_size * mc.num_kv_heads
    if kv_cache_dtype == "int8":
        return mc.num_layers * (2 * slot_heads * mc.head_dim
                                + 2 * slot_heads * 4)
    itemsize = torch.empty((), dtype=mc.torch_dtype).element_size()
    return mc.num_layers * 2 * slot_heads * mc.head_dim * itemsize


class EngineCore:
    def __init__(self, config: EngineConfig,
                 params: Optional[Dict] = None,
                 draft_params: Optional[Dict] = None,
                 devices: Optional[List] = None,
                 multihost: Optional[mh.MultihostContext] = None):
        """``params``: a parameter dict for the configured model (e.g. a
        JAX tree carried over by ``models/convert.py``); None draws the
        random init from ``config.seed`` on the device and, when
        ``config.model`` is a checkpoint directory, loads its weights over
        it. ``draft_params`` likewise for
        ``config.speculative_draft_model``.

        With ``data_parallel_size x pipeline_parallel_size x
        tensor_parallel_size = N > 1`` this process is one rank of an
        N-process job (``multihost``, by default the context of the
        ``TPU_STACK_*`` environment, ``parallel/multihost.py``; under it
        an unset ``data_parallel_size`` fills the job, as on a multi-host
        JAX engine), and ``params``, when given, is the WHOLE host tree
        (numpy leaves or CPU tensors), of which the rank keeps its slice.
        ``devices``: a device a rank (default: ``config.device``, rank r
        on ``cuda:(r % cards)``); this rank runs on its entry."""
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError(
                "not supported by the torch engine yet: " + ", ".join(missing))
        self.config = config
        self.model_config = get_model_config(config.model)
        if config.dtype:
            self.model_config = self.model_config.replace(dtype=config.dtype)
        dp, pp, tp = _parallel_sizes(config)
        check_tp(self.model_config, tp)
        check_pp(self.model_config, pp)
        if config.quantization and self.model_config.arch != "llama":
            raise ValueError(
                "int8 quantization is supported for the llama family "
                f"(model arch {self.model_config.arch!r})")
        # Latched by an unrecoverable fault (a lost rank): every request
        # fails, the loop stops and /health answers 503.
        self.fatal_error: Optional[str] = None
        self._mh: Optional[mh.MultihostContext] = None
        self._tp: Optional[TPGroup] = None
        self._pp: Optional[PPGroup] = None
        self._rank_prof = None  # rank_stats(profile=True)'s profiler
        self.rank = 0
        if (dp * pp * tp > 1 or multihost is not None
                or mh.distributed_env() is not None):
            self._mh = multihost if multihost is not None else (
                mh.maybe_context())
            if self._mh is None:
                raise ValueError(
                    f"data_parallel_size {dp} x pipeline_parallel_size {pp}"
                    f" x tensor_parallel_size {tp} runs as {dp * pp * tp} "
                    f"processes of one job: start it through the server "
                    f"entry, or join every rank with "
                    f"multihost.initialize_from_env()")
            # As in the JAX engine, an unset dp fills the job.
            dp = mh.job_dp(self._mh.num_processes, config.data_parallel_size,
                           pp, tp)
            self.rank = self._mh.process_id
        n = dp * pp * tp
        self.layout = build_mesh(
            tp, dp, pp, devices if devices is not None
            else default_devices(config.device, n))
        _dp, self.stage, self.tp_rank = self.layout.coords(self.rank)
        self.device = self.layout.device_of(self.rank)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {config.device!r} requested but no CUDA device is "
                f"available (pass device='cpu' to run on the CPU)")
        # Ranks placed on this rank's card split its free memory.
        self._card_share = 1
        self._backend: Optional[str] = None
        if self._mh is not None:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._agree_on_config()
            self._tp, self._pp, self._backend, self._card_share = (
                create_groups(self.layout, self.rank, self.device))
            logger.info(
                "Rank %d/%d (dp %d, pp %d, tp %d) on %s: %s transfers (%d "
                "rank(s) on this device)", self.rank, n, _dp, self.stage,
                self.tp_rank, self.device, self._backend, self._card_share)
        # This stage's layers (all of them without a pipeline), and the
        # model config of a stage: its pool and its bytes a block count
        # these layers only.
        self.layers = stage_layers(self.model_config.num_layers, self.stage,
                                   pp)
        self.stage_config = self.model_config.replace(
            num_layers=len(self.layers))
        self.tokenizer = build_tokenizer(
            config.model, self.model_config.vocab_size,
            chat_template_path=config.chat_template)
        init_fn, self._apply = build_model(self.model_config)
        if pp > 1:
            # Stage-sharded serving: the GPipe schedule in place of the
            # layer loop, with apply's signature, so every step runs on it.
            self._apply = make_pp_apply(
                self._pp, microbatches=config.pp_microbatches or pp)
        stage_kw = {"stage": self.stage, "pp": pp} if pp > 1 else {}
        load_ckpt = params is None
        if params is None:
            lora_kwargs = {}
            # LoRA slots are a Llama-family feature, as in the JAX engine.
            if self.model_config.arch == "llama" and config.max_loras > 0:
                lora_kwargs = {"lora_slots": config.max_loras,
                               "lora_rank": config.max_lora_rank}
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            with torch.no_grad():
                # int8 weights quantize leaf by leaf inside the init, so
                # an 8B model never exists whole in bf16 on the card; a
                # rank draws every leaf as one rank does and keeps its
                # slice of it (its stage's layers, its tp part).
                params = init_fn(
                    self.model_config, gen, self.device,
                    quantization=config.quantization,
                    quantize_embeddings=config.quantize_embeddings,
                    rank=self.tp_rank, tp=tp, **stage_kw, **lora_kwargs)
        elif n > 1:
            params = params_from_numpy(params, self.model_config,
                                       self.device, self.tp_rank, tp,
                                       self.stage, pp)
        self.params = params
        # Wall seconds of the checkpoint load (read, quantize, copy to the
        # device), when the model is a checkpoint directory.
        self.checkpoint_load_s: Optional[float] = None
        if load_ckpt:
            self._maybe_load_checkpoint()

        # -- draft model (speculative decoding proposer) -------------------
        # Built BEFORE the target's pool is sized: its weights and its
        # worst-case pool come out of free memory first, so the target's
        # pool never shrinks for drafts mid-flight. The leader alone
        # drafts: its drafts reach the followers inside the verify op.
        self._draft = None
        if config.speculative_draft_model and self.rank == 0:
            from production_stack_tpu_torch.engine.draft import DraftModel

            self._draft = DraftModel(config, self.model_config, self.device,
                                     params=draft_params)

        # -- KV pages ------------------------------------------------------
        # A rank's pool holds its KV heads of its stage's layers; every
        # rank of the job takes the least of the ranks' pool sizes (the
        # block accounting is the leader's).
        self.kv_heads = kv_heads_local(self.model_config, tp)
        if self._mh is not None:
            _job_min(0)  # every rank's weights are in memory
        free_before = self._free_device_bytes()
        self.num_blocks = config.num_blocks or self._auto_num_blocks()
        if self._mh is not None:
            self.num_blocks = _job_min(self.num_blocks)
        mc = self.model_config
        self.pool_shrink_retries_total = 0
        self.kv = self._alloc_kv_with_shrink()
        # Device memory left after the pool (tpu:hbm_headroom_bytes).
        self.hbm_headroom_bytes: Optional[int] = None
        if free_before is not None:
            self.hbm_headroom_bytes = max(
                free_before - self.num_blocks * self._kv_bytes_per_block(), 0)
        self.kv_mgr = KVCacheManager(
            self.num_blocks, config.block_size, config.enable_prefix_caching,
            namespace=config.model)
        if self._draft is not None:
            # Every teardown (finish, preempt, abort) frees target KV
            # through kv_mgr.free: the drafter's pages go with it.
            self.kv_mgr.on_free = self._draft.release
        # -- KV offload tier and the eviction fan-out ----------------------
        self.offload: Optional[HostKVStore] = None
        # (prefix hash, block id) of cached pages evicted since the last
        # drain: spilled before any forward can overwrite them.
        self._pending_offload: List[tuple] = []
        self._copy_stream = None  # the spills' device-to-host copies
        # In a job of several ranks the remote tier's store of whole
        # blocks is the leader's; a host-RAM tier alone is one store a
        # rank, of the rank's parts of the blocks.
        if (config.kv_remote_url and self.rank == 0) or (
                config.kv_offload_bytes > 0 and not config.kv_remote_url):
            self.offload = HostKVStore(max(config.kv_offload_bytes, 0),
                                       config.kv_remote_url)
            self.kv_mgr.external_lookup = self.offload.contains
        # Device bytes the last sleep released on this rank (weights and
        # pool), and the host and gloo seconds of this rank's part of the
        # KV gathers (an extract, a spill to the L3 tier).
        self.sleep_freed_bytes = 0
        self.kv_gathers_total = 0
        self.kv_gather_copy_s = 0.0
        self.kv_gather_gloo_s = 0.0
        # The server's KV-controller evict report. Fired on the engine
        # thread, possibly under self._lock: a listener only enqueues.
        self.prefix_evict_listener: Optional[Callable[[int, int], None]] = None
        self.prefix_evicts_total = 0
        self.evict_listener_errors_total = 0
        self.kv_mgr.allocator.on_evict = self._dispatch_evict
        self.scheduler = Scheduler(
            self.kv_mgr, config.max_num_seqs, config.max_model_len,
            chunked_prefill=config.chunked_prefill_enabled,
            chunk_tokens=config.chunk_tokens(),
            token_budget=config.token_budget,
            max_consecutive_prefills=config.max_consecutive_prefills,
            # Multi-row chunk steps ride the batched prefill.
            max_prefill_rows=(
                config.prefill_batch if config.prefill_batch > 1 else 1),
            fused_step=config.fused_step)

        # Adapter name -> LoRA slot (1 .. max_loras - 1; slot 0 is the base
        # model's zero adapter).
        self.lora_slots: Dict[str, int] = {}
        # Sleep mode: the parameters on the host while asleep.
        self._sleeping = False
        self._host_params: Optional[Dict] = None
        _eos = getattr(self.tokenizer, "eos_token_id", None)
        self._eos_id = int(_eos) if _eos is not None else -1

        # -- counters (exported via /metrics) ------------------------------
        self.prompt_tokens_total = 0
        self.cached_tokens_total = 0
        self.generation_tokens_total = 0
        self.requests_finished_total = 0
        # Wall-clock split of the engine thread: prefill steps, decode
        # bursts (dispatch plus the previous burst's readback), readbacks.
        self.prefill_time_total = 0.0
        self.decode_time_total = 0.0
        self.flush_time_total = 0.0
        self.prefill_count = 0
        # Storm-scoped batched prefills: groups and the prompts they
        # carried; every batched (multi-row) prefill dispatch, groups' and
        # step plans' alike.
        self.prefill_group_count = 0
        self.prefill_group_rows = 0
        self.prefill_batched_dispatch_total = 0
        # Prefill chunks dispatched (each span of a prompt, and each row
        # of a step plan), prompt tokens a step plan deferred, and the
        # last step plan's token count.
        self.prefill_chunks_total = 0
        # Cached-prefill dispatches by attention route, under the JAX
        # engine's labels: "pallas" is the hand-written kernel (the only
        # route here); "xla", the JAX gather fallback, stays 0.
        self.prefill_attention_dispatch_total = {"pallas": 0, "xla": 0}
        self.deferred_prefill_tokens_total = 0
        self.last_step_batched_tokens = 0
        self.decode_burst_count = 0
        # Fused steps: prefill-chunk + decode-burst pairs launched as ONE
        # dispatch; and every dispatch with the engine thread's seconds
        # spent launching them (a fused pair counts one, an alternating
        # pair two).
        self.fused_steps_total = 0
        self.dispatch_count_total = 0
        self.dispatch_enqueue_s = 0.0
        # While a fused step is built: the captured ops, each (name,
        # static, arrays, placeholder), instead of launched ones.
        self._fused_capture: Optional[list] = None
        # Target-model forwards of the decode path: K a plain K-step
        # burst, one a verify burst (generation tokens per forward is what
        # speculation buys).
        self.decode_forward_steps_total = 0
        # Speculative decoding: draft tokens sent to the verify and
        # accepted by it (in total and by proposer, the source label of
        # tpu:spec_*_tokens_total), requests latched back to plain decode,
        # verify bursts, and the drafter's own forwards (not in
        # decode_forward_steps_total).
        self.spec_proposed_tokens_total = 0
        self.spec_accepted_tokens_total = 0
        self.spec_disabled_requests_total = 0
        self.spec_verify_bursts_total = 0
        self.spec_proposed_by_source = {"ngram": 0, "draft_model": 0}
        self.spec_accepted_by_source = {"ngram": 0, "draft_model": 0}
        self.spec_draft_forward_steps_total = 0
        # Structured output: the compiled token-FSM cache (LRU) and the
        # tpu:structured_* counters. Every mask row is as wide as the
        # vocabulary's bits.
        self._structured_cache = StructuredCache(config.structured_cache_size)
        self._mask_row_bytes = mask_row_bytes(mc.vocab_size)
        self.structured_requests_total = 0
        self.structured_violations_total = 0
        # The warm-up's programs by kind (the JAX engine's counts), its
        # seconds, and the kernel launches it made on the leader (the
        # counters themselves are put back). Each rank's stash of what
        # the warm-up moves while it runs.
        self.warmup_variants: Dict[str, int] = {}
        self.warmup_seconds: Optional[float] = None
        self.warmup_launches: Dict[str, int] = {}
        self._warmup_saved: Optional[dict] = None

        # Step flight recorder: the step functions stash ``_step_info``
        # only when it is on; _loop completes it with the step's wall time.
        # The recorder reads the leader's own card: its bytes a token.
        self.step_recorder: Optional[StepRecorder] = (
            StepRecorder(capacity=config.step_record_capacity,
                         kv_token_bytes=(self._kv_bytes_per_block()
                                         // config.block_size))
            if config.step_recorder else None)
        self._step_info: Optional[dict] = None
        # Requests a prefill step took from the queue besides its own (a
        # storm group's members): failed with it if it raises.
        self._step_reqs: List[EngineRequest] = []

        # The decode burst in flight (launched, not yet read back), the
        # prefills whose first token is not read back yet, and the [B,
        # decode_steps] tokens of the last burst on the device: the next
        # burst's feedback.
        self._pending_burst: Optional[dict] = None
        self._pending_prefills: List[dict] = []
        self._last_burst_tokens: Optional[torch.Tensor] = None

        # Per-slot output-token counts [B, V] behind presence/frequency
        # penalties; a slot's row resets when a fresh output starts in it.
        self._token_counts = torch.zeros(
            (config.max_num_seqs, mc.vocab_size), dtype=torch.int32,
            device=self.device)
        self._counts_reset: "set[int]" = set()
        # The sampled tokens of every op this rank executed, on the host,
        # when a caller sets it to a list (the ranks' streams compared);
        # and the count of ops this rank executed (a warm-up's included:
        # every rank of a job runs the leader's ops).
        self.sampled_log: Optional[list] = None
        self.ops_total = 0

        # -- engine thread -------------------------------------------------
        self._lock = threading.Condition()
        # Held around each step's body; KV extract/inject from HTTP
        # threads take it so no step rewrites the pool meanwhile. Lock
        # order: _step_lock before _lock.
        self._step_lock = threading.Lock()
        # Serializes sleep() and wake_up() (taken before _step_lock).
        self._lifecycle_lock = threading.Lock()
        # Callers inside between_steps(): the loop takes no step while
        # any wait, so the step lock comes to them at the next boundary.
        self._pausing = 0
        self._running = True
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="engine-core")
        if self._mh is not None and self._mh.is_leader:
            self._mh.on_lost = self._rank_lost

    # ------------------------------------------------------------------ #
    # setup helpers
    # ------------------------------------------------------------------ #
    def _agree_on_config(self) -> None:
        """Tensor parallelism: the leader sends its configuration, and a
        follower started with another one raises (every rank must build
        the same engine, or their ops and collectives disagree)."""
        mine = dataclasses.asdict(self.config)
        if self._mh.is_leader:
            self._mh.channel.send(("config", {"config": mine}, []))
            return
        op = self._mh.channel.recv()
        if op[0] != "config":
            raise RuntimeError(f"expected the leader's config, got {op[0]!r}")
        theirs = op[1]["config"]
        diff = sorted(k for k in mine if mine[k] != theirs.get(k))
        if diff:
            raise ValueError(
                f"rank {self.rank}: engine config differs from the "
                f"leader's in {diff}")

    def _maybe_load_checkpoint(self) -> None:
        """When the model names a local HF checkpoint directory, replace
        the drawn leaves with its weights (quantized on the host first
        under ``quantization="int8"``, so int8 crosses to the device).
        Leaves the checkpoint does not carry (the LoRA slots) keep their
        init values; a tied-embedding Llama checkpoint drops the drawn
        head, so the model reads ``embed.T``. A checkpoint that cannot be
        read raises."""
        from production_stack_tpu_torch.models.convert import (
            tensor_from_numpy,
        )
        from production_stack_tpu_torch.models.weights import (
            has_checkpoint,
            load_checkpoint,
        )

        if not has_checkpoint(self.config.model):
            return
        t0 = time.perf_counter()
        tp, int8 = self.layout.shape["tp"], (
            self.config.quantization == "int8")
        # A rank copies its slice of its stage's layers out of the mapped
        # files; an int8 row-parallel leaf is read whole, quantized, then
        # sliced, so its scale is the whole leaf's.
        loaded = load_checkpoint(self.model_config, self.config.model,
                                 self.tp_rank, tp,
                                 whole=ROW_PARALLEL if int8 else (),
                                 layers=self.layers)
        if int8:
            from production_stack_tpu_torch.models.quantize import (
                quantize_loaded,
            )

            loaded = quantize_loaded(
                loaded, self.model_config.arch,
                quantize_embeddings=self.config.quantize_embeddings)
            if tp > 1:
                sliced = shard_params(
                    {"layers": loaded["layers"]}, self.model_config,
                    self.tp_rank, tp)["layers"]
                loaded["layers"] = {
                    k: (sliced[k] if is_row_parallel(("layers", k)) else v)
                    for k, v in loaded["layers"].items()}

        def merge(dst: dict, src: dict) -> None:
            for key, val in src.items():
                if isinstance(val, dict):
                    merge(dst.setdefault(key, {}), val)
                else:
                    # The drawn leaf goes before its replacement lands.
                    dst.pop(key, None)
                    dst[key] = tensor_from_numpy(val, self.device)

        merge(self.params, loaded)
        if self.model_config.arch == "llama" and "lm_head" not in loaded:
            self.params.pop("lm_head", None)
            self.params.pop("lm_head_scale", None)
        del loaded
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.checkpoint_load_s = time.perf_counter() - t0
        logger.info("Loaded checkpoint weights from %s in %.2f s",
                    self.config.model, self.checkpoint_load_s)

    def _alloc_kv_with_shrink(self):
        """The KV pool, with the JAX engine's shrink ladder: free memory
        read before allocation can miss what is still held, so an
        out-of-memory error at the pool's allocation shrinks
        ``num_blocks`` by ``pool_shrink_step`` and retries, up to
        ``pool_shrink_retries`` rungs, never below two sequences' worth of
        blocks. Only ``torch.cuda.OutOfMemoryError`` is caught."""
        cfg = self.config
        # Ranks must agree on the pool's size: in a job of several ranks
        # an out-of-memory error is fatal, as on a multi-host JAX engine.
        rungs = cfg.pool_shrink_retries if self._mh is None else 0
        min_blocks = cfg.max_blocks_per_seq * 2
        for rung in range(rungs + 1):
            k = v = None
            try:
                k = self._alloc_pages()
                v = self._alloc_pages()
                return k, v
            except torch.cuda.OutOfMemoryError:
                k = v = None  # the side that did fit goes first
                if rung >= rungs or self.num_blocks <= min_blocks:
                    logger.error(
                        "KV pool allocation out of memory with no shrink "
                        "rungs left (num_blocks=%d, floor=%d)",
                        self.num_blocks, min_blocks)
                    raise
                shrunk = max(
                    int(self.num_blocks * (1.0 - cfg.pool_shrink_step)),
                    min_blocks)
                logger.warning(
                    "KV pool allocation out of memory at %d blocks; "
                    "shrinking to %d (rung %d/%d)",
                    self.num_blocks, shrunk, rung + 1, rungs)
                self.num_blocks = shrunk
                self.pool_shrink_retries_total += 1
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()

    def _kv_bytes_per_block(self) -> int:
        """Bytes of one block of THIS rank's pool (its KV heads of its
        stage's layers). Sizing the pool by it is the JAX engine's budget
        times its tp and pp factors."""
        return kv_bytes_per_block(
            self.stage_config.replace(num_kv_heads=self.kv_heads),
            self.config.block_size, self.config.kv_cache_dtype)

    def _alloc_pages(self):
        """One side (K or V) of the pool: zeros ``[L, NB, bs, KVH, D]`` in
        the model dtype, or for an int8 cache zero int8 data with float32
        scales ``[L, NB, bs*KVH]`` set to ONE, as the JAX engine sets them
        (a never-written slot dequantizes to exact zeros). KVH is this
        rank's KV heads."""
        mc, bs = self.stage_config, self.config.block_size
        shape = (mc.num_layers, self.num_blocks, bs, self.kv_heads,
                 mc.head_dim)
        if self.config.kv_cache_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                    torch.ones((mc.num_layers, self.num_blocks,
                                bs * self.kv_heads), dtype=torch.float32,
                               device=self.device))
        return torch.zeros(shape, dtype=mc.torch_dtype, device=self.device)

    def _free_device_bytes(self) -> Optional[int]:
        """Free memory of this rank's card; ranks that share the card each
        get their share of it."""
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return int(free) // self._card_share

    def _auto_num_blocks(self) -> int:
        """Size the KV pool from free device memory (hbm_utilization),
        as the JAX engine does from its HBM figure."""
        free = self._free_device_bytes()
        num = 0
        if free is not None:
            # The reserve is per card, shared like the free memory.
            free = max(free - self.config.hbm_headroom_reserve
                       // self._card_share, 0)
            num = int(free * self.config.hbm_utilization
                      // self._kv_bytes_per_block())
        num = max(num, self.config.max_blocks_per_seq * 2)
        # Cap by what max_num_seqs could ever use, plus prefix-cache headroom.
        cap = self.config.max_blocks_per_seq * (self.config.max_num_seqs * 4)
        return min(num, cap)

    # ------------------------------------------------------------------ #
    # KV movement: offload, restore, extract, inject
    # ------------------------------------------------------------------ #
    def _dispatch_evict(self, prefix_hash: int, bid: int) -> None:
        """The allocator's eviction hook (engine thread, maybe under
        self._lock). With an offload tier the block is queued for a spill
        and the controller keeps its claim (the prefix is still served
        here, through a restore); without one the eviction is counted and
        reported to the listener."""
        if self.offload is not None:
            self._pending_offload.append((prefix_hash, bid))
            return
        self.prefix_evicts_total += 1
        listener = self.prefix_evict_listener
        if listener is not None:
            try:
                listener(prefix_hash, bid)
            except Exception:  # noqa: BLE001 - never break the allocator
                self.evict_listener_errors_total += 1

    def _drain_offload(self) -> None:
        """Spill the blocks evicted since the last drain into the offload
        store (engine thread, no self._lock held). Called after every
        allocation that can evict and before the forward that follows
        it, so the gather reads the pages before they are recycled. In a
        job of several ranks the spill is an op: with a remote tier one
        gather of whole blocks into the leader's store, else every rank
        spills its part into its own."""
        pending, self._pending_offload = self._pending_offload, []
        if not pending or self.kv is None:
            return
        hashes = [h for h, _ in pending]
        bids = [bid for _, bid in pending]
        if self._mh is None or not self.config.kv_remote_url:
            self._dispatch("offload_blocks", {"hashes": hashes},
                           [np.asarray(bids, np.int64)])
            return
        k, v = self._gather_pages(bids)
        for n, prefix_hash in enumerate(hashes):
            self.offload.put(prefix_hash, _leaf_map(lambda t: t[n], k),
                             _leaf_map(lambda t: t[n], v))

    def _offload_blocks_op(self, hashes: List[int], bids) -> None:
        """This rank's parts of blocks ``bids`` (one rank's: the whole
        blocks) into its own store."""
        k, v, ready = self._pages_to_host([int(b) for b in bids])
        for n, prefix_hash in enumerate(hashes):
            self.offload.put(prefix_hash, _leaf_map(lambda t: t[n], k),
                             _leaf_map(lambda t: t[n], v), ready=ready)

    def _pages_to_host(self, bids: List[int]):
        """(k, v, ready) of THIS rank's pages of blocks ``bids`` on the
        host, block-major ``[N, L, bs, KVH, D]`` (int8: with ``[N, L,
        bs*KVH]`` scales). On a card one gather on the engine's stream
        (ordered before any later forward) and one copy into pinned
        memory on a side stream, so the engine thread does not wait for
        it; ``ready()`` waits until the copy has landed. On the CPU,
        plain copies (``ready`` is None)."""
        idx = torch.tensor(bids, dtype=torch.long, device=self.device)

        def gather(t):
            return t.transpose(0, 1).index_select(0, idx)

        k = _leaf_map(gather, self.kv[0])
        v = _leaf_map(gather, self.kv[1])
        if self.device.type != "cuda":
            return k, v, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        cs = self._copy_stream
        cs.wait_stream(torch.cuda.current_stream(self.device))

        def to_host(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(cs):
                host.copy_(t, non_blocking=True)
            t.record_stream(cs)  # the gathered pages live until copied
            return host

        k, v = _leaf_map(to_host, k), _leaf_map(to_host, v)
        done = torch.cuda.Event()
        done.record(cs)
        return k, v, done.synchronize

    def _gather_pages(self, bids: List[int]):
        """(k, v): whole blocks ``bids`` of a job of several ranks on the
        leader's host, block-major (the TKV2 layout), through the
        ``gather_pages`` op; the caller holds _step_lock."""
        return self._dispatch("gather_pages", {},
                              [np.asarray(bids, np.int64)])

    def _gather_pages_op(self, bids):
        """Every rank of replica 0 copies its parts of blocks ``bids`` to
        pinned host memory; the followers send theirs to the leader over
        the job's gloo group (which takes host tensors only), and the
        leader assembles the whole blocks (returned; None elsewhere).
        Other replicas hold the same pages and send nothing."""
        import torch.distributed as dist

        from production_stack_tpu_torch.parallel.kv_blocks import assemble

        replica = self.layout.replicas()[0]
        if self.rank not in replica:
            return None
        t0 = time.perf_counter()
        k, v, ready = self._pages_to_host([int(b) for b in bids])
        if ready is not None:
            ready()
        t1 = time.perf_counter()
        mine = [*_leaves_of(k), *_leaves_of(v)]
        if self.rank != 0:
            for tag, t in enumerate(mine):
                dist.send(_as_bytes(t), dst=0, tag=tag)
        else:
            parts = [(k, v)]
            for src in replica[1:]:
                got = [torch.empty_like(t) for t in mine]
                for tag, t in enumerate(got):
                    dist.recv(_as_bytes(t), src=src, tag=tag)
                half = len(got) // 2
                parts.append(tuple(
                    tuple(side) if len(side) > 1 else side[0]
                    for side in (got[:half], got[half:])))
        t2 = time.perf_counter()
        self.kv_gathers_total += 1
        self.kv_gather_copy_s += t1 - t0
        self.kv_gather_gloo_s += t2 - t1
        if self.rank != 0:
            return None
        shape = self.layout.shape
        return tuple(assemble([p[side] for p in parts], self.model_config,
                              shape["tp"], shape["pp"]) for side in (0, 1))

    def _to_card(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the engine's device through pinned memory, as
        an asynchronous copy ordered on the engine's stream. A transposed
        view of a contiguous buffer (an ``[N, L]`` payload read as ``[L,
        N]``) moves as its buffer and is transposed on the card."""
        if t.device == self.device:
            return t
        if (not t.is_contiguous() and t.dim() > 1
                and t.transpose(0, 1).is_contiguous()):
            return self._to_card(t.transpose(0, 1)).transpose(0, 1)
        return to_device(t.contiguous(), self.device)

    def _block_shapes(self):
        """Per side, (shape, dtype) of each leaf of one WHOLE block (every
        layer, every KV head): what a payload's blocks hold."""
        mc, bs = self.model_config, self.config.block_size
        pages = (mc.num_layers, bs, mc.num_kv_heads, mc.head_dim)
        if self.config.kv_cache_dtype == "int8":
            return ((pages, torch.int8),
                    ((mc.num_layers, bs * mc.num_kv_heads), torch.float32))
        return ((pages, mc.torch_dtype),)

    def _fits(self, side, n: Optional[int] = None) -> bool:
        """Whether one side of a payload (``n`` blocks, block-major; a
        single block without the block axis when ``n`` is None) has this
        pool's page encoding, dtypes and whole-block shapes."""
        want = self._block_shapes()
        if (len(want) > 1) != isinstance(side, (tuple, list)):
            return False
        lead = () if n is None else (n,)
        return all(x.dtype == dtype and tuple(x.shape) == lead + shape
                   for (shape, dtype), x in zip(want, _leaves_of(side)))

    def _write_pages(self, bids: List[int], k, v) -> None:
        """The page-write helper of restores and injects: whole blocks,
        block-major ``[N, L, ...]`` leaves on the host or the card, into
        blocks ``bids``, one scatter a leaf on the engine's stream. A
        payload whose layout or encoding differs from the pool's raises
        before any page is written. In a job of several ranks the payload
        crosses the op channel from the host, in 4-block chunks, so that
        one write does not hold the dispatch lock against every step."""
        for side in (k, v):
            if not self._fits(side, len(bids)):
                raise ValueError(
                    "payload " + ", ".join(
                        f"{tuple(x.shape)} {x.dtype}"
                        for x in _leaves_of(side))
                    + f" does not fit this pool's blocks "
                      f"({self.config.kv_cache_dtype} pages of "
                      f"{self._block_shapes()[0][0]})")
        if self._mh is None:
            self._dispatch("write_pages", {}, [bids, k, v])
            return
        step = 4
        for s0 in range(0, len(bids), step):
            chunk = [_leaf_map(lambda t: t[s0:s0 + step].cpu().clone(), x)
                     for x in (k, v)]
            self._dispatch("write_pages", {}, [bids[s0:s0 + step], *chunk])

    def _write_pages_op(self, bids: List[int], k, v) -> None:
        """Write this rank's part of whole blocks ``k``/``v`` into blocks
        ``bids`` (``index_copy_`` a leaf)."""
        shape = self.layout.shape
        if shape["tp"] * shape["pp"] > 1:
            from production_stack_tpu_torch.parallel.kv_blocks import (
                block_slice,
            )

            k, v = (block_slice(x, self.model_config, self.tp_rank,
                                shape["tp"], self.stage, shape["pp"])
                    for x in (k, v))
        self._write_local(bids, k, v)

    def _write_local(self, bids: List[int], k, v) -> None:
        """Block-major leaves of this rank's shape into blocks ``bids``."""
        idx = torch.tensor(bids, dtype=torch.long, device=self.device)
        for pages, new in zip(self.kv, (k, v)):
            for p, x in zip(_leaves_of(pages), _leaves_of(new)):
                p.index_copy_(1, idx, self._to_card(x).transpose(0, 1))

    def _restore_blocks(self, restores) -> bool:
        """Copy offloaded blocks ``[(block id, hash), ...]`` back to the
        card before the prefill forward reads them. False at the first
        miss: the store answered ``contains`` but not ``get``, or gave a
        block of another page encoding or shape (an L3 shared with
        engines of other encodings holds their blocks under the same
        chain hashes); the prompt then recomputes. In a job of several
        ranks with a host-RAM tier alone, the leader checks its store
        first and every rank restores its parts from its own
        (``restore_blocks``). That path stays apart from one rank's: there
        a miss after ``contains`` means the lockstep stores diverged, a
        fault, where one rank recomputes (as the JAX engine does on one
        process and raises across several)."""
        if self._mh is not None and not self.config.kv_remote_url:
            if self.offload is None or not all(
                    self.offload.contains(h) for _, h in restores):
                return False
            self._dispatch("restore_blocks",
                           {"hashes": [h for _, h in restores]},
                           [np.asarray([b for b, _ in restores], np.int64)])
            return True
        entries = []
        for _, h in restores:
            entry = self.offload.get(h) if self.offload is not None else None
            if entry is None:
                return False
            if not all(self._fits(side) for side in entry):
                logger.warning("offloaded block %d does not fit this pool's "
                               "pages: recomputing", h)
                return False
            entries.append(entry)
        self._wait_for_spills()
        # One rank stacks the blocks on its card; the leader of several
        # stacks them on the host, whence its chunks cross the op channel.
        self._write_pages([bid for bid, _ in restores], *_stacked(
            entries, self._to_card if self._mh is None else (lambda t: t)))
        return True

    def _wait_for_spills(self) -> None:
        if self._copy_stream is not None:
            # A block spilled moments ago may still be on its way to the
            # host: the copies that follow wait for it on the card.
            torch.cuda.current_stream(self.device).wait_stream(
                self._copy_stream)

    def _restore_blocks_op(self, hashes: List[int], bids) -> None:
        """Every rank writes its parts of the blocks from its own store.
        The ranks first agree that every store held every block (a gloo
        collective): the stores run in lockstep, so a miss anywhere means
        they diverged, which no rank can repair; every rank then raises,
        and the leader's step latches the fault."""
        entries = [self.offload.get(h) if self.offload is not None
                   else None for h in hashes]
        missing = sum(e is None for e in entries)
        if _job_min(0 if missing else 1) == 0:
            raise RuntimeError(
                f"offload store diverged: {missing} of {len(hashes)} "
                f"blocks missing on rank {self.rank}"
                + ("" if missing else " (a miss on another rank)"))
        self._wait_for_spills()
        self._write_local([int(b) for b in bids],
                          *_stacked(entries, self._to_card))

    def _cached_chain(self, token_ids: List[int], adapter: str):
        """(hashes, block ids) of the longest cached full-block prefix of
        ``token_ids`` in this pool's prefix map. Callers hold self._lock."""
        prefix_map = self.kv_mgr.allocator.prefix_map
        hashes, bids = [], []
        for h in self.kv_mgr.chain_hashes(token_ids, adapter):
            bid = prefix_map.get(h)
            if bid is None:
                break
            hashes.append(h)
            bids.append(bid)
        return hashes, bids

    def extract_kv(self, token_ids: List[int], adapter: str = "",
                   on_device: bool = False):
        """The pages of the longest cached prefix of ``token_ids``, on the
        host: ``{"hashes", "num_tokens", "k", "v"}`` with block-major
        ``[N, L, bs, KVH, D]`` leaves (the TKV2 layout), or None when no
        full block is cached (or the engine sleeps). The gather is
        enqueued under _step_lock (after the work already queued, before
        any later step); on one rank the copy is waited for outside it,
        in a job of several it is the ``gather_pages`` op. With
        ``on_device`` the gathered pages stay on the device, layer-major
        ``[L, N, bs, KVH, D]`` (what the KV device pipe offers for a
        peer's pull; the pipe synchronizes before it hands them out), and
        a job of several ranks answers None, as in the JAX engine: the
        host relay serves that pull."""
        if on_device and self._mh is not None:
            return None
        ready = None
        with self._step_lock:
            if self.kv is None:
                return None
            with self._lock:
                hashes, bids = self._cached_chain(token_ids, adapter)
            if not hashes:
                return None
            if on_device:
                idx = torch.tensor(bids, dtype=torch.long,
                                   device=self.device)
                k, v = (_leaf_map(lambda t: t.index_select(1, idx), pages)
                        for pages in self.kv)
            elif self._mh is None:
                k, v, ready = self._pages_to_host(bids)
            else:
                k, v = self._gather_pages(bids)
        if ready is not None:
            ready()
        return {"hashes": hashes,
                "num_tokens": len(hashes) * self.config.block_size,
                "k": k, "v": v}

    def extract_kv_device(self, token_ids: List[int], adapter: str = ""):
        """:meth:`extract_kv` with ``on_device`` (the JAX engine's name)."""
        return self.extract_kv(token_ids, adapter, on_device=True)

    def _install(self, hashes: List[int], write) -> int:
        """Allocate a block for each of ``hashes`` not cached here yet,
        ``write(positions, block ids)`` their pages, then register them as
        cold cached blocks (ref_count 0). A write that raises gives the
        blocks back and re-raises. Returns the blocks cached and
        installed. Callers hold _step_lock."""
        alloc = self.kv_mgr.allocator
        if (not alloc.enable_prefix_caching or self._sleeping
                or self.kv is None):
            return 0
        take, dst, already = [], [], 0
        with self._lock:
            for n, h in enumerate(hashes):
                if h in alloc.prefix_map:
                    already += 1
                    continue
                bid = alloc.allocate()
                if bid is None:
                    break
                take.append(n)
                dst.append(bid)
        # Pages the allocations evicted spill before they are overwritten.
        self._drain_offload()
        if dst:
            try:
                write(take, dst)
            except Exception:
                with self._lock:
                    for bid in dst:
                        alloc.release(bid)
                raise
            with self._lock:
                for n, bid in zip(take, dst):
                    alloc.register_full_block(bid, hashes[n])
                    alloc.release(bid)  # cached, ref_count 0
        return already + len(dst)

    def inject_kv_blocks(self, hashes: List[int], k, v) -> int:
        """Install transferred pages (layer-major ``[L, N, ...]`` leaves of
        whole blocks, on the host or the card) as cached prefix blocks,
        in one scatter a leaf (in a job of several ranks, every rank
        writes its part). Returns the blocks cached here afterwards
        (already cached ones count). A payload that does not fit the pool
        raises, and its blocks go back to the pool."""
        kb, vb = (_leaf_map(lambda t: t.transpose(0, 1), x) for x in (k, v))

        def write(take, dst):
            def pick(t):
                if take == list(range(t.shape[0])):
                    return t
                return t.index_select(
                    0, torch.tensor(take, dtype=torch.long, device=t.device))

            self._write_pages(dst, *(_leaf_map(pick, x) for x in (kb, vb)))

        with self._step_lock:
            return self._install(list(hashes), write)

    def inject_kv(self, hashes: List[int], k_blocks, v_blocks) -> int:
        """:meth:`inject_kv_blocks` for block-major ``[N, L, ...]``
        payloads (the TKV2 layout, what :meth:`extract_kv` returns)."""
        if not hashes:
            return 0
        return self.inject_kv_blocks(
            list(hashes), _leaf_map(lambda t: t.transpose(0, 1), k_blocks),
            _leaf_map(lambda t: t.transpose(0, 1), v_blocks))

    def inject_from_core(self, src: "EngineCore", token_ids: List[int],
                         adapter: str = "") -> int:
        """Move the cached prefix pages of ``token_ids`` from another
        core's pool into this one, card to card with no host transit (one
        gather and one scatter a leaf). 0 when the two pools' page
        encodings or devices differ (the host relay re-encodes), when
        either sleeps, and when either is a job of several ranks (as in
        the JAX engine: the next rung serves the pull). Takes both cores'
        step locks in ``id()`` order."""
        if self._mh is not None or src._mh is not None:
            return 0
        if (src.config.kv_cache_dtype != self.config.kv_cache_dtype
                or src.device != self.device):
            return 0
        first, second = (src, self) if id(src) < id(self) else (self, src)
        with first._step_lock, second._step_lock:
            if self.kv is None or src.kv is None:
                return 0
            with src._lock:
                hashes, src_bids = src._cached_chain(token_ids, adapter)
            if not hashes:
                return 0

            def write(take, dst):
                sel = torch.tensor([src_bids[n] for n in take],
                                   dtype=torch.long, device=self.device)
                self._write_pages(dst, *(
                    _leaf_map(lambda t: t.index_select(1, sel).transpose(
                        0, 1), pages) for pages in src.kv))

            return self._install(hashes, write)

    # ------------------------------------------------------------------ #
    # request interface
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        self._thread.start()

    def warmup(self) -> None:
        """Run every serving program once on dummy rows (the JAX engine's
        shapes, in its order; module docstring), so that no first launch
        lands inside a user request. Between two steps, with the loop
        paused: every dummy slot is -1, so no page and no allocator state
        is touched, and what the dummy forwards move is put back. A
        failure raises."""
        t0 = time.perf_counter()
        with self._lock:
            self._pausing += 1
        try:
            with self._step_lock, torch.inference_mode():
                kept = (self.dispatch_count_total, self.dispatch_enqueue_s)
                self._dispatch("warmup", {"end": False}, [])
                variants = self._warmup_programs()
                self.warmup_launches = self._dispatch("warmup",
                                                      {"end": True}, [])
                self.dispatch_count_total, self.dispatch_enqueue_s = kept
        finally:
            with self._lock:
                self._pausing -= 1
                self._lock.notify_all()
        self.warmup_variants = variants
        self.warmup_seconds = time.perf_counter() - t0
        logger.info("Warmup ran %d prefill + %d decode + %d spec-verify + "
                    "%d draft variants in %.2f s", variants["prefill"],
                    variants["decode"], variants["spec"], variants["draft"],
                    self.warmup_seconds)

    def _warmup_programs(self) -> Dict[str, int]:
        """The warm-up's dispatches, each read back before the next;
        returns the count of each kind."""
        cfg = self.config
        B, maxb_all = cfg.max_num_seqs, cfg.max_blocks_per_seq

        def widths(start: int, cap: int):
            w = start
            while True:
                w = min(w, cap)
                yield w
                if w >= cap:
                    return
                w *= 2

        def prefill(R: int, bucket: int, maxb: int, cached: bool) -> None:
            a = _prefill_arrays(R, bucket, maxb, self._mask_row_bytes)
            a["positions"][:] = np.arange(bucket)
            a["context"][:] = a["seq_lens"][:] = min(bucket, 2)
            _Readback(self._dispatch("prefill", {"cached": cached},
                                     [a])).get()

        n_prefill = 0
        buckets = cfg.prefill_buckets()
        chunk_bucket = None
        if cfg.prefill_chunk_size:
            chunk_bucket = cfg.bucket_for(min(cfg.prefill_chunk_size,
                                              cfg.max_model_len))
            buckets = [b for b in buckets if b <= chunk_bucket]
        for bucket in buckets:
            # Plain prefill sees context == span: one tight table width;
            # a cached one any width from there up.
            blocks = -(-bucket // cfg.block_size)
            tight = 4
            while tight < blocks:
                tight *= 2
            tight = min(tight, maxb_all)
            prefill(1, bucket, tight, cached=False)
            n_prefill += 1
            for maxb in widths(tight, maxb_all):
                prefill(1, bucket, maxb, cached=True)
                n_prefill += 1
        if cfg.prefill_batch > 1 and chunk_bucket is not None:
            for maxb in widths(4, self._prefill_batch_maxb()):
                prefill(cfg.prefill_batch, chunk_bucket, maxb, cached=True)
                n_prefill += 1

        K_full = max(cfg.decode_steps, 1)
        bursts = {K_full}
        if cfg.decode_steps_pressure > 0:
            bursts.add(min(K_full, max(cfg.decode_steps_pressure, 1)))
        n_decode = 0
        for K in sorted(bursts):
            for maxb in widths(4, maxb_all):
                self._launch_burst(
                    K, False, np.ones((B,), bool),  # reset_counts
                    np.zeros((B,), np.int64), np.zeros((B,), np.int64),
                    np.ones((B,), bool), np.zeros((B,), np.int64),
                    np.full((B, K), -1, np.int64),
                    np.zeros((B, maxb), np.int32), np.ones((B,), np.int64),
                    np.zeros((B,), np.int64), np.zeros((B,), np.float32),
                    np.zeros((B,), np.int64), np.ones((B,), np.float32),
                    np.zeros((B,), np.int64), np.zeros((B,), np.float32),
                    np.zeros((B,), np.float32), np.zeros((B,), np.int64),
                    np.zeros((B,), np.int64), [None] * B, [None] * B,
                    np.zeros((B, self._mask_row_bytes), np.uint8),
                    np.zeros((B,), bool)).get()
                n_decode += 1

        n_spec = 0
        Ks = cfg.speculative_num_tokens
        if Ks > 0:
            for maxb in widths(4, maxb_all):
                self._launch_verify(
                    Ks, np.zeros((B, Ks), np.int64), np.zeros((B,), np.int64),
                    np.full((B, Ks), -1, np.int64),
                    np.zeros((B, maxb), np.int32), np.ones((B,), np.int64),
                    np.zeros((B,), np.int64), np.zeros((B,), np.float32),
                    np.zeros((B,), np.int64), np.ones((B,), np.float32),
                    np.zeros((B,), np.int64), np.zeros((B,), np.int64),
                    np.zeros((B,), np.int64), [None] * B, [None] * B,
                    np.zeros((B, Ks, self._mask_row_bytes), np.uint8),
                    np.zeros((B, Ks), bool)).get()
                n_spec += 1
        n_draft = (self._draft.warmup(self._mask_row_bytes)
                   if self._draft is not None else 0)
        return {"prefill": n_prefill, "decode": n_decode, "spec": n_spec,
                "draft": n_draft}

    def add_request(
        self,
        request_id: str,
        prompt_token_ids: List[int],
        sampling: SamplingParams,
        on_token: Callable[[Optional[int], Optional[str]], None],
        adapter_name: Optional[str] = None,
        trace=None,
        priority: int = 0,
    ) -> None:
        adapter_id = self.lora_slots.get(adapter_name or "", 0)
        structured = None
        if sampling.structured is not None:
            try:
                structured = FSMState(
                    self._structured_fsm(sampling.structured))
            except Exception:  # noqa: BLE001 - the server compiles first
                logger.exception(
                    "Structured constraint failed to compile for %s",
                    request_id)
                on_token(None, "error")
                return
            self.structured_requests_total += 1
        req = EngineRequest(
            request_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            sampling=sampling,
            on_token=on_token,
            adapter_id=adapter_id,
            adapter_name=(adapter_name or "") if adapter_id else "",
            priority=priority,
            trace=trace,
            structured=structured,
        )
        with self._lock:
            if self.fatal_error is not None:
                on_token(None, "error")
                return
            self.scheduler.add(req)
            self._lock.notify()

    def _structured_fsm(self, spec):
        """The compiled token FSM of a StructuredSpec, LRU-cached by
        (spec hash, tokenizer key)."""
        tok = self.tokenizer
        tok_key = "%s-%d-%s" % (type(tok).__name__,
                                self.model_config.vocab_size,
                                self.config.model)
        eos = getattr(tok, "eos_token_id", None)
        return self._structured_cache.get(
            spec.kind, spec.spec, tok, tok_key,
            self.model_config.vocab_size,
            int(eos) if eos is not None else None,
            lambda: compile_char_dfa(spec))

    def _fill_mask_row(self, mask_bits: np.ndarray, mask_on: np.ndarray,
                       i: int, req: EngineRequest) -> None:
        """Row ``i``'s FSM mask from the request's CURRENT automaton
        state; unconstrained and dead-latched rows stay all off (their
        logits pass through)."""
        st = req.structured
        if st is None or not st.masking:
            return
        mask_bits[i, :] = st.mask_row()
        mask_on[i] = True

    def abort_request(self, request_id: str) -> bool:
        with self._lock:
            return self.scheduler.abort(request_id)

    @contextlib.contextmanager
    def between_steps(self):
        """Hold the engine between two steps with the card drained: inside,
        the engine's thread launches nothing and nothing of it is queued
        on the device. ``POST /debug/profile`` switches its profiler on
        and off in here, because CUPTI can crash the process when it
        (un)registers its launch callbacks under a thread that launches."""
        with self._lock:
            self._pausing += 1
        try:
            with self._step_lock:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                yield
        finally:
            with self._lock:
                self._pausing -= 1
                self._lock.notify_all()

    def stop(self) -> None:
        """Stop the engine thread; a tensor-parallel leader then stops its
        followers' replay (the job's op channel stays open). A second call
        does nothing."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._running = False
            self._lock.notify()
        if self._thread.ident is not None:  # started
            self._thread.join(timeout=30)
        if self.offload is not None:
            self.offload.close()
        if self._mh is not None and self._mh.is_leader:
            self._mh.on_lost = None
            if self.fatal_error is None:
                with self._mh.lock:
                    self._mh.channel.send(("stop", {}, []))

    # ------------------------------------------------------------------ #
    # sleep mode, LoRA hot-swap, embeddings
    # ------------------------------------------------------------------ #
    def sleep(self, level: int = 1) -> None:
        """Free the device: preempt every sequence, spill every cached
        prefix block to the offload tier (when one is configured, so a
        prefix hit after the wake-up is restored instead of recomputed),
        clear all prefix state, then copy the parameters to pinned host
        memory and drop them and the KV pool from the device (a speculative
        drafter's weights and pages stay, as in the JAX engine). In a job
        of several ranks the device part is the ``sleep`` op: every rank
        stages its own parameters and drops its own pool. Every ``level``
        does the same, as in the JAX engine. A no-op when asleep."""
        with self._lifecycle_lock:
            with self._lock:
                if self._sleeping:
                    return
                # From here the loop takes no step (it waits, or flushes
                # the burst in flight), so the step lock comes free.
                self._sleeping = True
            self._sleep_device()
        logger.info("Engine asleep (level %d): device memory released", level)

    def _sleep_device(self) -> None:
        with self._step_lock:  # wait out the step in flight
            self._flush_pending_prefills()
            self._flush_pending_burst()
            with self._lock:
                # Preempt everything (mid-prefill chunked prompts too: their
                # pages go with the pool), so the wake-up re-prefills.
                while self.scheduler.running() or self.scheduler.prefilling:
                    self.scheduler.preempt_victim()
                alloc = self.kv_mgr.allocator
                if self.offload is not None:
                    self._pending_offload.extend(alloc.prefix_map.items())
            self._drain_offload()
            with self._lock:
                # Then drop every prefix registration: a cached hash left
                # behind would hit the zeroed pages of the wake-up's pool.
                alloc.prefix_map.clear()
                for blk in alloc.blocks:
                    blk.prefix_hash = None
                    blk.token_count = 0
                    blk.ref_count = 0
                alloc.free_ids = list(range(alloc.num_blocks))
            self._last_burst_tokens = None
            self._dispatch("sleep", {}, [])

    def _sleep_op(self) -> None:
        """This rank's weights to pinned host memory; its weights and pool
        leave the device (``sleep_freed_bytes``), and its allocator's
        cache goes back to the card."""
        if self._copy_stream is not None:
            # The spills' copies read pages that are about to go.
            self._copy_stream.synchronize()
        host = _tree_map(self._to_host, self.params)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        freed = sum(t.numel() * t.element_size()
                    for t in _leaves((self.params, self.kv)))
        with self._lock:
            self._host_params = host
            self.params = None
            self.kv = None
            self._sleeping = True
        self.sleep_freed_bytes = freed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A device tensor's copy in pinned host memory, enqueued on the
        engine's stream (the caller synchronizes); a CPU tensor as is."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def wake_up(self) -> None:
        """Copy the parameters back from pinned host memory and allocate a
        fresh (zero) KV pool, on every rank (the ``wake`` op). A no-op
        when awake."""
        with self._lifecycle_lock, self._step_lock:
            with self._lock:
                if not self._sleeping:
                    return
            self._dispatch("wake", {}, [])
            with self._lock:
                self._lock.notify()
        logger.info("Engine awake: weights restored, KV reallocated")

    def _wake_op(self) -> None:
        params = _tree_map(
            lambda t: t.to(self.device, non_blocking=True),
            self._host_params)
        kv = (self._alloc_pages(), self._alloc_pages())
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self.params = params
            self.kv = kv
            self._host_params = None
            self._sleeping = False

    @property
    def is_sleeping(self) -> bool:
        return self._sleeping

    def load_lora_adapter(self, name: str, rank: Optional[int] = None,
                          weights: Optional[dict] = None,
                          alpha: float = 16.0) -> bool:
        """Install an adapter into a free LoRA slot. ``weights`` may carry
        ``wq_a``/``wq_b``/``wv_a``/``wv_b`` (each ``[L, ...]`` of the slot,
        arrays or tensors); without weights the A matrices are drawn as
        ``0.01 * normal(key(crc32(name) % 2^31), [L, Hd, R])`` with the
        JAX engine's threefry (one key for both). The rank is clamped to
        ``max_lora_rank``; the slot's scaling becomes ``alpha / rank``.
        The slot is written in place on the device between forwards.
        False when the engine has no LoRA slots, sleeps, or has no free
        slot; True when the name is loaded already."""
        rank = min(rank or self.config.max_lora_rank,
                   self.config.max_lora_rank)
        with self._step_lock, self._lock:
            if self.params is None or "lora" not in self.params:
                return False
            if name in self.lora_slots:
                return True
            used = set(self.lora_slots.values())
            free = [s for s in range(1, self.config.max_loras)
                    if s not in used]
            if not free:
                return False
            slot = free[0]
            if weights is not None:
                weights = {k: (w if isinstance(w, torch.Tensor)
                               else torch.from_numpy(np.asarray(w)))
                           for k, w in weights.items()}
            self._dispatch("lora_load", {"slot": slot, "name": name,
                                         "scaling": alpha / rank},
                           [weights])
            self.lora_slots[name] = slot
        logger.info("Loaded LoRA adapter %s into slot %d", name, slot)
        return True

    def _lora_load_op(self, slot: int, name: str, scaling: float,
                      weights: Optional[dict]) -> None:
        """Write LoRA slot ``slot`` in place: the given (whole) matrices,
        of which a rank keeps its stage's layers and its slice of the B
        matrices, or the name-drawn A matrices (the same whole draw on
        every rank, of which a stage keeps its layers)."""
        lora = self.params["lora"]
        shape = self.layout.shape
        with torch.inference_mode():
            if weights is not None:
                for key in ("wq_a", "wq_b", "wv_a", "wv_b"):
                    if key in weights:
                        # [L, ...] of the slot: the rule of the [L, S, ...]
                        # leaf counts its axes from the end.
                        w = slice_leaf(("lora", key), weights[key],
                                       self.model_config, self.tp_rank,
                                       shape["tp"], self.stage, shape["pp"])
                        lora[key][:, slot].copy_(w)
            else:
                seed = zlib.crc32(name.encode()) % (2 ** 31)
                L, lo, hi = (self.model_config.num_layers, self.layers.start,
                             self.layers.stop)
                for key in ("wq_a", "wv_a"):
                    _, _, Hd, R = lora[key].shape
                    draw = prng.normal(
                        prng.key(seed, device=self.device), (L, Hd, R))
                    lora[key][:, slot].copy_(
                        (0.01 * draw[lo:hi]).to(lora[key].dtype))
            lora["scaling"][slot] = scaling

    def unload_lora_adapter(self, name: str) -> bool:
        """Free an adapter's slot (its scaling set to 0). False when the
        name is not loaded, or while asleep (the weights are on the
        host)."""
        with self._step_lock, self._lock:
            if name not in self.lora_slots:
                return False
            if self.params is None:
                return False
            slot = self.lora_slots.pop(name)
            self._dispatch("lora_unload", {"slot": slot}, [])
        logger.info("Unloaded LoRA adapter %s (slot %d)", name, slot)
        return True

    def embed(self, prompt_token_ids: List[int]) -> List[float]:
        """Mean-pooled, L2-normalised final hidden states of one prefill
        over the (clamped, bucket-capped) ids: what ``/v1/embeddings``
        serves. Runs off the scheduler path on a throwaway one-page pool
        whose writes are dropped (every slot -1); the serving pool is
        untouched. Raises RuntimeError while asleep."""
        cfg, mc = self.config, self.model_config
        ids = np.clip(np.asarray(prompt_token_ids, np.int64), 0,
                      mc.vocab_size - 1)[: cfg.max_model_len - 1]
        n = max(len(ids), 1)
        bucket = cfg.bucket_for(min(n, cfg.prefill_chunk_size or n))
        n = min(n, bucket)
        token_ids = np.zeros((1, bucket), np.int64)
        token_ids[0, :n] = ids[:n]
        with self._lifecycle_lock:  # no sleep() while the forward runs
            if self.params is None:
                raise RuntimeError("engine is sleeping")
            out = self._dispatch("embed", {"n": n}, [token_ids])
        return out[0].cpu().tolist()

    def _embed_op(self, n: int, token_ids: np.ndarray) -> torch.Tensor:
        """The pooled, normalised ``[1, Hd]`` float32 hidden states of one
        prefill of ``token_ids [1, bucket]`` (``n`` real tokens)."""
        mc, bs = self.model_config, self.config.block_size
        dev = self.device
        bucket = token_ids.shape[1]

        def t(x):
            return to_device(torch.from_numpy(x), dev)

        shape = (len(self.layers), 1, bs, self.kv_heads, mc.head_dim)
        kv = (torch.zeros(shape, dtype=mc.torch_dtype, device=dev),
              torch.zeros(shape, dtype=mc.torch_dtype, device=dev))
        seq_lens = t(np.asarray([n], np.int32))
        with torch.inference_mode():
            hidden, _ = self._apply(
                self.params, mc, t(token_ids),
                t(np.arange(bucket, dtype=np.int64)[None, :]), kv,
                torch.full((1, bucket), -1, dtype=torch.long),
                t(np.zeros((1, 4), np.int32)), seq_lens, seq_lens,
                mode="prefill", output_hidden=True, tp=self._tp)
            mask = (torch.arange(bucket, device=dev)[None, :]
                    < seq_lens[:, None]).float()
            pooled = (hidden * mask[..., None]).sum(dim=1) / torch.clamp(
                seq_lens.float(), min=1.0)[:, None]
            norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
            return pooled / torch.clamp(norm, min=1e-12)

    def kv_never_fits(self, n_tokens: int) -> bool:
        """True when a prompt (+1-token decode headroom) needs more pages
        than the whole pool holds."""
        bs = self.config.block_size
        return (n_tokens + 1 + bs - 1) // bs > self.num_blocks

    def stats(self) -> dict:
        alloc = self.kv_mgr.allocator
        budget = (self.scheduler.token_budget
                  if self.scheduler.chunked_prefill else 0)
        rec = self.step_recorder
        offload = self.offload.stats() if self.offload else None
        return {
            # Mid-prefill chunked sequences count as running: they hold KV
            # pages and will take a slot.
            "num_requests_running": (
                self.scheduler.num_running + len(self.scheduler.prefilling)),
            "num_requests_waiting": self.scheduler.num_waiting,
            "kv_usage": self.kv_mgr.usage(),
            "prefix_cache_hits": alloc.prefix_hits,
            "prefix_cache_queries": alloc.prefix_queries,
            "prompt_tokens_total": self.prompt_tokens_total,
            "cached_tokens_total": self.cached_tokens_total,
            "generation_tokens_total": self.generation_tokens_total,
            "offload": offload,
            # Pages allocated on the card, and blocks in the offload tier
            # (host RAM; 0 without a tier).
            "kv_page_occupancy": {
                "resident": self.num_blocks - alloc.num_free,
                "offload": offload["blocks"] if offload else 0},
            "prefix_evicts_total": self.prefix_evicts_total,
            "evict_listener_errors_total": self.evict_listener_errors_total,
            "requests_finished_total": self.requests_finished_total,
            "num_preempted_total": self.scheduler.num_preempted_total,
            "num_blocks": self.num_blocks,
            "hbm_headroom_bytes": self.hbm_headroom_bytes,
            "kv_cache_dtype": self.config.kv_cache_dtype,
            # The model's KV bytes a token over all ranks, the JAX
            # engine's figure (a rank holds its heads' share).
            "kv_cache_bytes_per_token": (
                kv_bytes_per_block(self.model_config, self.config.block_size,
                                   self.config.kv_cache_dtype)
                // self.config.block_size),
            "tensor_parallel": {
                "size": self.layout.shape["tp"],
                "backend": self._tp.backend if self._tp else None,
                "devices": [str(d) for d in self.layout.devices],
                "kv_heads_per_rank": self.kv_heads},
            "pipeline_parallel": {
                "size": self.layout.shape["pp"],
                "microbatches": (self.config.pp_microbatches
                                 or self.layout.shape["pp"]),
                "backend": self._pp.backend if self._pp else None,
                "layers_per_stage": len(self.layers)},
            "data_parallel": {"size": self.layout.shape["dp"]},
            "mesh": dict(self.layout.shape),
            "fatal_error": self.fatal_error,
            "is_sleeping": self._sleeping,
            "prefill_time_total": round(self.prefill_time_total, 3),
            "decode_time_total": round(self.decode_time_total, 3),
            "flush_time_total": round(self.flush_time_total, 3),
            "prefill_count": self.prefill_count,
            "prefill_group_count": self.prefill_group_count,
            "prefill_group_rows": self.prefill_group_rows,
            "prefill_batched_dispatch_total":
                self.prefill_batched_dispatch_total,
            "prefill_chunks_total": self.prefill_chunks_total,
            "deferred_prefill_tokens_total":
                self.deferred_prefill_tokens_total,
            "batched_token_utilization": (
                min(self.last_step_batched_tokens / budget, 1.0)
                if budget > 0 else 0.0),
            "rejected_requests": dict(self.scheduler.rejected_total),
            "preempted_by_priority":
                dict(self.scheduler.preempted_by_priority),
            "pool_shrink_retries_total": self.pool_shrink_retries_total,
            "prefill_attention_dispatch_total":
                dict(self.prefill_attention_dispatch_total),
            "decode_burst_count": self.decode_burst_count,
            "fused_steps_total": self.fused_steps_total,
            "dispatch_count_total": self.dispatch_count_total,
            "dispatch_enqueue_s": round(self.dispatch_enqueue_s, 3),
            "decode_forward_steps_total": self.decode_forward_steps_total,
            "spec_proposed_tokens_total": self.spec_proposed_tokens_total,
            "spec_accepted_tokens_total": self.spec_accepted_tokens_total,
            "spec_proposed_by_source": dict(self.spec_proposed_by_source),
            "spec_accepted_by_source": dict(self.spec_accepted_by_source),
            "spec_draft_forward_steps_total":
                self.spec_draft_forward_steps_total,
            "spec_disabled_requests_total": self.spec_disabled_requests_total,
            "spec_verify_bursts_total": self.spec_verify_bursts_total,
            "structured_requests_total": self.structured_requests_total,
            "structured_compile_seconds_total": round(
                self._structured_cache.compile_seconds_total, 6),
            "structured_mask_states_total":
                self._structured_cache.mask_states_total,
            "structured_violations_total": self.structured_violations_total,
            "structured_cache_entries": len(self._structured_cache),
            "step_records_total": rec.recorded_total if rec else 0,
            "step_kind_stats": rec.kind_stats() if rec else {},
            "model_bandwidth_utilization": (
                round(rec.bandwidth_utilization(), 6) if rec else 0.0),
            "warmup_variants": dict(self.warmup_variants),
            "warmup_seconds": self.warmup_seconds,
        }

    # ------------------------------------------------------------------ #
    # engine loop
    # ------------------------------------------------------------------ #
    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._running and (
                        self._pausing
                        or (self._pending_burst is None
                            and (self._sleeping
                                 or not self.scheduler.has_work()))):
                    self._lock.wait(timeout=0.1)
                if not self._running:
                    return
                action, req = self.scheduler.next_action()
            self._step_info = None  # never carry info across a failed step
            self._step_reqs = []
            try:
                with self._step_lock, torch.inference_mode():
                    if self._sleeping or self.params is None:
                        # sleep() won the race after next_action took a
                        # request: it waits for the wake-up.
                        self._flush_pending_burst()
                        if action == "prefill" and req is not None:
                            with self._lock:
                                self.scheduler.requeue(req)
                        continue
                    if action in ("prefill", "prefill_step"):
                        t0 = time.perf_counter()
                        if action == "prefill":
                            self._do_prefill(req)
                        else:
                            self._do_prefill_step(req)
                        dt = time.perf_counter() - t0
                        self.prefill_time_total += dt
                        self.prefill_count += 1
                        self._record_step(dt)
                    elif action == "fused":
                        t0 = time.perf_counter()
                        self._do_fused(req)
                        # Each leg's time joins its own split inside
                        # _do_fused; the step record takes the whole.
                        self._record_step(time.perf_counter() - t0)
                    elif action == "decode":
                        t0 = time.perf_counter()
                        self._do_decode()
                        dt = time.perf_counter() - t0
                        self.decode_time_total += dt
                        self.decode_burst_count += 1
                        self._record_step(dt)
                    else:
                        self._flush_pending_prefills()
                        self._flush_pending_burst()
                        time.sleep(0.001)
            except Exception as e:  # noqa: BLE001 - the loop must keep serving
                # A failed step fails the requests it carried: the client
                # sees finish_reason "error" instead of hanging.
                logger.exception("Engine step failed: %s", e)
                self._fail_step(action, req)
                if self._mh is not None:
                    # The ranks may have run different parts of the step:
                    # their pools and counts can no longer be trusted.
                    self._fatal(f"a sharded step failed: {e!r}")

    def _fail_step(self, action: str, req) -> None:
        """Finish the requests of a step that raised with "error": a
        prefill's request and the storm-group members it took from the
        queue, a step plan's members, or (decode) every running sequence,
        with the burst and first tokens in flight dropped; a fused step
        both its plan's members and every running sequence."""
        self._fused_capture = None
        if action in ("prefill_step", "fused"):
            reqs = [pc.req for pc in (req or [])]
        elif action == "prefill" and req is not None:
            reqs = [req] + self._step_reqs
        else:
            reqs = []
        # Pages evicted by the failed step are dropped, not spilled: a
        # forward of it may have written them already.
        self._pending_offload = []
        with self._lock:
            for r in reqs:
                seq = self.scheduler._running_by_id.get(r.request_id)
                if seq is not None:
                    self.scheduler.finish(seq, "error")
                    continue
                if r.request_id in self.scheduler._queued:
                    continue  # requeued within the step: it runs again
                if r in self.scheduler.prefilling:
                    self.scheduler.prefilling.remove(r)
                self.kv_mgr.free(r.request_id)
                # An aborted request has had its finish already.
                if self.scheduler._requests.pop(r.request_id, None):
                    r.on_token(None, "error")
            if action in ("decode", "fused"):
                self._pending_burst = None
                self._pending_prefills = []
                for seq in self.scheduler.running():
                    self.scheduler.finish(seq, "error")

    def _record_step(self, wall_s: float) -> None:
        """Complete the record the step stashed (if any) with the wall time
        _loop measured around it; nothing when the recorder is off or the
        step dispatched nothing."""
        rec, info = self.step_recorder, self._step_info
        self._step_info = None
        if rec is None or info is None:
            return
        if rec.param_bytes == 0 and self.params is not None:
            rec.param_bytes = sum(t.numel() * t.element_size()
                                  for t in _leaves(self.params))
        rec.record(info.pop("kind"), wall_s, **info)

    # ------------------------------------------------------------------ #
    # the device-op chokepoint (tensor-parallel lockstep)
    # ------------------------------------------------------------------ #
    # Every serving-time op that launches work on the device or writes
    # device state goes through _dispatch: on one rank it just executes;
    # a tensor-parallel leader first sends the op (name, static values,
    # host arrays) to the followers, and every rank then runs the same
    # _exec_op, so the ranks launch the same kernels and collectives in
    # the same order. Device state (weights, pages, counts, the burst's
    # feedback tokens) stays on each rank.

    def _dispatch(self, name: str, static: dict, arrays: list):
        cap = self._fused_capture
        if cap is not None:
            if name in ("prefill", "decode"):
                # A fused step is being built: capture the op; _do_fused
                # launches the pair as ONE "fused" dispatch.
                ph = _FusedPlaceholder()
                cap.append((name, static, arrays, ph))
                return ph
            # An op the fused dispatch does not carry arrived mid-capture.
            # Op order is the contract: stop capturing, launch what was
            # captured one op at a time, then this op.
            self._fused_capture = None
            self._drain_captured(cap)
        mhc = self._mh
        t0 = time.perf_counter()
        try:
            if mhc is None:
                return self._exec_op(name, static, arrays)
            # (send, launch) atomic: one op order on every rank.
            with mhc.lock:
                if self.fatal_error is not None:
                    raise RuntimeError(self.fatal_error)
                try:
                    mhc.channel.send((name, static, arrays))
                except OSError as e:
                    # A partial fan-out (one follower's socket dead,
                    # others fed) cannot be resumed: the ranks' op
                    # streams differ.
                    self._fatal(f"op-channel send failed ({e!r}); the "
                                f"ranks' lockstep is broken")
                    raise RuntimeError(self.fatal_error) from e
                return self._exec_op(name, static, arrays)
        finally:
            # The engine thread's seconds launching work (readback waits
            # count in flush_time_total).
            self.dispatch_count_total += 1
            self.dispatch_enqueue_s += time.perf_counter() - t0

    def _drain_captured(self, cap: list) -> None:
        """Launch captured ops one dispatch each, in capture order (the
        degraded path: the capture was aborted, or a leg launched
        nothing). A failure poisons every placeholder still open, so no
        deferred readback waits forever, and is raised."""
        err = None
        for name, static, arrays, ph in cap:
            if ph.ready:
                continue
            if err is None:
                try:
                    out = self._dispatch(name, static, arrays)
                except Exception as e:  # noqa: BLE001 - re-raised below
                    err = e
                    ph.settle(error=e)
                    continue
                ph.settle(out)
            else:
                ph.settle(error=err)
        if err is not None:
            raise err

    def _abort_fused_capture(self) -> None:
        """Leave capture mode and launch what was captured. The spec and
        structured paths call it before they read back: their drafts and
        masks need the tokens a captured prefill has not produced."""
        cap = self._fused_capture
        if cap is None:
            return
        self._fused_capture = None
        self._drain_captured(cap)

    def _exec_op(self, name: str, static: dict, arrays: list):
        """What each op does on the device; the leader and the followers
        both run exactly this. Returns the op's device outputs."""
        self.ops_total += 1
        if name == "prefill":
            out = self._prefill_op(static["cached"], arrays[0])
        elif name == "decode":
            out = self._decode_op(static["K"], static["use_prev"], *arrays)
        elif name == "spec_verify":
            out = self._verify_op(static["K"], *arrays)
        elif name == "fused":
            # One dispatch, its constituent ops run back to back through
            # this same method: the followers replay it unchanged.
            outs, off = [], 0
            for n_i, s_i, c_i in zip(static["names"], static["statics"],
                                     static["counts"]):
                outs.append(self._exec_op(n_i, s_i, arrays[off:off + c_i]))
                off += c_i
            return outs
        elif name == "embed":
            return self._embed_op(static["n"], arrays[0])
        elif name == "set_counts_row":
            self._token_counts[static["slot"]] = to_device(arrays[0],
                                                           self.device)
            return None
        elif name == "lora_load":
            return self._lora_load_op(static["slot"], static["name"],
                                      static["scaling"], arrays[0])
        elif name == "lora_unload":
            self.params["lora"]["scaling"][static["slot"]] = 0.0
            return None
        elif name == "write_pages":
            return self._write_pages_op(*arrays)
        elif name == "gather_pages":
            return self._gather_pages_op(arrays[0])
        elif name == "offload_blocks":
            return self._offload_blocks_op(static["hashes"], arrays[0])
        elif name == "restore_blocks":
            return self._restore_blocks_op(static["hashes"], arrays[0])
        elif name == "sleep":
            return self._sleep_op()
        elif name == "wake":
            return self._wake_op()
        elif name == "rank_stats":
            return self._rank_stats_op(**static)
        elif name == "warmup":
            return self._warmup_op(static["end"])
        else:
            raise ValueError(f"unknown device op {name!r}")
        if self.sampled_log is not None:
            self.sampled_log.append((name, out[0].cpu().numpy()))
        return out

    def run_follower(self) -> None:
        """The loop of a follower rank (rank > 0): replay the leader's op
        stream until it stops. A follower runs no scheduler and serves no
        HTTP. An op that fails cannot be resumed (this rank's pages or
        counts may differ from the leader's), so the error propagates and
        the process exits; the leader's next collective or send fails."""
        if self._mh is None or self._mh.is_leader:
            raise RuntimeError("run_follower is for follower ranks")
        logger.info("Follower rank %d/%d: replaying the leader's ops",
                    self.rank, self._mh.num_processes)
        with torch.inference_mode():
            while True:
                name, static, arrays = self._mh.channel.recv()
                if name == "stop":
                    logger.info("Follower rank %d: leader stopped",
                                self.rank)
                    return
                self._exec_op(name, static, arrays)

    def rank_stats(self, reset: bool = False,
                   timing: Optional[bool] = None,
                   profile: Optional[bool] = None) -> List[dict]:
        """Every rank's coordinates, device, layers, weight bytes, pool
        blocks, ops executed, kernel launches by shape, collective and
        point-to-point counters, its offload store's hashes (least
        recently used first),
        the bytes its last sleep freed and its KV gathers' copy and gloo
        seconds, gathered on the leader (an op like any other, ordered
        with the steps). ``reset`` zeroes the launch, collective and
        transfer and gather counters afterwards; ``timing`` switches the collectives'
        and transfers' synchronized timing on or off. ``profile=True``
        starts a device profiler on every rank (a card's), and
        ``profile=False`` stops it and reports each rank's kernel time
        since (``device_busy_s``): every stage's own busy time."""
        with self._step_lock:
            return self._dispatch("rank_stats",
                                  {"reset": reset, "timing": timing,
                                   "profile": profile}, [])

    def _rank_stats_op(self, reset: bool, timing: Optional[bool],
                       profile: Optional[bool] = None):
        from production_stack_tpu_torch.ops.paged_attention import (
            paged_attention,
        )
        from production_stack_tpu_torch.ops.prefill_attention import (
            cached_prefill_attention,
        )

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        kernels = (paged_attention, cached_prefill_attention)
        tpg, ppg = self._tp, self._pp
        dp, stage, tp_rank = self.layout.coords(self.rank)
        mine = {
            "rank": self.rank, "dp": dp, "pp": stage, "tp": tp_rank,
            "layers": [self.layers.start, self.layers.stop],
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in _leaves(self.params)),
            "kv_pool_bytes": sum(t.numel() * t.element_size()
                                 for side in (self.kv or ())
                                 for t in _leaves_of(side)),
            "num_blocks": self.num_blocks, "kv_heads": self.kv_heads,
            "offload_keys": (self.offload.keys() if self.offload is not None
                             else None),
            "sleep_freed_bytes": self.sleep_freed_bytes,
            "kv_gathers_total": self.kv_gathers_total,
            "kv_gather_copy_s": self.kv_gather_copy_s,
            "kv_gather_gloo_s": self.kv_gather_gloo_s,
            "launches_by_shape": {k.__name__: dict(k.launches_by_shape)
                                  for k in kernels},
            "ops_total": self.ops_total,
            "collectives_total": tpg.collectives_total if tpg else 0,
            "collective_s": tpg.collective_s if tpg else 0.0,
            "p2p": ppg.counters() if ppg else None,
            "device_busy_s": None,
        }
        if profile is False and self._rank_prof is not None:
            from torch.autograd import DeviceType

            self._rank_prof.__exit__(None, None, None)
            mine["device_busy_s"] = sum(
                getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)
                for e in self._rank_prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e6
            self._rank_prof = None
        if profile and self.device.type == "cuda":
            from torch.profiler import ProfilerActivity

            self._rank_prof = torch.profiler.profile(
                activities=[ProfilerActivity.CUDA])
            self._rank_prof.__enter__()
        if reset:
            for k in kernels:
                k.launches_by_shape.clear()
            self.kv_gathers_total = 0
            self.kv_gather_copy_s = self.kv_gather_gloo_s = 0.0
            if tpg is not None:
                tpg.collectives_total, tpg.collective_s = 0, 0.0
            if ppg is not None:
                ppg.reset_counters()
        if timing is not None:
            for g in (tpg, ppg):
                if g is not None:
                    g.timing = timing
        if self._mh is None:
            return [mine]
        out: List = [None] * self._mh.num_processes
        torch.distributed.all_gather_object(out, mine)
        return out

    def _warmup_op(self, end: bool) -> Optional[Dict[str, int]]:
        """Each rank's bracket of a warm-up. At its start, stash what the
        dummy forwards move on this rank: the penalty counts (the bursts
        run with ``reset_counts`` set), the last burst's feedback tokens,
        the sampled-token log (paused), the kernels' launch counters
        (process-wide: warm an engine while no other of its process
        serves) and the collectives' and transfers' counters. At its end,
        put them back and return the kernel launches the warm-up made on
        this rank, by counter."""
        from production_stack_tpu_torch.ops.paged_attention import (
            paged_attention,
        )
        from production_stack_tpu_torch.ops.prefill_attention import (
            cached_prefill_attention,
        )

        counters = {f"{k.__name__}{suffix}": (k, attr)
                    for k in (paged_attention, cached_prefill_attention)
                    for suffix, attr in (("", "launches"),
                                         ("_int8", "launches_int8"))}
        if not end:
            groups = []
            if self._tp is not None:
                groups.append((self._tp, {
                    "collectives_total": self._tp.collectives_total,
                    "collective_s": self._tp.collective_s}))
            if self._pp is not None:
                groups.append((self._pp, self._pp.counters()))
            self._warmup_saved = {
                "counts": self._token_counts.clone(),
                "feedback": self._last_burst_tokens,
                "log": self.sampled_log,
                "launches": {n: getattr(*ka) for n, ka in counters.items()},
                "by_shape": [(k, dict(k.launches_by_shape))
                             for k in (paged_attention,
                                       cached_prefill_attention)],
                "groups": groups}
            self.sampled_log = None
            return None
        saved, self._warmup_saved = self._warmup_saved, None
        self._token_counts.copy_(saved["counts"])
        self._last_burst_tokens = saved["feedback"]
        self.sampled_log = saved["log"]
        made = {}
        for name, (k, attr) in counters.items():
            made[name] = getattr(k, attr) - saved["launches"][name]
            setattr(k, attr, saved["launches"][name])
        for k, by_shape in saved["by_shape"]:
            k.launches_by_shape.clear()
            k.launches_by_shape.update(by_shape)
        for group, values in saved["groups"]:
            for attr, value in values.items():
                setattr(group, attr, value)
        return made

    def _rank_lost(self, pid: int) -> None:
        """The op channel's watcher: follower ``pid`` is gone."""
        self._fatal(f"rank {pid} of the job is gone")

    def _fatal(self, why: str) -> None:
        """Latch an unrecoverable fault: every request fails with
        "error", the loop stops, and new requests fail at once."""
        if self.fatal_error is not None:
            return
        self.fatal_error = why
        logger.error("Engine stopped: %s", why)
        with self._lock:
            self._running = False
            for seq in list(self.scheduler.running()):
                self.scheduler.finish(seq, "error")
            # Waiting, mid-prefill and in-flight requests alike.
            for req in list(self.scheduler._requests.values()):
                self.scheduler._requests.pop(req.request_id, None)
                req.on_token(None, "error")
            self._lock.notify()

    # -- prefill -----------------------------------------------------------
    def _allocate_for_prefill(self, req: EngineRequest, limit=None):
        """KV allocation for one prompt (``limit`` bounds fresh allocation
        to the first chunk of a step plan), with the offload tier's
        restores and their miss fallback. Returns (block_ids, cached) or
        None after requeuing the request."""
        alloc = self.kv_mgr.allocate_prompt(
            req.request_id, req.all_token_ids, adapter=req.adapter_name,
            limit=limit)
        if alloc is None:
            # Pool tight: settle the burst in flight (its emission may
            # finish sequences and free pages), then retry once.
            self._flush_pending_burst()
            alloc = self.kv_mgr.allocate_prompt(
                req.request_id, req.all_token_ids, adapter=req.adapter_name,
                limit=limit)
        self._drain_offload()
        if alloc is None:
            with self._lock:
                self.scheduler.requeue(req)
            return None
        block_ids, cached, restores = alloc
        if restores and not self._restore_blocks(restores):
            # The tier lied (a remote block evicted between HEAD and GET):
            # recompute with the tier bypassed. The restore blocks were
            # registered before their pages were written: unregister them
            # so neither the retry nor another prompt reads them as cache.
            kv_alloc = self.kv_mgr.allocator
            with self._lock:
                for bid, h in restores:
                    if kv_alloc.prefix_map.get(h) == bid:
                        del kv_alloc.prefix_map[h]
                        kv_alloc.blocks[bid].prefix_hash = None
            self.kv_mgr.free(req.request_id)
            ext = self.kv_mgr.external_lookup
            self.kv_mgr.external_lookup = None
            try:
                alloc = self.kv_mgr.allocate_prompt(
                    req.request_id, req.all_token_ids,
                    adapter=req.adapter_name, limit=limit)
            finally:
                self.kv_mgr.external_lookup = ext
            self._drain_offload()
            if alloc is None:
                with self._lock:
                    self.scheduler.requeue(req)
                return None
            block_ids, cached, _ = alloc
        return block_ids, cached

    def _do_prefill(self, req: EngineRequest) -> None:
        """Allocate the prompt's pages (leading full blocks may come from
        the prefix cache), launch its uncached suffix in chunks, or, during
        a storm of long prompts, as one row of a batched prefill. The first
        token is read back at the next step (``_pending_prefills``): the
        chunks are launched before the burst in flight is read back, and
        the stream orders them after it."""
        cfg = self.config
        tokens = req.all_token_ids
        n = len(tokens)
        got = self._allocate_for_prefill(req)
        if got is None:
            return
        block_ids, cached = got
        if req.trace is not None:
            if not req.trace.prefill_start:
                req.trace.prefill_start = time.time()
            req.trace.cached_tokens = cached
            req.trace.preemptions = req.num_preemptions

        # Storm-scoped batching: a long uncached span rides one [PB,
        # chunk] dispatch with other waiting long prompts, but only while
        # enough of them wait (the arrival storm); contexts wider than
        # _prefill_batch_maxb() blocks stay on the single path.
        chunk = cfg.prefill_chunk_size
        if (cfg.prefill_batch > 1 and chunk > 0
                and n - cached >= max(chunk // 2, 1)
                and ((n + cfg.block_size - 1) // cfg.block_size
                     <= self._prefill_batch_maxb())
                and (self._qualifying_waiting()
                     >= cfg.prefill_batch_min_waiting)):
            group = self._gather_prefill_group(req, block_ids, cached)
            if len(group) > 1:
                self._do_prefill_group(group)
                return

        # Only the uncached suffix runs through the model, in chunks so
        # attention memory stays O(chunk * context).
        chunk = cfg.prefill_chunk_size or (n - cached)
        sampled = None
        start = cached
        while start < n:
            end = min(start + chunk, n)
            sampled = self._prefill_span(req, tokens, block_ids, start, end)
            self.prefill_chunks_total += 1
            start = end
        if self.step_recorder is not None:
            n_chunks = max(1, -(-(n - cached) // max(chunk, 1)))
            self._step_info = {
                "kind": "prefill", "rows": 1, "tokens": n - cached,
                "forwards": n_chunks,
                "kv_read_tokens": (n_chunks * cached
                                   + chunk * (n_chunks * (n_chunks - 1)) // 2),
                "kv_write_tokens": n - cached,
            }
        # Read back the burst in flight while the chunks run, then the
        # PREVIOUS prefill's first token (depth-1 pipelining).
        self._flush_pending_burst()
        self._flush_pending_prefills()
        self.prompt_tokens_total += n
        self.cached_tokens_total += cached
        # Reserve the slot now (next_action guaranteed a free one); the
        # first token lands before any decode burst is built.
        with self._lock:
            slot = self.scheduler._free_slot()
            seq = self.scheduler.start_running(req, slot)
        self._pending_prefills.append(
            {"req": req, "seq": seq, "slot": slot, "sampled": sampled})

    def _do_prefill_step(self, plan) -> None:
        """One budgeted chunked-prefill step plan: advance each member by
        one chunk. Several members' chunks share one batched [PB, chunk]
        dispatch when every row fits its block-table cap (consecutive
        chunks of ONE prompt never share one). Final chunks claim a decode
        slot and defer their first-token readback (_pending_prefills)."""
        cfg = self.config
        ready = []  # (req, tokens, block_ids, start, end)
        step_tokens = 0
        for pc in plan:
            req = pc.req
            with self._lock:
                if req not in self.scheduler.prefilling:
                    continue  # aborted after the plan was built
            tokens = req.all_token_ids
            n = len(tokens)
            if pc.start == 0:
                # First chunk: allocate its pages (the cached-prefix walk
                # is unbounded, so `cached` can pass the chunk).
                got = self._allocate_for_prefill(req, limit=pc.end)
                if got is None:
                    continue  # requeued
                block_ids, cached = got
                if req.trace is not None:
                    if not req.trace.prefill_start:
                        req.trace.prefill_start = time.time()
                    req.trace.cached_tokens = cached
                    req.trace.preemptions = req.num_preemptions
                self.cached_tokens_total += cached
                start = max(pc.start, cached)
                end = max(pc.end, cached)
                if start >= end or start >= n:
                    # Covered by the cache: no dispatch; the next step
                    # continues from the cached frontier.
                    with self._lock:
                        if req in self.scheduler.prefilling:
                            req.num_computed_tokens = min(max(end, start), n)
                    continue
            else:
                block_ids = self.kv_mgr.extend_tokens(
                    req.request_id, tokens, pc.end)
                if block_ids is None:
                    # Pool tight: settle the burst in flight and retry
                    # once, then give the pages back and requeue.
                    self._flush_pending_burst()
                    block_ids = self.kv_mgr.extend_tokens(
                        req.request_id, tokens, pc.end)
                # Pages the extension evicted spill before this chunk's
                # forward can overwrite them.
                self._drain_offload()
                if block_ids is None:
                    self.kv_mgr.free(req.request_id)
                    with self._lock:
                        self.scheduler.requeue(req)
                    continue
                start, end = pc.start, pc.end
            ready.append((req, tokens, block_ids, start, end))
            step_tokens += end - start

        if not ready:
            return
        sampled_for: Dict[int, tuple] = {}  # id(req) -> (readback, row)
        batched = (
            cfg.prefill_batch > 1 and cfg.prefill_chunk_size > 0
            and len(ready) > 1
            and all((end + cfg.block_size - 1) // cfg.block_size
                    <= self._prefill_batch_maxb()
                    for (_, _, _, _, end) in ready))
        if batched:
            sampled = self._prefill_rows(ready, pad_to=cfg.prefill_batch)
            for row_i, (req, *_rest) in enumerate(ready):
                sampled_for[id(req)] = (sampled, row_i)
        else:
            for req, tokens, block_ids, start, end in ready:
                sampled_for[id(req)] = (self._prefill_span(
                    req, tokens, block_ids, start, end), 0)
        self.prefill_chunks_total += len(ready)
        self.last_step_batched_tokens = step_tokens
        if self.step_recorder is not None:
            self._step_info = {
                "kind": "prefill_chunk", "rows": len(ready),
                "tokens": step_tokens,
                "forwards": 1 if batched else len(ready),
                # The cached-prefill kernel reads each row's whole context
                # from the pages, the chunk's own K/V included.
                "kv_read_tokens": sum(e for (_r, _t, _b, _s, e) in ready),
                "kv_write_tokens": step_tokens, "batched": batched,
            }

        # Read back the burst in flight and the previous prefill while
        # these chunks run.
        self._flush_pending_burst()
        self._flush_pending_prefills()

        now = time.time()
        for req, tokens, block_ids, start, end in ready:
            n = len(tokens)
            if req.trace is not None:
                req.trace.prefill_chunks += 1
            if end < n:
                self.deferred_prefill_tokens_total += n - end
                with self._lock:
                    if req in self.scheduler.prefilling:
                        req.num_computed_tokens = end
                continue
            # Final chunk: its sample is the request's first token. Claim
            # the decode slot now (admission kept one free per member).
            sampled, row = sampled_for[id(req)]
            with self._lock:
                if req not in self.scheduler.prefilling:
                    continue  # aborted while the chunk was in flight
                self.scheduler.prefilling.remove(req)
                req.num_computed_tokens = n
                slot = self.scheduler._free_slot()
                seq = self.scheduler.start_running(req, slot)
            if req.trace is not None:
                req.trace.prefill_end = now
            self.prompt_tokens_total += n
            self._pending_prefills.append(
                {"req": req, "seq": seq, "slot": slot,
                 "sampled": sampled, "row": row})

    def _do_fused(self, plan) -> None:
        """One scheduler "fused" action: the budgeted prefill step plan
        AND the decode burst as ONE dispatch. Both legs run their usual
        host-side code while :meth:`_dispatch` captures their device ops;
        the pair then goes out as a single "fused" op (the usual ops back
        to back: one launch call, one op-channel message). An op the
        fused dispatch does not carry ends the capture and the step
        degrades to the alternating dispatches; the streams are the same
        either way, only the dispatch counts differ. A failed fused
        dispatch poisons every placeholder of the pair (no readback waits
        forever) and raises."""
        self._fused_capture = cap = []
        info_p = info_d = None
        dt_p = dt_d = 0.0
        chunks0 = self.prefill_chunks_total
        forwards0 = self.decode_forward_steps_total
        try:
            t0 = time.perf_counter()
            self._do_prefill_step(plan)
            dt_p = time.perf_counter() - t0
            info_p, self._step_info = self._step_info, None
            t0 = time.perf_counter()
            self._do_decode()
            dt_d = time.perf_counter() - t0
            info_d, self._step_info = self._step_info, None
        finally:
            aborted = self._fused_capture is None
            self._fused_capture = None
            names = [c[0] for c in cap]
            fused = (not aborted and "prefill" in names
                     and names[-1] == "decode")
            if fused:
                try:
                    outs = self._dispatch("fused", {
                        "names": names,
                        "statics": [c[1] for c in cap],
                        "counts": [len(c[2]) for c in cap],
                    }, [a for c in cap for a in c[2]])
                except Exception as e:  # noqa: BLE001 - re-raised
                    for *_op, ph in cap:
                        if not ph.ready:
                            ph.settle(error=e)
                    raise
                for (*_op, ph), out in zip(cap, outs):
                    ph.settle(out)
                self.fused_steps_total += 1
            else:
                # Degraded (the capture ended early, or a leg launched
                # nothing): launch what is still captured one by one.
                self._drain_captured(cap)
        # Each leg's wall time joins its own split if it launched work.
        if self.prefill_chunks_total > chunks0:
            self.prefill_time_total += dt_p
            self.prefill_count += 1
        if self.decode_forward_steps_total > forwards0:
            self.decode_time_total += dt_d
            self.decode_burst_count += 1
        if self.step_recorder is None:
            return
        if fused and info_p is not None and info_d is not None:
            # _loop records it with the whole step's wall time.
            self._step_info = {
                "kind": "fused",
                **{k: info_p[k] + info_d[k] for k in (
                    "rows", "tokens", "forwards", "kv_read_tokens",
                    "kv_write_tokens")},
                "batched": info_p.get("batched", False)}
        else:
            # Degraded: each leg is recorded as the step it was.
            for info, dt in ((info_p, dt_p), (info_d, dt_d)):
                if info is not None:
                    self._step_info = info
                    self._record_step(dt)

    def _flush_pending_prefills(self) -> None:
        """Read back and emit deferred prefill first tokens, in dispatch
        order. Runs before a decode burst is built (its feedback and
        positions need each sequence's first token)."""
        if not self._pending_prefills:
            return
        pending, self._pending_prefills = self._pending_prefills, []
        keep: List[dict] = []
        t0 = time.perf_counter()
        for entry in pending:
            if not entry["sampled"].ready:
                # Captured for the fused dispatch being built: read back
                # after it launches. Such entries are the queue's tail
                # (captured this step), so emission keeps dispatch order.
                keep.append(entry)
                continue
            req, seq, slot = entry["req"], entry["seq"], entry["slot"]
            row_i = entry.get("row", 0)  # batched prefills: a row a request
            try:
                s_arr, lp_arr, top_lp_arr, top_id_arr = entry["sampled"].get()
            except Exception:  # noqa: BLE001 - asynchronous device failure
                # The readback failed after the dispatch succeeded: finish
                # the request instead of leaking its slot.
                logger.exception("Deferred prefill readback failed for %s",
                                 req.request_id)
                with self._lock:
                    if self.scheduler.slots[slot] is seq:
                        self.scheduler.finish(seq, "error")
                continue
            with self._lock:
                if self.scheduler.slots[slot] is not seq:
                    continue  # aborted/finished before its first token
            token = int(s_arr[row_i])
            lp = None
            if req.sampling.logprobs is not None:
                k = min(req.sampling.logprobs, top_lp_arr.shape[1])
                lp = {"logprob": float(lp_arr[row_i]),
                      "top": [(int(top_id_arr[row_i, j]),
                               float(top_lp_arr[row_i, j]))
                              for j in range(k)]}
            prior = req.output_token_ids
            if prior and (req.sampling.presence_penalty
                          or req.sampling.frequency_penalty):
                # Resume after preemption with penalties: rebuild the
                # slot's count row from the carried-forward outputs and
                # this token (the row may hold another request's counts).
                ids = torch.tensor(prior + [token], dtype=torch.long).clamp(
                    0, self.model_config.vocab_size - 1)
                row = torch.zeros((self.model_config.vocab_size,),
                                  dtype=torch.int32)
                row.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                self._dispatch("set_counts_row", {"slot": slot}, [row])
                with self._lock:
                    self._counts_reset.discard(slot)
            else:
                with self._lock:
                    # Fresh output in this slot: its counts reset at the
                    # next burst (which also counts this token).
                    self._counts_reset.add(slot)
            if req.trace is not None and not req.trace.prefill_end:
                req.trace.prefill_end = time.time()
            self._emit_token(seq, token, lp)
            # Decode positions start from the emitted tokens (a re-prefill
            # after preemption carries prior outputs).
            req.scheduled_steps = len(req.output_token_ids)
        self._pending_prefills = keep + self._pending_prefills
        self.flush_time_total += time.perf_counter() - t0

    # -- storm-scoped prefill batching --------------------------------------
    def _cached_prefix_len(self, tokens: List[int], adapter: str = "") -> int:
        """Read-only cached-prefix length: walk the chain hashes through
        the prefix map without allocating, never past the last token (as
        ``allocate_prompt`` bounds it). Callers hold self._lock."""
        bs = self.config.block_size
        alloc = self.kv_mgr.allocator
        ext = self.kv_mgr.external_lookup
        parent = self.kv_mgr.chain_root(adapter)
        i = 0
        while i + bs <= len(tokens) - 1:
            h = BlockAllocator.chain_hash(parent, tuple(tokens[i:i + bs]))
            if h not in alloc.prefix_map and not (
                    ext is not None and alloc.enable_prefix_caching
                    and ext(h)):
                break
            parent = h
            i += bs
        return i

    def _qualifying_waiting(self) -> int:
        """How many WAITING requests would qualify for a prefill-batch row
        now: the storm signal. The qualifier is the UNCACHED span, so
        long-but-cached follow-ups do not open the gate."""
        cfg = self.config
        chunk = cfg.prefill_chunk_size
        maxb_cap = self._prefill_batch_maxb()
        with self._lock:
            n = 0
            for cand in self.scheduler.live_waiting():
                toks = cand.all_token_ids
                if ((len(toks) + cfg.block_size - 1)
                        // cfg.block_size) > maxb_cap:
                    continue
                cached = self._cached_prefix_len(toks, cand.adapter_name)
                if len(toks) - cached >= max(chunk // 2, 1):
                    n += 1
            return n

    def _prefill_batch_maxb(self) -> int:
        """Widest block table a batched prefill takes (64 blocks, 4k-token
        contexts at the default page size): bounds its working set."""
        return min(64, self.config.max_blocks_per_seq)

    def _gather_prefill_group(self, req: EngineRequest, block_ids,
                              cached: int) -> List[dict]:
        """Up to prefill_batch long-prompt requests (the head plus
        qualifying waiters) that can be admitted NOW: a free slot counted
        per member, KV allocated eagerly. Members that fail allocation
        are requeued by _allocate_for_prefill."""
        cfg = self.config
        chunk = cfg.prefill_chunk_size
        group = [{"req": req, "block_ids": block_ids, "cached": cached}]
        # Candidates already walked and rejected this gather (the slot
        # loop rescans the queue).
        rejected: set = set()
        while len(group) < cfg.prefill_batch:
            with self._lock:
                free_slots = sum(1 for s in self.scheduler.slots if s is None)
                if free_slots <= len(group):  # head + members need slots
                    break
                nxt = None
                maxb_cap = self._prefill_batch_maxb()
                for cand in self.scheduler.live_waiting():
                    if cand.request_id in rejected:
                        continue
                    n_c = len(cand.all_token_ids)
                    blocks_c = (n_c + cfg.block_size - 1) // cfg.block_size
                    if blocks_c > maxb_cap:
                        rejected.add(cand.request_id)
                        continue
                    cached_c = self._cached_prefix_len(
                        cand.all_token_ids, cand.adapter_name)
                    if n_c - cached_c >= max(chunk // 2, 1):
                        nxt = cand
                        break
                    rejected.add(cand.request_id)
                if nxt is None:
                    break
                self.scheduler.take_waiting(nxt)
                self._step_reqs.append(nxt)
            got = self._allocate_for_prefill(nxt)
            if got is None:
                self._step_reqs.remove(nxt)
                break  # pool tight: nxt was requeued; stop growing
            bids_c, cached_c = got
            if len(nxt.all_token_ids) - cached_c < max(chunk // 2, 1):
                # A cache hit after all: its span is short. Release and
                # requeue; the single path re-allocates it cheaply.
                self.kv_mgr.free(nxt.request_id)
                self._step_reqs.remove(nxt)
                with self._lock:
                    self.scheduler.requeue(nxt)
                break
            group.append({"req": nxt, "block_ids": bids_c,
                          "cached": cached_c})
        return group

    def _do_prefill_group(self, group: List[dict]) -> None:
        """Batched prefill: every member's chunk ``si`` rides ONE [PB,
        chunk] dispatch (rows past the members are padding: seq_lens 0,
        page writes dropped). Shared prefixes are safe within a dispatch
        because every layer writes all rows' K/V before attention reads
        them. A member's first token comes from its LAST chunk's dispatch,
        read back at the next step as on the single path."""
        cfg = self.config
        chunk = cfg.prefill_chunk_size
        self.prefill_group_count += 1
        self.prefill_group_rows += len(group)
        logger.info("Storm prefill batch engaged: %d prompts in one "
                    "[%d, %d] dispatch chain", len(group),
                    cfg.prefill_batch, chunk)
        spans: Dict[int, list] = {}
        group_start = time.time()
        for m in group:
            tr = m["req"].trace
            if tr is not None:
                if not tr.prefill_start:
                    tr.prefill_start = group_start
                tr.cached_tokens = m["cached"]
                tr.preemptions = m["req"].num_preemptions
            n_m = len(m["req"].all_token_ids)
            s_list = []
            start = m["cached"]
            while start < n_m:
                end = min(start + chunk, n_m)
                s_list.append((start, end))
                start = end
            spans[id(m)] = s_list
        max_spans = max(len(s) for s in spans.values())
        finished = []  # (member, readback, row)
        for si in range(max_spans):
            rows = [m for m in group if si < len(spans[id(m)])]
            sampled = self._prefill_rows(
                [(m["req"], m["req"].all_token_ids, m["block_ids"],
                  *spans[id(m)][si]) for m in rows],
                pad_to=cfg.prefill_batch)
            for row_i, m in enumerate(rows):
                if si == len(spans[id(m)]) - 1:
                    finished.append((m, sampled, row_i))
        self._flush_pending_burst()
        self._flush_pending_prefills()
        group_end = time.time()
        if self.step_recorder is not None:
            new_tokens = sum(
                len(m["req"].all_token_ids) - m["cached"] for m in group)
            self._step_info = {
                "kind": "prefill", "rows": len(group),
                "tokens": new_tokens, "forwards": max_spans,
                # Every row runs the cached-prefill kernel, which reads its
                # whole context (the chunk included) from the pages.
                "kv_read_tokens": sum(
                    e for s_list in spans.values() for (_s, e) in s_list),
                "kv_write_tokens": new_tokens, "batched": True,
            }
        for m, sampled, row in finished:
            req_m = m["req"]
            if req_m.trace is not None:
                req_m.trace.prefill_end = group_end
            self.prompt_tokens_total += len(req_m.all_token_ids)
            self.cached_tokens_total += m["cached"]
            with self._lock:
                slot = self.scheduler._free_slot()
                seq = self.scheduler.start_running(req_m, slot)
            self._pending_prefills.append(
                {"req": req_m, "seq": seq, "slot": slot,
                 "sampled": sampled, "row": row})

    def _prefill_rows(self, rows, pad_to: int) -> "_Readback":
        """One batched prefill dispatch: rows = [(req, tokens, block_ids,
        start, end), ...] padded to ``pad_to`` rows. Always the cached
        prefill at the CHUNK bucket, its table width a power of two capped
        at _prefill_batch_maxb(). A padding row has token 0 at positions
        0, seq_len 0, context 1, an all-zero table and slot -1 (its page
        writes drop); its sample is never read."""
        cfg = self.config
        R = pad_to
        bucket = cfg.bucket_for(min(cfg.prefill_chunk_size,
                                    cfg.max_model_len))
        blocks_needed = max(
            (m[4] + cfg.block_size - 1) // cfg.block_size for m in rows)
        maxb = 4
        while maxb < blocks_needed:
            maxb *= 2
        maxb = min(maxb, self._prefill_batch_maxb())

        a = _prefill_arrays(R, bucket, maxb, self._mask_row_bytes)
        for i, (req, tokens, block_ids, start, end) in enumerate(rows):
            self._fill_prefill_row(a, i, req, tokens, block_ids, start, end)
        self.prefill_batched_dispatch_total += 1
        return self._prefill_forward(a, cached=True)

    def _prefill_span(self, req: EngineRequest, tokens, block_ids,
                      start: int, end: int) -> "_Readback":
        """Launch one prefill chunk (tokens[start:end]) and sample the next
        token from its last real position. Chunks after the first attend
        to earlier tokens through the pages (prefill_cached); the chunk's
        own K/V are written first."""
        cfg = self.config
        # Power-of-two table width (min 4) over the context, capped at
        # max_blocks_per_seq, as the JAX engine buckets it.
        blocks_needed = (end + cfg.block_size - 1) // cfg.block_size
        maxb = 4
        while maxb < blocks_needed:
            maxb *= 2
        maxb = min(maxb, cfg.max_blocks_per_seq)
        a = _prefill_arrays(1, cfg.bucket_for(end - start), maxb,
                            self._mask_row_bytes)
        self._fill_prefill_row(a, 0, req, tokens, block_ids, start, end)
        return self._prefill_forward(a, cached=start > 0)

    def _fill_prefill_row(self, a: dict, i: int, req: EngineRequest, tokens,
                          block_ids, start: int, end: int) -> None:
        """Row ``i`` of a prefill dispatch's host arrays: the chunk
        tokens[start:end] of ``req``."""
        bs = self.config.block_size
        take = end - start
        bucket = a["tokens"].shape[1]
        a["tokens"][i, :take] = tokens[start:end]
        a["positions"][i] = start + np.arange(bucket)
        pos_idx = start + np.arange(take)
        blocks = np.asarray(block_ids, np.int64)
        a["slots"][i, :take] = blocks[pos_idx // bs] * bs + pos_idx % bs
        use = min(len(block_ids), a["table"].shape[1])
        a["table"][i, :use] = block_ids[:use]
        a["context"][i] = end
        a["seq_lens"][i] = take
        a["adapter"][i] = req.adapter_id
        (a["temp"][i], a["top_k"][i], a["top_p"][i],
         a["seeds"][i]) = self._sampling_for(req)
        a["steps"][i] = len(tokens)
        a["suppress"][i] = len(req.output_token_ids) < req.sampling.min_tokens
        a["bias"][i] = self._resume_bias(req)
        a["stops"][i] = req.sampling.stop_token_ids
        # Only a prompt's final chunk samples a token that is read, with
        # the automaton at the request's current state (a re-prefill after
        # preemption included: emitted outputs advanced it already).
        self._fill_mask_row(a["mask_bits"], a["mask_on"], i, req)

    def _prefill_forward(self, a: dict, cached: bool) -> "_Readback":
        """Launch the prefill program (:meth:`_prefill_op`) of the host
        arrays ``a``; returns the readback of (sampled, logprob, top
        logprobs, top ids)."""
        if cached:
            self.prefill_attention_dispatch_total["pallas"] += 1
        return _Readback(self._dispatch("prefill", {"cached": cached}, [a]))

    def _prefill_op(self, cached: bool, a: dict) -> tuple:
        """The prefill program: forward, logit shaping and sampling of each
        row's last real token under the key ``make_rng_keys(seed,
        steps.max(), seeds + steps)`` over the WHOLE dispatched batch,
        padding rows included (as the JAX engine keys it, so a row's draw
        depends on its batch-mates' steps)."""
        dev = self.device

        def t(x):
            return to_device(torch.from_numpy(x), dev)

        seq_lens = t(a["seq_lens"])
        logits, _ = self._apply(
            self.params, self.model_config, t(a["tokens"]),
            t(a["positions"]), self.kv, torch.from_numpy(a["slots"]),
            t(a["table"]), t(a["context"]), seq_lens,
            mode="prefill_cached" if cached else "prefill",
            adapter_ids=t(a["adapter"]),
            last_token=torch.clamp(seq_lens - 1, min=0), tp=self._tp)
        bias_ids, bias_vals = self._bias_rows(a["bias"])
        stop_ids, stop_valid = self._stop_rows(a["stops"])
        shaped = shape_logits(
            logits[:, 0], bias_ids=bias_ids, bias_vals=bias_vals,
            suppress=t(a["suppress"]), stop_ids=stop_ids,
            stop_valid=stop_valid, eos_id=self._eos_id)
        if a["mask_on"].any():
            shaped = apply_fsm_mask(shaped, t(a["mask_bits"]),
                                    t(a["mask_on"]))
        steps = a["steps"]
        keys = make_rng_keys(self.config.seed, int(steps.max()),
                             t(a["seeds"] + steps))
        sampled = sample_tokens(
            shaped, keys, t(a["temp"]), t(a["top_k"]), t(a["top_p"]),
            max_top_k=self.config.max_top_k)
        return (sampled,) + logprob_outputs(shaped, sampled)

    # -- decode ------------------------------------------------------------
    def _do_decode(self) -> None:
        """Launch one decode burst, pipelined: burst N+1 is launched (its
        feedback token taken on the device from burst N's output) BEFORE
        burst N is read back, so the readback and the host's emission
        overlap the card's work. A sequence whose burst-N tokens finish
        it is covered speculatively by burst N+1: its extra tokens are
        discarded at emission, and its stray page writes land before any
        later owner of those pages writes them (stream order)."""
        cfg = self.config
        # Deferred first tokens land before the burst is built (feedback
        # tokens and positions depend on them).
        self._flush_pending_prefills()
        if cfg.speculative_num_tokens > 0:
            # Drafts need the TRUE last token: speculation collapses the
            # pipeline (the burst in flight is read back first, and the
            # next burst feeds from host tokens). A captured prefill's
            # sample must really run, and be emitted, before it can seed
            # a draft: the fused capture ends here.
            self._abort_fused_capture()
            self._flush_pending_prefills()
            self._flush_pending_burst()
            plan = self._propose_spec_drafts()
            if plan:
                self._do_decode_spec(plan)
                return
        # A structured row's mask comes from its CURRENT automaton state,
        # which only the emitted tokens advance: it collapses the pipeline
        # as speculation does (the burst in flight is read back first).
        with self._lock:
            has_structured = any(
                s.req.structured is not None and s.req.structured.masking
                for s in self.scheduler.running())
        if has_structured:
            # The masks need the tokens of a captured prefill too.
            self._abort_fused_capture()
            self._flush_pending_prefills()
            self._flush_pending_burst()
        B = cfg.max_num_seqs
        K_max = max(cfg.decode_steps, 1)
        K = K_max
        # A prompt waits AND is admissible (a free slot; its pages fit):
        # shorten the burst so its prefill starts sooner.
        with self._lock:
            waiter = self.scheduler.peek_waiting()
            admissible_waiter = (
                waiter is not None
                and self.scheduler._free_slot() is not None
                and self.kv_mgr.can_allocate(len(waiter.all_token_ids) + 1))
        if cfg.decode_steps_pressure > 0 and admissible_waiter:
            K = min(K, max(cfg.decode_steps_pressure, 1))

        # Per-sequence usable burst width. The bounds use all_token_ids,
        # which may lag the burst in flight, so this over-schedules at most
        # one burst near the caps.
        def seq_allow(r: EngineRequest) -> int:
            if r.structured is not None and r.structured.masking:
                # The mask is constant across the burst: one usable step;
                # the later ones would sample under a stale mask and are
                # discarded at emission.
                return 1
            return max(1, min(
                K,
                r.sampling.max_tokens - len(r.output_token_ids),
                cfg.max_model_len - len(r.all_token_ids) + 1,
            ))

        prev = self._pending_burst
        prev_slots = ({id(s): prev["allows"].get(s.req.request_id, 1)
                       for s in prev["active"]} if prev else {})
        # Sequences whose first token is still in the fused capture have
        # no sample to feed back: they sit this burst out and join the
        # next (per-row positions and keys keep their streams the
        # alternating schedule's).
        pending_first = {e["req"].request_id for e in self._pending_prefills
                         if not e["sampled"].ready}

        with self._lock:
            active0 = [s for s in self.scheduler.running()
                       if s.req.request_id not in pending_first]
            allows: Dict[str, int] = {}
            # Account the about-to-be-written tokens; preempt on OOM.
            for seq in list(self.scheduler.running()):
                if self.scheduler.slots[seq.slot] is not seq:
                    continue  # already preempted this pass
                if seq.req.request_id in pending_first:
                    continue  # first token still in the fused capture
                need = seq_allow(seq.req)
                allows[seq.req.request_id] = need
                while need > 0:
                    if self.kv_mgr.append_token(seq.req.request_id,
                                                seq.req.all_token_ids[-1]):
                        need -= 1
                        continue
                    victim = self.scheduler.preempt_victim()
                    if victim is None or victim.req is seq.req:
                        break
            active0_ids = {id(s) for s in active0}
            active = [s for s in self.scheduler.running()
                      if id(s) in active0_ids]
        self._drain_offload()  # pages the block accounting evicted
        if not active:
            self._flush_pending_burst()
            return

        max_blocks = max(len(self.kv_mgr.block_table(s.req.request_id))
                         for s in active)
        maxb = 4
        while maxb < max_blocks:
            maxb *= 2
        maxb = min(maxb, cfg.max_blocks_per_seq)

        host_tokens = np.zeros((B,), np.int64)
        use_host = np.ones((B,), bool)
        tok_idx = np.zeros((B,), np.int64)
        positions0 = np.zeros((B,), np.int64)
        slot_mat = np.full((B, K), -1, np.int64)
        block_table = np.zeros((B, maxb), np.int32)
        context0 = np.ones((B,), np.int64)
        adapter_ids = np.zeros((B,), np.int64)
        temperature = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)
        seed_base = np.zeros((B,), np.int64)
        presence = np.zeros((B,), np.float32)
        frequency = np.zeros((B,), np.float32)
        min_tok = np.zeros((B,), np.int64)
        out_len0 = np.zeros((B,), np.int64)
        biases, stops = [None] * B, [None] * B
        mask_bits = np.zeros((B, self._mask_row_bytes), np.uint8)
        mask_on = np.zeros((B,), bool)
        reset_counts = np.zeros((B,), bool)
        with self._lock:
            for slot in self._counts_reset:
                reset_counts[slot] = True
            self._counts_reset.clear()
        for seq in active:
            i, r = seq.slot, seq.req
            # Positions count SCHEDULED tokens: with a burst in flight the
            # host has not seen its tokens, but their pages and positions
            # are committed.
            if id(seq) in prev_slots:
                # Feedback token from the burst in flight, on the device.
                use_host[i] = False
                tok_idx[i] = prev_slots[id(seq)] - 1
            else:
                host_tokens[i] = r.all_token_ids[-1]
            base = len(r.prompt_token_ids) + r.scheduled_steps
            allow = allows.get(r.request_id, 1)
            positions0[i] = base - 1
            context0[i] = base
            bids = self.kv_mgr.block_table(r.request_id)
            use = min(len(bids), maxb)
            block_table[i, :use] = bids[:use]
            pos = base - 1 + np.arange(allow)
            bid_arr = np.asarray(bids, np.int64)
            slot_mat[i, :allow] = (bid_arr[pos // cfg.block_size]
                                   * cfg.block_size + pos % cfg.block_size)
            adapter_ids[i] = r.adapter_id
            temperature[i], top_k[i], top_p[i], seed = self._sampling_for(r)
            # Step s of the burst draws under make_rng_keys(seed, 0,
            # seed_base + s): seed_base is taken before scheduled_steps
            # moves.
            seed_base[i] = seed + r.scheduled_steps
            presence[i] = r.sampling.presence_penalty
            frequency[i] = r.sampling.frequency_penalty
            min_tok[i] = r.sampling.min_tokens
            out_len0[i] = r.scheduled_steps
            biases[i] = r.sampling.logit_bias
            stops[i] = r.sampling.stop_token_ids
            self._fill_mask_row(mask_bits, mask_on, i, r)
            r.scheduled_steps += allow

        outs = self._launch_burst(
            K, prev is not None, reset_counts, tok_idx, host_tokens,
            use_host, positions0, slot_mat, block_table, context0,
            adapter_ids, temperature, top_k, top_p, seed_base, presence,
            frequency, min_tok, out_len0, biases, stops, mask_bits, mask_on)
        self.decode_forward_steps_total += K
        if self.step_recorder is not None:
            sched = sum(allows.get(s.req.request_id, 1) for s in active)
            self._step_info = {
                "kind": "decode_burst", "rows": len(active),
                "tokens": sched, "forwards": K,
                # Every step re-reads each live row's context through
                # paged attention (context0 is the lower bound).
                "kv_read_tokens": K * int(
                    sum(context0[s.slot] for s in active)),
                "kv_write_tokens": sched,
            }
        # Read back the PREVIOUS burst while this one runs.
        self._flush_pending_burst()
        self._pending_burst = {"out": outs, "active": active,
                               "allows": allows}

    def _launch_burst(self, K: int, use_prev: bool, *arrays) -> "_Readback":
        """Launch the K-step decode program (:meth:`_decode_op`) of the
        host arrays; returns the readback of (sampled, logprob, top
        logprobs, top ids), each [B, K, ...]."""
        return _Readback(self._dispatch(
            "decode", {"K": K, "use_prev": use_prev}, list(arrays)))

    def _decode_op(self, K, use_prev, reset_counts, tok_idx, host_tokens,
                   use_host, positions0, slot_mat, block_table, context0,
                   adapter_ids, temperature, top_k, top_p, seed_base,
                   presence, frequency, min_tok, out_len0, biases,
                   stops, mask_bits, mask_on) -> tuple:
        """The K-step decode program: each step's forward, logit shaping
        (penalties, bias, min_tokens EOS/stop masking, then the FSM mask
        rows ``mask_bits [B, MB]`` / ``mask_on [B]``, the same at every
        step) and keyed sample, the sampled tokens fed back on the
        device. Its [B, decode_steps] tokens (padded past K) stay on the
        device as the next burst's feedback (on every rank: each samples
        the same tokens from the same gathered logits)."""
        cfg = self.config
        dev = self.device
        B = cfg.max_num_seqs
        K_max = max(cfg.decode_steps, 1)

        def t(x):
            return to_device(torch.from_numpy(x), dev)

        tokens_prev = (self._last_burst_tokens if use_prev else
                       torch.zeros((B, K_max), dtype=torch.long, device=dev))
        tokens = torch.where(
            t(use_host), t(host_tokens),
            torch.gather(tokens_prev, 1, t(tok_idx)[:, None])[:, 0])
        counts = self._token_counts
        arange_b = torch.arange(B, device=dev)
        if reset_counts.any():
            # Freshly prefilled slots start a new output: zero their count
            # rows, then count their first token (sampled by the prefill,
            # it arrives here as the feedback token).
            reset = t(reset_counts)
            counts.masked_fill_(reset[:, None], 0)
            counts.index_put_((arange_b, tokens), reset.to(torch.int32),
                              accumulate=True)
        positions0_t, context0_t = t(positions0), t(context0)
        block_table_t, adapter_t = t(block_table), t(adapter_ids)
        temp_t, top_k_t, top_p_t = t(temperature), t(top_k), t(top_p)
        presence_t, frequency_t = t(presence), t(frequency)
        min_tok_t, out_len0_t = t(min_tok), t(out_len0)
        bias_ids, bias_vals = self._bias_rows(biases)
        stop_ids, stop_valid = self._stop_rows(stops)
        ones = torch.ones((B,), dtype=torch.long, device=dev)
        # Every step's noise in one pass: step s keys as
        # make_rng_keys(seed, 0, seed_base + s).
        keys = make_rng_keys(
            cfg.seed, 0, t(seed_base[:, None] + np.arange(K)[None, :]))
        noise = prng.gumbel(keys, min(cfg.max_top_k,
                                      self.model_config.vocab_size))
        # The mask rows are constant across the burst: unpacked once.
        allowed = (fsm_allowed(t(mask_bits), t(mask_on),
                               self.model_config.vocab_size)
                   if mask_on.any() else None)
        outs = []
        for s in range(K):
            step_slots = torch.from_numpy(slot_mat[:, s:s + 1])
            logits, _ = self._apply(
                self.params, self.model_config, tokens[:, None],
                (positions0_t + s)[:, None], self.kv, step_slots,
                block_table_t, context0_t + s, ones, mode="decode",
                adapter_ids=adapter_t, tp=self._tp)
            shaped = shape_logits(
                logits[:, 0], bias_ids=bias_ids, bias_vals=bias_vals,
                suppress=(out_len0_t + s) < min_tok_t, stop_ids=stop_ids,
                stop_valid=stop_valid, eos_id=self._eos_id, counts=counts,
                presence_penalty=presence_t, frequency_penalty=frequency_t)
            if allowed is not None:
                shaped = mask_disallowed(shaped, allowed)
            sampled = sample_with_gumbel(shaped, noise[:, s], temp_t, top_k_t,
                                         top_p_t, max_top_k=cfg.max_top_k)
            outs.append((sampled,) + logprob_outputs(shaped, sampled))
            # Only steps whose page slot is live count toward penalties.
            live = t(slot_mat[:, s] >= 0)
            counts[arange_b, sampled] += live.to(torch.int32)
            tokens = sampled
        sampled, lps, top_lps, top_ids = (torch.stack(x, dim=1)
                                          for x in zip(*outs))
        fb = sampled
        if K < K_max:
            fb = torch.cat([sampled, torch.zeros(
                (B, K_max - K), dtype=sampled.dtype, device=dev)], dim=1)
        self._last_burst_tokens = fb
        return sampled, lps, top_lps, top_ids

    def _flush_pending_burst(self) -> None:
        """Read back and emit the burst in flight, if any."""
        pending = self._pending_burst
        if pending is None or not pending["out"].ready:
            # (A burst still in a fused capture has nothing to read back;
            # _do_fused settles every capture before it returns.)
            return
        self._pending_burst = None
        t0 = time.perf_counter()
        sampled, lps, top_lps, top_ids = pending["out"].get()
        self.flush_time_total += time.perf_counter() - t0
        if pending.get("spec"):
            self._flush_spec_burst(pending, sampled, lps, top_lps, top_ids)
            return
        emitted_seqs = []
        for seq in pending["active"]:
            allow = pending["allows"].get(seq.req.request_id, 1)
            want_lp = seq.req.sampling.logprobs
            emitted = 0
            for s in range(allow):
                if self.scheduler.slots[seq.slot] is not seq:
                    break  # finished / aborted / preempted mid-burst
                lp = None
                if want_lp is not None:
                    k = min(want_lp, top_lps.shape[2])
                    lp = {"logprob": float(lps[seq.slot, s]),
                          "top": [(int(top_ids[seq.slot, s, j]),
                                   float(top_lps[seq.slot, s, j]))
                                  for j in range(k)]}
                self._emit_token(seq, int(sampled[seq.slot, s]), lp)
                emitted += 1
            self.generation_tokens_total += emitted
            if emitted and self.scheduler.slots[seq.slot] is seq:
                emitted_seqs.append(seq)
        if emitted_seqs:
            # Extend the prefix-hash chain over decode-completed blocks so
            # follow-up prompts that extend this output hit the cache.
            with self._lock:
                for seq in emitted_seqs:
                    self.kv_mgr.register_decode_blocks(
                        seq.req.request_id, seq.req.all_token_ids)

    # -- speculative decoding ----------------------------------------------
    def _propose_spec_drafts(self):
        """Drafts for the next burst: ``[(seq, draft), ...]`` covering
        EVERY running row, or None for a plain burst. From the draft model
        when one is configured, from prompt lookup otherwise.

        All or nothing: a verify burst replaces the whole batch's step, so
        a row without a draft, latched off by its acceptance, that allows
        fewer than two tokens, or with presence/frequency penalties (the
        verify has no in-pass token counts) sends the batch down the
        plain path."""
        cfg = self.config
        K = cfg.speculative_num_tokens
        use_draft = self._draft is not None
        with self._lock:
            active = [s for s in self.scheduler.running()
                      if self.scheduler.slots[s.slot] is s]
        if not active:
            return None
        rows = []
        for seq in active:
            r = seq.req
            if r.sampling.presence_penalty or r.sampling.frequency_penalty:
                return None
            if r.spec is None:
                r.spec = SpecState(
                    cfg.speculative_ngram_size,
                    source="draft_model" if use_draft else "ngram",
                    probation=(cfg.speculative_draft_probation
                               if use_draft else 0))
            if r.spec.disabled:
                # Each plain burst sat out counts against a drafter's
                # probation; a prompt-lookup latch (probation 0) stays.
                r.spec.tick_probation()
                if r.spec.disabled:
                    return None
            allow = max(1, min(
                K,
                r.sampling.max_tokens - len(r.output_token_ids),
                cfg.max_model_len - len(r.all_token_ids) + 1,
            ))
            if allow < 2:
                return None
            rows.append((seq, allow))
        if use_draft:
            return self._propose_draft_model(rows)
        plan = []
        for seq, allow in rows:
            draft = seq.req.spec.propose(seq.req.all_token_ids, allow - 1)
            if not draft:
                return None
            plan.append((seq, list(draft)))
        return plan

    def _propose_draft_model(self, rows):
        """Batched draft-model proposal. Phase A catches the drafter's
        pages up with every token it has not seen, in chunks at the
        catch-up buckets, and takes the greedy token at each row's
        frontier as its first draft (masked by a structured row's current
        automaton state). Phase B extends every row to its width: in one
        greedy scan when no row is masked, else a forward a draft step
        (:meth:`_draft_constrained`). Returns a plan for
        :meth:`_do_decode_spec`, or None (the drafter's pool is out of
        pages) for a plain burst."""
        cfg = self.config
        d = self._draft
        B = cfg.max_num_seqs
        bs = cfg.block_size
        maxb = cfg.max_blocks_per_seq
        info = []
        with self._lock:
            for seq, allow in rows:
                r = seq.req
                rid = r.request_id
                n = len(r.all_token_ids)
                # Worst case this burst: catch up to n, then allow - 2
                # draft-extension steps.
                if not d.ensure_capacity(rid, n + allow - 2):
                    return None
                start = min(d.computed.get(rid, 0), n - 1)
                st = r.structured if cfg.speculative_draft_constrain else None
                info.append({
                    "seq": seq, "rid": rid, "allow": allow, "n": n,
                    "start": start,
                    "feed": list(r.all_token_ids[start:]),
                    "table": np.asarray(d.block_table(rid), np.int64),
                    "st": st if (st is not None and st.masking) else None,
                })
        buckets = d.buckets()
        maxW = buckets[-1]

        def page_slots(table, positions):
            return table[positions // bs] * bs + positions % bs

        # -- phase A: chunked catch-up and the first draft token --------
        drafts: list = [None] * len(info)
        fed = [0] * len(info)
        pending = set(range(len(info)))
        while pending:
            take = {i: min(len(info[i]["feed"]) - fed[i], maxW)
                    for i in pending}
            W = cfg.bucket_for(max(take.values()))
            tokens = np.zeros((B, W), np.int64)
            positions = np.zeros((B, W), np.int64)
            slot_map = np.full((B, W), -1, np.int64)
            tables = np.zeros((B, maxb), np.int32)
            ctx = np.ones((B,), np.int64)
            sl = np.ones((B,), np.int64)
            mask_bits = np.zeros((B, self._mask_row_bytes), np.uint8)
            mask_on = np.zeros((B,), bool)
            done_now = []
            for i in sorted(pending):
                e = info[i]
                b = e["seq"].slot
                t = take[i]
                lo = e["start"] + fed[i]
                span = np.arange(lo, lo + t, dtype=np.int64)
                tokens[b, :t] = e["feed"][fed[i]:fed[i] + t]
                # Positions ascend past the row's span too (the JAX
                # engine's are 0 there): the cached-prefill kernel takes a
                # query tile's key range from its last row's position.
                # Those columns write no page and their outputs go unread.
                positions[b] = lo + np.arange(W)
                slot_map[b, :t] = page_slots(e["table"], span)
                use = min(len(e["table"]), maxb)
                tables[b, :use] = e["table"][:use]
                ctx[b] = lo + t
                sl[b] = t
                fed[i] += t
                if lo + t == e["n"]:
                    # This round gives the row's first draft: masked by
                    # the request's CURRENT automaton state, the verify's
                    # mask at position 0.
                    done_now.append(i)
                    if e["st"] is not None and e["st"].state >= 0:
                        mask_bits[b] = e["st"].mask_row()
                        mask_on[b] = True
            toks = d.forward(tokens, positions, slot_map, tables, ctx, sl,
                             mask_bits, mask_on).cpu().numpy()
            self.spec_draft_forward_steps_total += 1
            for i in done_now:
                drafts[i] = [int(toks[info[i]["seq"].slot])]
                pending.discard(i)

        # -- phase B: extend to the full draft width ---------------------
        steps_max = max(e["allow"] for e in info) - 2
        if steps_max >= 1 and not any(e["st"] is not None for e in info):
            S = cfg.speculative_num_tokens - 2
            token0 = np.zeros((B,), np.int64)
            positions0 = np.zeros((B,), np.int64)
            slot_mat = np.full((B, S), -1, np.int64)
            tables = np.zeros((B, maxb), np.int32)
            ctx0 = np.ones((B,), np.int64)
            for i, e in enumerate(info):
                b = e["seq"].slot
                token0[b] = drafts[i][0]
                positions0[b] = e["n"]
                ctx0[b] = e["n"] + 1
                t = e["allow"] - 2
                if t > 0:
                    span = np.arange(e["n"], e["n"] + t, dtype=np.int64)
                    slot_mat[b, :t] = page_slots(e["table"], span)
                use = min(len(e["table"]), maxb)
                tables[b, :use] = e["table"][:use]
            toks = d.scan(token0, positions0, slot_mat, tables,
                          ctx0).cpu().numpy()
            self.spec_draft_forward_steps_total += S
            for i, e in enumerate(info):
                drafts[i].extend(
                    int(x) for x in toks[e["seq"].slot, :e["allow"] - 2])
        elif steps_max >= 1:
            self._draft_constrained(info, drafts, steps_max, buckets[0])

        plan = []
        with self._lock:
            for i, e in enumerate(info):
                dr = drafts[i][:e["allow"] - 1]
                # The drafter's pages now cover the request's n tokens and
                # the drafts fed back (all but the last one drafted).
                d.computed[e["rid"]] = e["n"] + len(dr) - 1
                plan.append((e["seq"], dr))
        return plan

    def _draft_constrained(self, info, drafts, steps_max: int,
                           W0: int) -> None:
        """FSM-constrained drafting (phase B with a masked row): one
        drafter forward a draft step over ``[B, W0]`` rows whose column 0
        is the live token, each masked row under a LOCAL automaton cursor
        walked through its drafts as the verify walks them (the request's
        own state moves only at emission); past the language the row
        drafts unmasked. Positions ascend over the whole bucket (the JAX
        engine leaves 0 past column 0): the cached-prefill kernel takes a
        query tile's key range from its last row's position. Columns past
        0 write no page and their outputs go unread. Appends to
        ``drafts``."""
        cfg = self.config
        d = self._draft
        B, bs, maxb = cfg.max_num_seqs, cfg.block_size, cfg.max_blocks_per_seq
        cur = []
        for i, e in enumerate(info):
            c = e["st"].state if e["st"] is not None else -1
            if c >= 0:
                c = e["st"].fsm.advance(c, drafts[i][0])
            cur.append(c)
        for s in range(1, steps_max + 1):
            live = [i for i, e in enumerate(info) if e["allow"] - 1 > s]
            if not live:
                break
            tokens = np.zeros((B, W0), np.int64)
            positions = np.zeros((B, W0), np.int64)
            slot_map = np.full((B, W0), -1, np.int64)
            tables = np.zeros((B, maxb), np.int32)
            ctx = np.ones((B,), np.int64)
            sl = np.ones((B,), np.int64)
            mask_bits = np.zeros((B, self._mask_row_bytes), np.uint8)
            mask_on = np.zeros((B,), bool)
            for i in live:
                e = info[i]
                b = e["seq"].slot
                p = e["n"] + s - 1
                tokens[b, 0] = drafts[i][s - 1]
                positions[b] = p + np.arange(W0)
                slot_map[b, 0] = int(e["table"][p // bs]) * bs + p % bs
                ctx[b] = p + 1
                use = min(len(e["table"]), maxb)
                tables[b, :use] = e["table"][:use]
                if e["st"] is not None and cur[i] >= 0:
                    mask_bits[b] = e["st"].fsm.mask_row(cur[i])
                    mask_on[b] = True
            toks = d.forward(tokens, positions, slot_map, tables, ctx, sl,
                             mask_bits, mask_on).cpu().numpy()
            self.spec_draft_forward_steps_total += 1
            for i in live:
                e = info[i]
                tok = int(toks[e["seq"].slot])
                drafts[i].append(tok)
                if e["st"] is not None and cur[i] >= 0:
                    cur[i] = e["st"].fsm.advance(cur[i], tok)

    def _do_decode_spec(self, plan) -> None:
        """Launch one verify burst: ONE forward scores each row's last
        emitted token and its drafts at their positions; the flush
        accepts the longest draft prefix that matches what plain decode
        would have sampled and rolls back the pages appended for the
        rejected positions. Not pipelined: acceptance depends on the data,
        so the next drafts need this burst's tokens on the host."""
        cfg = self.config
        B = cfg.max_num_seqs
        K = cfg.speculative_num_tokens
        drafts = {s.req.request_id: d for s, d in plan}
        with self._lock:
            active0_ids = {id(s) for s, _ in plan}
            allows: Dict[str, int] = {}
            # Account the tokens about to be written; preempt on OOM, as
            # _do_decode does: a surviving row ends with exactly `allow`
            # tokens appended, which the flush's rollback relies on.
            for seq, draft in plan:
                if self.scheduler.slots[seq.slot] is not seq:
                    continue  # already preempted this pass
                need = len(draft) + 1
                allows[seq.req.request_id] = need
                while need > 0:
                    if self.kv_mgr.append_token(seq.req.request_id,
                                                seq.req.all_token_ids[-1]):
                        need -= 1
                        continue
                    victim = self.scheduler.preempt_victim()
                    if victim is None or victim.req is seq.req:
                        break
            active = [s for s in self.scheduler.running()
                      if id(s) in active0_ids]
        self._drain_offload()
        if not active:
            return

        max_blocks = max(len(self.kv_mgr.block_table(s.req.request_id))
                         for s in active)
        maxb = 4
        while maxb < max_blocks:
            maxb *= 2
        maxb = min(maxb, cfg.max_blocks_per_seq)

        tokens = np.zeros((B, K), np.int64)
        positions0 = np.zeros((B,), np.int64)
        slot_mat = np.full((B, K), -1, np.int64)
        block_table = np.zeros((B, maxb), np.int32)
        context0 = np.ones((B,), np.int64)
        adapter_ids = np.zeros((B,), np.int64)
        temperature = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)
        seed_base = np.zeros((B,), np.int64)
        min_tok = np.zeros((B,), np.int64)
        out_len0 = np.zeros((B,), np.int64)
        biases, stops = [None] * B, [None] * B
        mask_bits = np.zeros((B, K, self._mask_row_bytes), np.uint8)
        mask_on = np.zeros((B, K), bool)
        for seq in active:
            i, r = seq.slot, seq.req
            draft = drafts[r.request_id]
            allow = allows.get(r.request_id, 1)
            base = len(r.prompt_token_ids) + r.scheduled_steps
            row = [r.all_token_ids[-1]] + draft
            tokens[i, :len(row)] = row
            positions0[i] = base - 1
            context0[i] = base
            bids = self.kv_mgr.block_table(r.request_id)
            use = min(len(bids), maxb)
            block_table[i, :use] = bids[:use]
            pos = base - 1 + np.arange(allow)
            bid_arr = np.asarray(bids, np.int64)
            slot_mat[i, :allow] = (bid_arr[pos // cfg.block_size]
                                   * cfg.block_size + pos % cfg.block_size)
            adapter_ids[i] = r.adapter_id
            temperature[i], top_k[i], top_p[i], seed = self._sampling_for(r)
            seed_base[i] = seed + r.scheduled_steps
            min_tok[i] = r.sampling.min_tokens
            out_len0[i] = r.scheduled_steps
            biases[i] = r.sampling.logit_bias
            stops[i] = r.sampling.stop_token_ids
            st = r.structured
            if st is not None and st.masking:
                # Position s gets the mask plain decode would apply after
                # emitting drafts 0..s-1. A draft that leaves the language
                # at position t makes sampled[t] differ from it, so
                # acceptance stops there and the positions past it are
                # never emitted.
                cur = st.state
                for s in range(allow):
                    if cur < 0:
                        break
                    mask_bits[i, s] = st.fsm.mask_row(cur)
                    mask_on[i, s] = True
                    if s < len(draft):
                        cur = st.fsm.advance(cur, draft[s])
            # scheduled_steps advances at the flush, by the emitted count.

        outs = self._launch_verify(
            K, tokens, positions0, slot_mat, block_table, context0,
            adapter_ids, temperature, top_k, top_p, seed_base, min_tok,
            out_len0, biases, stops, mask_bits, mask_on)
        self.spec_verify_bursts_total += 1
        self.decode_forward_steps_total += 1
        if self.step_recorder is not None:
            sched = sum(allows.get(s.req.request_id, 1) for s in active)
            self._step_info = {
                "kind": "spec_verify", "rows": len(active),
                "tokens": sched, "forwards": 1,
                "kv_read_tokens": int(
                    sum(context0[s.slot] for s in active)),
                "kv_write_tokens": sched,
            }
        self._pending_burst = {"out": outs, "active": active,
                               "allows": allows, "spec": True,
                               "drafts": drafts}

    def _launch_verify(self, K: int, *arrays) -> "_Readback":
        """Launch the verify program (:meth:`_verify_op`) of the host
        arrays; returns the readback of (sampled, logprob, top logprobs,
        top ids), each [B, K, ...]."""
        return _Readback(self._dispatch("spec_verify", {"K": K},
                                        list(arrays)))

    def _verify_op(self, K, tokens, positions0, slot_mat, block_table,
                   context0, adapter_ids, temperature, top_k, top_p,
                   seed_base, min_tok, out_len0, biases, stops,
                   mask_bits, mask_on) -> tuple:
        """The verify program: one cached-prefill forward of ``[B, K]``
        rows (row b: its last emitted token and drafts at positions
        positions0[b]..+K-1, context context0[b] + K - 1, each token's
        page written before attention reads it), then position s of
        every row shaped and sampled as step s of a plain burst would be:
        bias, min_tokens EOS/stop masking, the mask term, and the key
        ``make_rng_keys(seed, 0, seed_base + s)``. Penalty rows never get
        here, so no token counts. A padding row is token 0 at positions
        0.., context K, slots -1, an all-zero table."""
        cfg = self.config
        dev = self.device
        B = cfg.max_num_seqs

        def t(x):
            return to_device(torch.from_numpy(x), dev)

        positions = positions0[:, None] + np.arange(K)[None, :]
        logits, _ = self._apply(
            self.params, self.model_config, t(tokens), t(positions),
            self.kv, torch.from_numpy(slot_mat), t(block_table),
            t(context0 + K - 1), t(np.full((B,), K, np.int64)),
            mode="prefill_cached", adapter_ids=t(adapter_ids), tp=self._tp)
        temp_t, top_k_t, top_p_t = t(temperature), t(top_k), t(top_p)
        min_tok_t, out_len0_t = t(min_tok), t(out_len0)
        mask_bits_t, mask_on_t = t(mask_bits), t(mask_on)
        bias_ids, bias_vals = self._bias_rows(biases)
        stop_ids, stop_valid = self._stop_rows(stops)
        keys = make_rng_keys(
            cfg.seed, 0, t(seed_base[:, None] + np.arange(K)[None, :]))
        noise = prng.gumbel(keys, min(cfg.max_top_k,
                                      self.model_config.vocab_size))
        outs = []
        for s in range(K):
            shaped = shape_logits(
                logits[:, s], bias_ids=bias_ids, bias_vals=bias_vals,
                suppress=(out_len0_t + s) < min_tok_t, stop_ids=stop_ids,
                stop_valid=stop_valid, eos_id=self._eos_id)
            shaped = apply_fsm_mask(shaped, mask_bits_t[:, s],
                                    mask_on_t[:, s])
            sampled = sample_with_gumbel(shaped, noise[:, s], temp_t,
                                         top_k_t, top_p_t,
                                         max_top_k=cfg.max_top_k)
            outs.append((sampled,) + logprob_outputs(shaped, sampled))
        return tuple(torch.stack(x, dim=1) for x in zip(*outs))

    def _flush_spec_burst(self, pending, sampled, lps, top_lps,
                          top_ids) -> None:
        """Emit a verify burst: accept the longest draft prefix that
        matches plain decode's samples, then emit the SAMPLES (the
        accepted drafts are those samples; the first mismatch is the
        corrected token, so every row moves by one at least). Roll back
        the pages appended for rejected positions, in the target's pool
        and the drafter's, and feed each request's adaptive latch."""
        cfg = self.config
        emitted_seqs = []
        rollbacks = []
        draft_rollbacks = []
        for seq in pending["active"]:
            r = seq.req
            allow = pending["allows"].get(r.request_id, 1)
            draft = pending["drafts"].get(r.request_id, [])
            if self.scheduler.slots[seq.slot] is not seq:
                # Finished, aborted or preempted between launch and flush:
                # its pages went wholesale.
                continue
            j = accepted_prefix_len(draft, sampled[seq.slot])
            want_lp = r.sampling.logprobs
            emitted = 0
            for s in range(j + 1):
                if self.scheduler.slots[seq.slot] is not seq:
                    break  # finished mid-burst (EOS, stop, max_tokens)
                lp = None
                if want_lp is not None:
                    k = min(want_lp, top_lps.shape[2])
                    lp = {"logprob": float(lps[seq.slot, s]),
                          "top": [(int(top_ids[seq.slot, s, jj]),
                                   float(top_lps[seq.slot, s, jj]))
                                  for jj in range(k)]}
                self._emit_token(seq, int(sampled[seq.slot, s]), lp)
                emitted += 1
            r.scheduled_steps += emitted
            self.generation_tokens_total += emitted
            self.spec_proposed_tokens_total += len(draft)
            self.spec_accepted_tokens_total += j
            source = r.spec.source if r.spec is not None else "ngram"
            self.spec_proposed_by_source[source] = (
                self.spec_proposed_by_source.get(source, 0) + len(draft))
            self.spec_accepted_by_source[source] = (
                self.spec_accepted_by_source.get(source, 0) + j)
            if r.spec is not None and r.spec.judge(
                    len(draft), j, cfg.speculative_accept_window,
                    cfg.speculative_accept_threshold):
                self.spec_disabled_requests_total += 1
            rollbacks.append((r.request_id, allow - emitted))
            if self._draft is not None:
                # The drafter fed len(draft) - 1 drafts past the pre-burst
                # length; keep the accepted ones (all fed drafts when the
                # whole draft landed).
                n_before = len(r.all_token_ids) - emitted
                draft_rollbacks.append(
                    (r.request_id,
                     n_before + min(j, max(len(draft) - 1, 0))))
            if emitted and self.scheduler.slots[seq.slot] is seq:
                emitted_seqs.append(seq)
        with self._lock:
            for rid, n in rollbacks:
                # Stale device pages past the accepted tail stay: every
                # later step writes its own position before attention
                # reads it.
                self.kv_mgr.rollback_tokens(rid, n)
            for rid, keep in draft_rollbacks:
                self._draft.truncate(rid, keep)
            for seq in emitted_seqs:
                self.kv_mgr.register_decode_blocks(
                    seq.req.request_id, seq.req.all_token_ids)

    # -- per-request sampling inputs ---------------------------------------
    def _bias_rows(self, biases):
        """[R, MAX_LOGIT_BIAS] (ids, values) of sparse logit_bias rows
        (deterministic order, out-of-vocab ids and excess entries dropped;
        padding adds 0.0 to token 0)."""
        ids = np.zeros((len(biases), MAX_LOGIT_BIAS), np.int64)
        vals = np.zeros((len(biases), MAX_LOGIT_BIAS), np.float32)
        vocab = self.model_config.vocab_size
        for i, bias in enumerate(biases):
            items = sorted((tid, val) for tid, val in (bias or {}).items()
                           if 0 <= tid < vocab)[:MAX_LOGIT_BIAS]
            for j, (tid, val) in enumerate(items):
                ids[i, j], vals[i, j] = tid, val
        return (to_device(torch.from_numpy(ids), self.device),
                to_device(torch.from_numpy(vals), self.device))

    def _stop_rows(self, stop_lists):
        """[R, MAX_STOP_IDS] (ids, valid) of stop_token_ids rows."""
        ids = np.zeros((len(stop_lists), MAX_STOP_IDS), np.int64)
        valid = np.zeros((len(stop_lists), MAX_STOP_IDS), np.float32)
        vocab = self.model_config.vocab_size
        for i, stops in enumerate(stop_lists):
            kept = [t for t in (stops or []) if 0 <= t < vocab][:MAX_STOP_IDS]
            for j, tid in enumerate(kept):
                ids[i, j], valid[i, j] = tid, 1.0
        return (to_device(torch.from_numpy(ids), self.device),
                to_device(torch.from_numpy(valid), self.device))

    def _resume_bias(self, req: EngineRequest) -> "dict | None":
        """logit_bias for the prefill sample: the request's own, plus — on
        preemption-resume with penalties — the penalty terms of the most
        frequent prior output tokens (the burst applies exact counts from
        the next step on)."""
        bias = dict(req.sampling.logit_bias or {})
        pres = req.sampling.presence_penalty
        freq = req.sampling.frequency_penalty
        if req.output_token_ids and (pres or freq):
            from collections import Counter

            top = Counter(req.output_token_ids).most_common(MAX_LOGIT_BIAS)
            for tid, cnt in top:
                bias[tid] = bias.get(tid, 0.0) - freq * cnt - pres
        return bias or None

    def _sampling_for(self, r: EngineRequest):
        """(temperature, clamped top_k, top_p, seed) of a request; an
        unseeded request draws under a seed from its id."""
        seed = (r.sampling.seed if r.sampling.seed is not None
                else hash(r.request_id) % (2**31))
        return (r.sampling.temperature,
                min(r.sampling.top_k, self.config.max_top_k),
                r.sampling.top_p, seed)

    def _emit_token(self, seq: RunningSeq, token: int,
                    lp: Optional[dict] = None) -> None:
        """Deliver one generated token: ``(token, lp)`` when the request
        asked for logprobs, else the bare int."""
        req = seq.req
        req.output_token_ids.append(token)
        if req.structured is not None and not req.structured.advance(token):
            # The token left the grammar (the mask makes this unreachable):
            # counted, and the request latches mask-off and finishes
            # unconstrained.
            self.structured_violations_total += 1
            logger.warning("Structured request %s emitted token %d outside "
                           "its grammar", req.request_id, token)
        if req.trace is not None:
            now = time.time()
            if not req.trace.first_token:
                req.trace.first_token = now
            req.trace.last_token = now
            req.trace.tokens += 1
        finish = None
        n_out = len(req.output_token_ids)
        min_ok = n_out >= req.sampling.min_tokens
        if (not req.sampling.ignore_eos) and self._eos_id >= 0 \
                and token == self._eos_id and min_ok:
            finish = "stop"
        elif req.sampling.stop_token_ids and min_ok \
                and token in req.sampling.stop_token_ids:
            finish = "stop"
        elif n_out >= req.sampling.max_tokens:
            finish = "length"
        elif len(req.all_token_ids) >= self.config.max_model_len:
            finish = "length"
        req.on_token(token if lp is None else (token, lp), None)
        if finish is not None:
            st = req.structured
            if st is not None and not st.dead and not st.accepting:
                # Finished (length cap, stop id) mid-structure: the stream
                # is not a whole member of the grammar.
                self.structured_violations_total += 1
            with self._lock:
                self.scheduler.finish(seq, finish)
            self.requests_finished_total += 1


class _Readback:
    """The outputs of a dispatch and their copies to the host, started
    right behind the dispatch's launches (on a card: asynchronous copies
    into pinned memory and an event), so that :meth:`get` waits for this
    dispatch only, not for work launched after it. The outputs of an op
    captured for a fused step are a :class:`_FusedPlaceholder`: the
    copies start when the fused dispatch fills it."""

    def __init__(self, outs):
        self.event = None
        self.host = None
        self.placeholder = (outs if isinstance(outs, _FusedPlaceholder)
                            else None)
        if self.placeholder is None:
            self._start(outs)
        else:
            outs.waiters.append(self._start)

    def _start(self, outs) -> None:
        if outs[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in outs]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(outs)

    @property
    def ready(self) -> bool:
        """False while the op waits in a fused capture."""
        return self.placeholder is None or self.placeholder.ready

    def get(self):
        """The outputs as numpy arrays, once their copies have landed;
        raises the error of a fused dispatch that failed."""
        _unwrap_fused(self.placeholder)
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


def _prefill_arrays(R: int, bucket: int, maxb: int, row_bytes: int) -> dict:
    """Host arrays of an R-row prefill dispatch, every row padding: token
    0 at positions 0, seq_len 0, context 1, an all-zero table, slot -1,
    greedy, seed 0, step 1 and the FSM mask off (the JAX engine's padding
    rows)."""
    return {
        "tokens": np.zeros((R, bucket), np.int64),
        "positions": np.zeros((R, bucket), np.int64),
        "slots": np.full((R, bucket), -1, np.int64),
        "table": np.zeros((R, maxb), np.int32),
        "context": np.ones((R,), np.int64),
        "seq_lens": np.zeros((R,), np.int64),
        "adapter": np.zeros((R,), np.int64),
        "temp": np.zeros((R,), np.float32),
        "top_k": np.zeros((R,), np.int64),
        "top_p": np.ones((R,), np.float32),
        "seeds": np.zeros((R,), np.int64),
        "steps": np.ones((R,), np.int64),
        "suppress": np.zeros((R,), bool),
        "bias": [None] * R,
        "stops": [None] * R,
        "mask_bits": np.zeros((R, row_bytes), np.uint8),
        "mask_on": np.zeros((R,), bool),
    }


def _leaf_map(fn, x):
    """``fn`` over a page leaf: a tensor, or an int8 (data, scales) pair."""
    if isinstance(x, (tuple, list)):
        return tuple(fn(t) for t in x)
    return fn(x)


def _leaves_of(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _leaves(tree):
    """Every tensor of nested dicts, tuples and lists (None skipped)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _tree_map(fn, tree):
    """``fn`` over every tensor of a parameter dict (nested dicts)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stacked(entries, to_card):
    """Block-major ``[N, ...]`` leaves of per-block ``(k, v)`` entries on
    the card: ``(k, v)``, each a tensor or an int8 (data, scales) pair."""
    def side(i):
        first = entries[0][i]
        if isinstance(first, (tuple, list)):
            return tuple(torch.stack([to_card(e[i][j]) for e in entries])
                         for j in range(len(first)))
        return torch.stack([to_card(e[i]) for e in entries])

    return side(0), side(1)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat ``uint8`` view (what gloo's
    point-to-point sends, whatever the dtype)."""
    return t.view(-1).view(torch.uint8)
