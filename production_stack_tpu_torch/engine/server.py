"""OpenAI-compatible HTTP server over the torch ``EngineCore``.

Standard library only (``http.server.ThreadingHTTPServer``; one thread
per connection, server-sent events written by hand for ``stream: true``,
``/metrics`` as plain Prometheus text). Routes:

- ``POST /v1/completions`` and ``POST /v1/chat/completions``, plain and
  streamed (``data: {...}`` events ending with ``data: [DONE]``), with
  structured output (``guided_json``, ``guided_regex``,
  ``response_format``; compiled here, an uncompilable one is a 400),
  ``n > 1`` (``n`` engine requests, choice ``i > 0`` as ``"{id}-c{i}"``
  under seed ``base + i``; streamed chunks carry each choice's
  ``index``, interleaved from a merged queue fed by a thread a choice)
  and, on chat, ``tools`` (a system preamble, and tool calls parsed from
  the whole text: a streamed response with tools is buffered);
- ``GET /v1/models`` (the served names and every loaded LoRA adapter,
  with its ``parent``), ``GET /health`` and ``GET /healthz`` (503 while
  draining);
- ``POST /v1/embeddings`` (a string, strings, one id list or id lists),
  ``POST /v1/score`` and ``/score`` (cosine of pooled embeddings,
  ``text_1`` broadcast, one embed call per distinct text), ``POST
  /v1/rerank`` and ``/rerank``, ``POST /tokenize``, ``POST /detokenize``
  and ``GET /version``, with the JAX server's bodies;
- ``POST /v1/audio/transcriptions`` answers 501 with the JAX server's
  pointer to an ASR pod (``engine/asr_server.py``);
- the lifecycle of the stack's control plane: ``POST /sleep?level=N``,
  ``POST /wake_up``, ``GET /is_sleeping`` (generation and embeddings
  answer 503 while the engine sleeps) and ``POST /drain?timeout_s=N``
  (admission to the inference surface stops with 503 + ``Retry-After``,
  ``/health`` turns 503, the KV-controller heartbeat and resync stop and
  then ``/kv/deregister`` goes out; ``drained`` once nothing is in
  flight, else 202 ``draining``);
- LoRA hot-swap: ``POST /v1/load_lora_adapter``, ``POST
  /v1/unload_lora_adapter``, ``GET /v1/lora_adapters``; a request whose
  ``model`` names a loaded adapter runs in its slot (an unknown model is
  a 404);
- ``GET /metrics`` with the series the router's scraper parses
  (``vllm:num_requests_running``/``_waiting``,
  ``vllm:gpu_cache_usage_perc``, ``vllm:gpu_prefix_cache_hits_total``/
  ``_queries_total``), their ``tpu:`` twins, ``tpu:hbm_headroom_bytes``,
  ``tpu:kv_cache_bytes_per_token`` labelled with ``kv_cache_dtype``,
  ``tpu:engine_sleeping``, ``tpu:engine_draining``,
  ``tpu:lora_requests_total{adapter}`` once an adapter has served, and
  the JAX server's ``tpu:spec_*`` series (speculative decoding), its
  ``tpu:structured_*`` series and, with the step recorder on, its
  ``tpu:step_*`` series and ``tpu:model_bandwidth_utilization``; its
  scheduler series (``tpu:preempted_requests_total{priority}``,
  ``tpu:rejected_requests_total{reason}``, ``tpu:prefill_chunks_total``,
  ``tpu:deferred_prefill_tokens_total``,
  ``tpu:batched_token_utilization``, ``tpu:fused_steps_total``,
  ``tpu:prefill_attention_dispatch_total{path}``,
  ``tpu:pool_shrink_retries_total``) and its tracing series
  (``tpu:{queue,prefill,decode}_time_seconds``,
  ``tpu:slow_requests_total``, ``tpu:trace_sampled_out_total``,
  ``tpu:slow_trace_logs_suppressed_total``);
- ``GET /debug/steps`` (step recorder on): newest-first step records
  under the recorder's summary; filters ``?limit=50`` and
  ``?kind=decode_burst``, 400 on a bad one, as the JAX engine serves it;
- ``GET /debug/traces`` (``?min_duration_s=``, ``?limit=``) and ``GET
  /debug/traces/{request_id}`` (``?format=otlp``): each served request's
  stage timeline (queue, prefill, decode), joined to the caller's W3C
  ``traceparent``; ``--trace-sample-rate``, ``--trace-buffer``,
  ``--trace-export``, ``--slow-trace-threshold-s``,
  ``--slow-trace-log-interval-s``;
- ``POST /debug/profile`` (``{"duration_s": 2}``: a ``torch.profiler``
  capture into ``--profile-dir``; 409 while one runs), ``GET
  /debug/profile/artifacts`` and ``GET /debug/profile/artifacts/{name}``;
- ``GET /debug/loop`` (``--loop-monitor``; ``?blockers=N``): the
  interpreter-lock lag monitor's rollups and top blockers
  (``obs/looplag.py``), with the JAX server's
  ``tpu:event_loop_lag_*`` and ``tpu:loop_stalls_total{bucket}`` series
  (``--loop-stall-threshold-ms``); none of them without the flag;
- KV movement, as the JAX server answers it: ``POST /kv/extract`` (a
  prompt's cached prefix pages as one TKV2 payload, written buffer by
  buffer under one ``Content-Length``; 404 without a cached block),
  ``POST /kv/inject`` (the inverse), ``POST /kv/pull`` (the decode side
  of disaggregated prefill: ``{"source_url", "request", "kv_path":
  "auto" | "host" | "device"}``; rungs local-device (a server of this
  process, card to card), then the KV device pipe (the source's
  ``/kv/prepare_pull``; its pages' CUDA IPC handles opened here when
  both engines share a host, else the pages received over a two-rank
  NCCL communicator, gloo on the CPU, at the answer's
  ``transfer_port``; 501 for ``"device"`` when the pipe is unavailable
  or the pull fails), then the TKV2 host relay from the source's
  ``/kv/extract``, then ``status: "l3"`` when the prefix sits in this
  engine's offload tier; the answer's ``transfer.path`` names the rung
  that ran, and ``transfer.transport`` the pipe's transport; 503 with
  ``Retry-After: 1`` past ``--kv-pull-max-concurrency`` pulls in
  flight), ``POST /kv/prepare_pull`` (the pipe's sender side: the
  offer's uuid, token, leaves and ``transfer_port``, its IPC handles
  only for a puller whose ``host_key`` is this host's; 501 without a
  pipe, 404 without a cached prefix, 503 when the offer table is full)
  and ``POST /kv/release``. Under tensor, pipeline or data parallelism
  every KV route and the lifecycle answer as on one rank (the relay
  serves a pull from a sharded engine);
- with ``--kv-controller-url``, the engine's side of the router's KV
  controller: it registers, heartbeats, resyncs its claim digest and
  reports every admitted prompt's text chunks and every eviction (on
  threads of their own: the engine thread only enqueues).

With a deployment key (``--api-key``, ``VLLM_API_KEY``, ...) the
inference surface, every ``/kv/*`` route and the ``/debug`` routes answer
401 without ``Authorization: Bearer <key>``; ``/health``, ``/healthz``,
``/metrics``, ``/version`` and the lifecycle routes stay open, as on the
JAX server. The server's own calls (a peer's ``/kv/extract``, the KV
controller) carry the key.

The router's headers: ``X-Request-Id`` becomes the request id and comes
back on the response; ``X-Priority`` (``interactive`` / ``batch``) sets
the scheduling class that preemption picks its victims by. A prompt that
can never fit the KV pool gets 503 with ``Retry-After: 1``, and so does
one the scheduler refuses for KV capacity before its first token.

The engine warms up (``EngineCore.warmup``: every serving program once
on dummy rows) before the socket is bound, so ``/health`` first answers
a warm engine; ``--no-warmup`` skips it, and the first requests then pay
for the kernels' build and load and each shape's first launch. A
request's trace is recorded just before its response's last bytes are
written (the body of a whole response, the ``data: [DONE]`` of a
stream), so a client that reads ``/debug/traces/{id}`` right after its
response finds it.

A request that fails inside the engine finishes with ``finish_reason:
"error"``. The JAX server's event-loop monitor (``--loop-monitor``,
``/debug/loop``) is not here: this server runs a thread a connection and
has no event loop to watch.

    python -m production_stack_tpu_torch.engine.server <model> --port N \\
        [--device cuda|cpu] [--kv-cache-dtype int8] [--quantization int8] \\
        [--prefill-batch 4] [--enable-chunked-prefill] \\
        [--max-num-batched-tokens N] [--no-step-recorder] \\
        [--structured-cache-size 32] \\
        [--kv-offload-gb 4] [--kv-remote-url URL] \\
        [--kv-controller-url ROUTER --advertise-url URL] \\
        [--speculative-num-tokens 4 [--speculative-ngram-size 3] \\
         [--speculative-draft-model M --speculative-draft-probation 64]] \\
        [--api-key KEY] [--trace-sample-rate 1.0] [--profile-dir DIR] \\
        [--no-warmup]

``<model>`` is a preset name or a local HF checkpoint directory
(``config.json`` with ``*.safetensors`` or ``pytorch_model*.bin``), whose
weights are then served.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import queue
import struct
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from production_stack_tpu_torch import __version__
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGIT_BIAS,
    SamplingParams,
)
from production_stack_tpu_torch.engine.scheduler import parse_priority
from production_stack_tpu_torch.engine.tokenizer import IncrementalDetokenizer
from production_stack_tpu_torch.engine.tools import (
    parse_tool_calls,
    render_tools_preamble,
    tool_names,
)
from production_stack_tpu_torch.kv.controller import (
    CHUNK_SIZE,
    chunk_hashes,
    claim_digest,
    path_keys,
)
from production_stack_tpu_torch.kv.offload import (
    pack_transfer_buffers,
    unpack_transfer,
)
from production_stack_tpu_torch.obs.looplag import LoopMonitor
from production_stack_tpu_torch.obs.steps import STEP_KINDS
from production_stack_tpu_torch.obs.trace import StageClock, TraceRecorder
from production_stack_tpu_torch.parallel import multihost
from production_stack_tpu_torch.structured.api import compile_char_dfa
from production_stack_tpu_torch.utils import auth
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

MAX_BODY_BYTES = 32 << 20
# A TKV2 payload is a prompt's whole prefix over every layer: 268 MB for
# 2,048 tokens of Llama-3-8B in bf16.
MAX_KV_BODY_BYTES = 16 << 30
# How long a handler waits for the engine's next token before giving up.
TOKEN_TIMEOUT_S = 600.0
# The debug routes this server serves; all of them are privileged
# (``utils/auth.py``), so with a key configured each needs it.
DEBUG_ROUTES = (("GET", "/debug/steps"), ("GET", "/debug/traces"),
                ("GET", "/debug/traces/{request_id}"),
                ("POST", "/debug/profile"),
                ("GET", "/debug/profile/artifacts"),
                ("GET", "/debug/profile/artifacts/{name}"))


def needs_key(path: str) -> bool:
    """The paths that take the deployment key when one is set, as the JAX
    engine gates them: the inference surface, the privileged control
    plane and every ``/kv/*`` route (raw cache pages)."""
    return (auth.is_gated(path) or auth.is_privileged(path)
            or path.startswith("/kv/"))


class BadRequest(Exception):
    """An error answer. ``headers`` ride the response; ``traced`` marks a
    refusal after admission began, which the JAX server records as a
    trace (the KV-capacity pre-check)."""

    def __init__(self, message: str, status: int = 400,
                 kind: str = "BadRequestError", headers=None,
                 traced: bool = False):
        super().__init__(message)
        self.status = status
        self.kind = kind
        self.headers = headers or {}
        self.traced = traced


class EngineServer:
    """The OpenAI surface of one engine: request parsing, the token
    stream from the engine thread, and the response bodies."""

    # Servers of THIS process by bound port: a pull from one of them
    # moves pages card to card (the local-device rung).
    _local_peers: "dict[str, EngineServer]" = {}

    def __init__(self, core: EngineCore, served_models: List[str],
                 kv_controller_url: Optional[str] = None,
                 advertise_url: Optional[str] = None,
                 instance_id: Optional[str] = None,
                 kv_heartbeat_interval: float = 10.0,
                 kv_resync_interval: float = 30.0,
                 kv_pull_max_concurrency: int = 8,
                 api_key: Optional[str] = None,
                 trace_buffer: int = 512,
                 trace_sample_rate: float = 1.0,
                 trace_export: Optional[str] = None,
                 slow_trace_threshold_s: float = 0.0,
                 slow_trace_log_interval_s: float = 0.0,
                 profile_dir: Optional[str] = None,
                 loop_monitor: bool = False,
                 loop_stall_threshold_ms: float = 100.0):
        self.core = core
        self.config = core.config
        self.served_models = served_models
        self.start_time = time.time()
        # Deployment keys (--api-key, VLLM_API_KEY, TPU_STACK_API_KEY or a
        # keyfile); the first one rides this server's own outbound calls.
        self.api_keys = auth.resolve_api_keys(api_key)
        self.api_key = self.api_keys[0] if self.api_keys else None
        # Per-request stage traces (queue, prefill, decode), served at
        # /debug/traces and rolled up into tpu:*_time_seconds.
        self.trace_recorder = TraceRecorder(
            "tpu-stack-engine", capacity=trace_buffer,
            slow_threshold_s=slow_trace_threshold_s, export=trace_export,
            sample_rate=trace_sample_rate,
            slow_log_interval_s=slow_trace_log_interval_s)
        # POST /debug/profile: one torch.profiler capture at a time, its
        # artifacts under profile_dir, served back under
        # /debug/profile/artifacts/.
        self.profile_dir = profile_dir or os.path.join(
            tempfile.gettempdir(), f"tpu-stack-profiles-{os.getpid()}")
        self._profile_lock = threading.Lock()
        self._profile_runs = 0
        # Interpreter-lock lag (--loop-monitor, obs/looplag.py): a ticker
        # thread's wake-up lateness and the watchdog's blocking frames,
        # at GET /debug/loop and as the JAX server's tpu:event_loop_*
        # series. None when off: no thread, no route, no series.
        self.loop_monitor = None
        if loop_monitor:
            self.loop_monitor = LoopMonitor(
                "tpu-stack-engine",
                stall_threshold_s=float(loop_stall_threshold_ms) / 1000.0)
        # -- the KV controller's engine side ------------------------------
        self.kv_controller_url = (kv_controller_url.rstrip("/")
                                  if kv_controller_url else None)
        self.advertise_url = advertise_url
        self.instance_id = instance_id or f"engine-{uuid.uuid4().hex[:8]}"
        # A fresh generation a process: a restart on the same URL is a new
        # incarnation, whose registration sweeps the old one's claims.
        self.generation = uuid.uuid4().hex
        self.kv_heartbeat_interval = float(kv_heartbeat_interval)
        self.kv_resync_interval = float(kv_resync_interval)
        self._kv_registered = False
        self._kv_stop = threading.Event()
        self._kv_threads: List[threading.Thread] = []
        # Reports (admit, evict) run in order on one thread.
        self._reports: "queue.Queue[Optional[Callable[[], None]]]" = (
            queue.Queue())
        # Admission registry: this engine's page chain hashes -> the
        # controller's text-chunk hashes of the prompts that admitted
        # them, so an eviction is reported as root-anchored chunk paths.
        self._adm_lock = threading.Lock()
        self._admissions: "OrderedDict[int, tuple]" = OrderedDict()
        self._block_admissions: "dict[int, set]" = {}
        self._adm_counter = itertools.count(1)
        self._bound_port: Optional[int] = None
        # -- /kv/pull admission and the transfer counters -----------------
        self.kv_pull_max_concurrency = max(1, int(kv_pull_max_concurrency))
        self._kv_lock = threading.Lock()
        self._pull_inflight = 0
        self.kv_pull_rejected_total = 0
        self.kv_transfer_tx_bytes = 0
        self.kv_transfer_rx_bytes = 0
        self.kv_transfer_rx_seconds = 0.0
        self.kv_transfer_pulls = 0
        self.kv_transfer_device_pulls = 0
        self.kv_transfer_device_bytes = 0
        self.kv_transfer_device_seconds = 0.0
        # Pulls answered from the offload tier (the peer missed, the
        # prefix is in host RAM or the L3): prefill restores it.
        self.l3_pull_hits = 0
        self.l3_pull_blocks = 0
        # The KV device pipe (kv/device_pipe.py), made at its first use;
        # None once found unavailable (the host relay serves instead).
        self._device_pipe = None
        self._device_pipe_failed = False
        self._pipe_lock = threading.Lock()
        # Per-adapter request metering (tpu:lora_requests_total{adapter}).
        self.lora_request_counts: "dict[str, int]" = {}
        # Graceful drain: once draining, the inference surface answers
        # 503 and /health 503; requests of that surface in flight are
        # counted so /drain knows when the replica is quiescent.
        self.draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- helpers -------------------------------------------------------------
    def authorized(self, path: str, authorization: Optional[str]) -> bool:
        """False when ``path`` takes the deployment key and the request's
        ``Authorization`` header does not carry one of the keys."""
        return (not self.api_keys or not needs_key(path)
                or auth.check_bearer(authorization, self.api_keys))

    def _auth_headers(self) -> dict:
        """Headers of this server's own outbound calls (the KV controller,
        a peer's /kv/extract): every tier of a keyed deployment presents
        the shared key."""
        return auth.auth_headers(self.api_key)

    def check_model(self, model: str) -> None:
        """404 unless ``model`` is served here: a served name, the
        configured model, or a loaded LoRA adapter."""
        if (model not in self.served_models and model != self.config.model
                and model not in self.core.lora_slots):
            raise BadRequest(f"model {model!r} not found", 404,
                             "NotFoundError")

    def resolve_adapter(self, model: str) -> str:
        """The LoRA adapter a request's ``model`` names ("" for none)."""
        return model if model in self.core.lora_slots else ""

    def check_awake(self) -> None:
        if self.core.is_sleeping:
            raise BadRequest("engine is sleeping", 503, "ServiceUnavailable")

    def parse_sampling(self, body: dict, default_max_tokens: int):
        """The request's SamplingParams; a malformed field or a structured
        constraint that does not compile is a 400 (the automaton is
        compiled here, before admission, and memoized, so the engine's
        own compile is a cache hit)."""
        try:
            sampling = SamplingParams.from_request(
                body, default_max_tokens=default_max_tokens)
            if sampling.structured is not None:
                compile_char_dfa(sampling.structured)
        except ValueError as exc:  # StructuredError is a ValueError
            raise BadRequest(str(exc))
        if sampling.logit_bias and len(sampling.logit_bias) > MAX_LOGIT_BIAS:
            raise BadRequest(
                f"logit_bias supports at most {MAX_LOGIT_BIAS} entries on "
                f"this engine (got {len(sampling.logit_bias)})")
        return sampling

    def check_prompt(self, prompt_ids: List[int]) -> None:
        """400 for a prompt past ``max_model_len``, 503 with ``Retry-After``
        for one that can never fit the KV pool; each counted under its
        reason in ``rejected_total``, as the JAX engine counts them."""
        reason = None
        if len(prompt_ids) >= self.config.max_model_len:
            reason, exc = "length", BadRequest(
                f"prompt ({len(prompt_ids)} tokens) exceeds max_model_len "
                f"{self.config.max_model_len}")
        elif self.core.kv_never_fits(len(prompt_ids)):
            reason, exc = "kv_capacity", BadRequest(
                f"prompt ({len(prompt_ids)} tokens) exceeds this engine's "
                f"KV cache capacity", 503, "ServiceUnavailable",
                headers={"Retry-After": "1"}, traced=True)
        if reason is not None:
            with self.core._lock:
                rejected = self.core.scheduler.rejected_total
                rejected[reason] = rejected.get(reason, 0) + 1
            raise exc

    def lp_entry(self, token_id: int, lp: dict) -> dict:
        """One OpenAI chat-logprobs content entry."""
        def entry(tid, logprob):
            text = self.core.tokenizer.decode([tid])
            return {"token": text, "logprob": logprob,
                    "bytes": list(text.encode())}

        return dict(entry(token_id, lp["logprob"]), top_logprobs=[
            entry(tid, tlp) for tid, tlp in lp["top"]])

    @staticmethod
    def completions_logprobs(entries: List[dict]) -> dict:
        """Chat-style entries -> the legacy completions logprobs object."""
        offsets, pos = [], 0
        for e in entries:
            offsets.append(pos)
            pos += len(e["token"])
        return {
            "tokens": [e["token"] for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [{t["token"]: t["logprob"]
                              for t in e["top_logprobs"]} for e in entries],
            "text_offset": offsets,
        }

    @staticmethod
    def apply_stop(text_so_far: str, delta: str, stop):
        """(emit_delta, stopped): stop strings end the output, unemitted."""
        if not stop:
            return delta, False
        combined = text_so_far + delta
        for s in stop:
            idx = combined.find(s)
            if idx >= 0:
                return combined[len(text_so_far):idx], True
        return delta, False

    def generate(self, body: dict, kind: str,
                 request_id: Optional[str] = None, priority: int = 0,
                 clock: Optional[StageClock] = None):
        """Admit a request's ``n`` choices. Returns (request id, model,
        prompt ids, sampling, a token stream of :meth:`_stream` a choice);
        parsing errors raise BadRequest before anything reaches the
        engine. The request id is ``request_id`` (the router's
        ``X-Request-Id``) or a fresh one; every choice runs at
        ``priority`` (``X-Priority``), choice 0 stamping ``clock``. Choice
        ``i > 0`` runs as ``"{rid}-c{i}"`` under seed ``base + i``,
        ``base`` the request's seed or, unseeded, the seed the engine
        draws choice 0 under."""
        model = body.get("model", self.config.model)
        self.check_model(model)
        self.check_awake()
        adapter = self.resolve_adapter(model)
        tok = self.core.tokenizer
        text, offsets = None, None  # the admission report's prompt text
        if kind == "chat":
            messages = body.get("messages", [])
            tools = body.get("tools") or []
            if tools and body.get("tool_choice") != "none":
                # The function schemas and the <tool_call> output contract
                # lead the system context; tool_choice "none" skips both
                # the preamble and the output parsing.
                messages = [{"role": "system",
                             "content": render_tools_preamble(
                                 tools, body.get("tool_choice", "auto"))}
                            ] + list(messages)
            text = tok.apply_chat_template(messages)
            prompt_ids, offsets = self._encode_prompt(text)
            sampling = self.parse_sampling(body, default_max_tokens=128)
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list) and prompt and isinstance(prompt[0],
                                                                  list):
                prompt = prompt[0]
            if isinstance(prompt, list) and prompt and all(
                    isinstance(t, int) for t in prompt):
                prompt_ids = [int(t) for t in prompt]
            else:
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
                text = str(prompt)
                prompt_ids, offsets = self._encode_prompt(text)
            sampling = self.parse_sampling(body, default_max_tokens=16)
        if clock is not None:
            clock.prompt_tokens = len(prompt_ids)
        self.check_prompt(prompt_ids)
        if text is not None:
            self._report_kv_admission(text, prompt_ids, offsets, adapter)
        if adapter:
            self.lora_request_counts[adapter] = (
                self.lora_request_counts.get(adapter, 0) + 1)
        rid = request_id or (f"{'chatcmpl' if kind == 'chat' else 'cmpl'}-"
                             f"{uuid.uuid4().hex[:16]}")
        streams = [self._admit(rid, prompt_ids, sampling, adapter,
                               priority=priority, clock=clock)]
        base_seed = (sampling.seed if sampling.seed is not None
                     else hash(rid) % (2**31))
        for i in range(1, sampling.n):
            streams.append(self._admit(
                f"{rid}-c{i}", prompt_ids,
                dataclasses.replace(sampling, seed=base_seed + i, n=1),
                adapter, priority=priority))
        return rid, model, prompt_ids, sampling, streams

    def _admit(self, rid: str, prompt_ids: List[int], sampling,
               adapter: str = "", priority: int = 0,
               clock: Optional[StageClock] = None):
        """Queue one engine request; returns its token stream."""
        tokens: "queue.Queue" = queue.Queue()
        self.core.add_request(rid, prompt_ids, sampling,
                              lambda t, f: tokens.put((t, f)),
                              adapter_name=adapter or None, trace=clock,
                              priority=priority)
        return self._stream(rid, tokens, sampling)

    def record_trace(self, rid: str, model: str, clock: StageClock,
                     traceparent: Optional[str]) -> None:
        """Record a served request's stage timeline (the JAX server's
        spans: ``engine.request`` over ``engine.queue``, and
        ``engine.prefill`` and ``engine.decode`` once they started),
        joined to the caller's trace through ``traceparent``."""
        rec = self.trace_recorder
        now = time.time()
        trace = rec.begin(rid, traceparent)
        root = trace.start_span(
            "engine.request", start=clock.arrival, model=model,
            prompt_tokens=clock.prompt_tokens, tokens=clock.tokens)
        trace.add_span("engine.queue", clock.arrival,
                       clock.prefill_start or now, parent=root)
        if clock.prefill_start:
            trace.add_span(
                "engine.prefill", clock.prefill_start,
                clock.prefill_end or clock.prefill_start, parent=root,
                prompt_tokens=clock.prompt_tokens,
                cached_tokens=clock.cached_tokens,
                uncached_tokens=max(
                    0, clock.prompt_tokens - clock.cached_tokens),
                preemptions=clock.preemptions,
                prefill_chunks=clock.prefill_chunks)
        if clock.first_token:
            decode_start = clock.prefill_end or clock.first_token
            trace.add_span(
                "engine.decode", decode_start,
                max(clock.last_token, decode_start), parent=root,
                steps=clock.tokens, tokens=clock.tokens,
                time_to_first_token_s=round(
                    clock.first_token - clock.arrival, 6))
        root.finish(end=now, tokens=clock.tokens)
        rec.record(trace)

    def _stream(self, rid, tokens: "queue.Queue", sampling):
        """Yields (text_delta, logprob_entry | None, finish | None,
        is_token) until a finish reason arrives."""
        detok = IncrementalDetokenizer(self.core.tokenizer)
        text_so_far = ""
        try:
            while True:
                try:
                    payload, finish = tokens.get(timeout=TOKEN_TIMEOUT_S)
                except queue.Empty:
                    yield "", None, "error", False
                    return
                entry = None
                if payload is None:
                    # Bytes held back as a partial UTF-8 sequence at the
                    # finish are dropped, as the JAX server drops them.
                    delta, is_token = "", False
                    finish = finish or "stop"
                else:
                    token_id, lp = (payload if isinstance(payload, tuple)
                                    else (payload, None))
                    if lp is not None:
                        entry = self.lp_entry(token_id, lp)
                    delta, is_token = detok.push(token_id), True
                emit, stopped = self.apply_stop(text_so_far, delta,
                                                sampling.stop)
                text_so_far += emit
                if stopped:
                    finish = "stop"
                yield emit, entry, finish, is_token
                if finish is not None:
                    return
        finally:
            # Finished, stopped by a stop string, or the client went away:
            # the engine drops the request (a no-op once it has finished).
            self.core.abort_request(rid)

    # -- the KV controller's engine side ---------------------------------
    def start_kv_reporting(self, host: str, port: int) -> None:
        """Hook the eviction report, register this server as a local peer
        (by bound port) and, with a controller URL, register with the
        controller and start the heartbeat, resync and report threads."""
        self._bound_port = port
        EngineServer._local_peers[str(port)] = self
        self.core.prefix_evict_listener = self._on_prefix_evict
        if self.kv_controller_url is None:
            return
        if self.advertise_url is None:
            self.advertise_url = f"http://{host}:{port}"
        self._kv_register()
        loops = [("kv-report", self._report_loop)]
        if self.kv_heartbeat_interval > 0:
            loops.append(("kv-heartbeat", self._heartbeat_loop))
        if self.kv_resync_interval > 0:
            loops.append(("kv-resync", self._resync_loop))
        for name, fn in loops:
            th = threading.Thread(target=fn, daemon=True, name=name)
            th.start()
            self._kv_threads.append(th)

    def close(self) -> None:
        """Stop the reporting threads, close the KV device pipe and drop
        the local-peer entry, so a recycled port never resolves to this
        server's frozen pool."""
        self._kv_stop.set()
        self._reports.put(None)
        if self.loop_monitor is not None:
            self.loop_monitor.stop()
        for th in self._kv_threads:
            th.join(timeout=10)
        self._kv_threads = []
        with self._pipe_lock:
            pipe, self._device_pipe = self._device_pipe, None
        if pipe is not None:
            pipe.close()
        if (self._bound_port is not None and EngineServer._local_peers.get(
                str(self._bound_port)) is self):
            del EngineServer._local_peers[str(self._bound_port)]

    def _post_json(self, path: str, body: dict, timeout: float = 5.0,
                   base: Optional[str] = None):
        """(status, JSON body or {}) of a POST to the controller (or to a
        peer engine at ``base``); (None, {}) when it cannot be reached."""
        req = urllib.request.Request(
            (base or self.kv_controller_url).rstrip("/") + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **self._auth_headers()})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                raw = resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            return e.code, {}
        except (urllib.error.URLError, OSError) as e:
            logger.debug("POST %s to %s failed: %s", path,
                         base or "the KV controller", e)
            return None, {}
        try:
            out = json.loads(raw.decode() or "{}")
        except ValueError:
            out = {}
        return status, out if isinstance(out, dict) else {}

    def _kv_register(self) -> bool:
        status, _ = self._post_json("/kv/register", {
            "instance_id": self.instance_id, "url": self.advertise_url,
            "generation": self.generation,
            "heartbeat_interval": self.kv_heartbeat_interval})
        self._kv_registered = status == 200
        return self._kv_registered

    def _report_loop(self) -> None:
        while True:
            job = self._reports.get()
            try:
                if job is None:
                    return
                job()
            except Exception:  # noqa: BLE001 - a lost report: resync heals
                logger.exception("KV report failed")
            finally:
                self._reports.task_done()

    def _heartbeat_loop(self) -> None:
        """Lease renewal. An unknown instance (the controller restarted,
        or superseded this record) re-registers and pushes its state; a
        revived one (its lease had expired and its claims were swept)
        pushes its state."""
        while not self._kv_stop.wait(self.kv_heartbeat_interval):
            status, body = self._post_json("/kv/heartbeat", {
                "instance_id": self.instance_id,
                "generation": self.generation,
                "heartbeat_interval": self.kv_heartbeat_interval,
                "url": self.advertise_url})
            if status != 200:
                continue
            if not body.get("known"):
                if self._kv_register():
                    self._kv_resync(force=True)
            elif body.get("revived"):
                logger.info("KV lease revived; resyncing swept claims")
                self._kv_resync(force=True)

    def _resync_loop(self) -> None:
        while not self._kv_stop.wait(self.kv_resync_interval):
            try:
                self._kv_resync()
            except Exception as e:  # noqa: BLE001 - resync is best-effort
                logger.debug("KV resync failed: %s", e)

    def _admitted_paths(self) -> "list[list[int]]":
        """The root-anchored chunk-hash paths this engine still serves."""
        paths, seen = [], set()
        with self._adm_lock:
            for chunks, _blocks in self._admissions.values():
                t = tuple(int(h) for h in chunks)
                if t and t not in seen:
                    seen.add(t)
                    paths.append(list(t))
        return paths

    def _kv_resync(self, force: bool = False) -> None:
        """Anti-entropy: compare claim digests with the controller and, on
        a mismatch (or ``force``), replace this engine's claims."""
        paths = self._admitted_paths()
        keys: "set[int]" = set()
        for p in paths:
            keys.update(path_keys(p))
        count, xor = claim_digest(keys)
        if not force:
            status, check = self._post_json("/kv/resync", {
                "instance_id": self.instance_id, "count": count, "xor": xor})
            if status != 200 or check.get("match"):
                return
            if not check.get("known") and not self._kv_register():
                return
        status, body = self._post_json("/kv/resync_state", {
            "instance_id": self.instance_id, "paths": paths}, timeout=10.0)
        if status == 200 and body.get("swept"):
            logger.info("KV resync: swept %s drifted claims, %s claim "
                        "nodes reasserted", body.get("swept"),
                        body.get("claims", 0))

    def _encode_prompt(self, text: str):
        """(ids, per-token char offsets | None); the offsets only when a
        controller is wired (the admission registry needs them)."""
        tok = self.core.tokenizer
        if self.kv_controller_url is not None and hasattr(
                tok, "encode_with_offsets"):
            return tok.encode_with_offsets(text)
        return tok.encode(text), None

    def _report_kv_admission(self, text: str, ids: List[int],
                             offsets: Optional[List[int]],
                             adapter: str = "") -> None:
        """Queue the admission of a prompt: its registry entry, then
        ``/kv/admit`` with the prompt text, salted with the adapter's name
        for an adapter request (registering first if the controller has
        not accepted this instance yet)."""
        if self.kv_controller_url is None or not text:
            return

        def job():
            self._track_admission(text, list(ids), offsets, adapter)
            if not self._kv_registered and not self._kv_register():
                return
            body = {"instance_id": self.instance_id, "text": text}
            if adapter:
                body["salt"] = adapter
            self._post_json("/kv/admit", body)

        self._reports.put(job)

    def _track_admission(self, text: str, ids: List[int],
                         offsets: Optional[List[int]],
                         adapter: str = "") -> None:
        """Map this prompt's page chain hashes to the controller's text
        chunks (by each block's first token's character offset), so an
        eviction names exactly the chunks its chain covered."""
        chunks = chunk_hashes(text, salt=adapter or None)
        n = len(ids)
        if not chunks or n == 0:
            return
        bs = self.config.block_size
        if offsets is None or len(offsets) != n:
            offsets = self.core.tokenizer.token_char_offsets(text, ids)
        blocks = [(h, min(offsets[j * bs] // CHUNK_SIZE, len(chunks) - 1))
                  for j, h in enumerate(
                      self.core.kv_mgr.chain_hashes(ids, adapter))]
        if not blocks:
            return
        aid = next(self._adm_counter)
        with self._adm_lock:
            self._admissions[aid] = (chunks, blocks)
            for bh, _ in blocks:
                self._block_admissions.setdefault(bh, set()).add(aid)
            while len(self._admissions) > 1024:
                old_aid, (_, old_blocks) = self._admissions.popitem(False)
                for bh, _ in old_blocks:
                    members = self._block_admissions.get(bh)
                    if members is not None:
                        members.discard(old_aid)
                        if not members:
                            del self._block_admissions[bh]

    def _on_prefix_evict(self, prefix_hash: int, bid: int) -> None:
        """The engine's eviction listener (engine thread, maybe under its
        lock; fires only without an offload tier): queue ``/kv/evict``
        with the root-anchored chunk path down to each affected
        admission's first dead chunk. Never reported as spilled."""
        paths, seen = [], set()
        with self._adm_lock:
            aids = self._block_admissions.get(prefix_hash)
            if not aids:
                return
            for aid in list(aids):
                entry = self._admissions.pop(aid, None)
                if entry is None:
                    continue
                chunks, blocks = entry
                cut = next((cs for bh, cs in blocks if bh == prefix_hash),
                           None)
                if cut is not None:
                    path = tuple(int(h) for h in chunks[:cut + 1])
                    if path and path not in seen:
                        seen.add(path)
                        paths.append(list(path))
                for bh, _ in blocks:
                    members = self._block_admissions.get(bh)
                    if members is not None:
                        members.discard(aid)
                        if not members:
                            del self._block_admissions[bh]
        if paths and self.kv_controller_url is not None:
            self._reports.put(lambda: self._post_json(
                "/kv/evict", {"instance_id": self.instance_id,
                              "paths": paths}))

    # -- KV transfer -----------------------------------------------------
    def tokens_from_body(self, body: dict) -> List[int]:
        """Token ids of a KV request: ``token_ids``, chat ``messages`` or a
        ``prompt`` (text or ids), as the serving path tokenizes them."""
        tok = self.core.tokenizer
        if body.get("token_ids"):
            return [int(t) for t in body["token_ids"]]
        if body.get("messages") is not None:
            return tok.encode(tok.apply_chat_template(body["messages"]))
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return [int(t) for t in prompt]
        return tok.encode(str(prompt))

    def _resolve_local_peer(self, source_url: str) -> "EngineServer | None":
        """A live server of this process behind ``source_url`` whose pool
        has this one's page layout, else None."""
        parsed = urllib.parse.urlparse(source_url)
        if parsed.hostname not in ("127.0.0.1", "localhost", "::1"):
            return None
        peer = EngineServer._local_peers.get(str(parsed.port))
        if peer is None or peer is self:
            return None
        if (peer.core.model_config != self.core.model_config
                or peer.core.config.block_size != self.config.block_size
                or not peer.core._running):
            return None
        return peer

    def _l3_probe(self, token_ids: List[int]) -> int:
        """Leading blocks of ``token_ids`` held by the offload tier (host
        RAM or the remote L3); 0 without a tier."""
        offload = self.core.offload
        if offload is None:
            return 0
        blocks = 0
        for h in self.core.kv_mgr.chain_hashes(token_ids):
            if not offload.contains(h):
                break
            blocks += 1
        return blocks

    def _l3_fallback(self, token_ids: List[int]) -> Optional[dict]:
        """The peer missed: ``status: "l3"`` when the tier holds the
        prefix (prefill restores it), else None."""
        blocks = self._l3_probe(token_ids)
        if blocks <= 0:
            return None
        with self._kv_lock:
            self.l3_pull_hits += 1
            self.l3_pull_blocks += blocks
        return {"status": "l3", "injected_blocks": 0, "l3_blocks": blocks,
                "num_tokens": blocks * self.config.block_size}

    def kv_pull(self, body: dict, request_id: Optional[str] = None,
                traceparent: Optional[str] = None):
        """(status, body, headers) of ``POST /kv/pull``, admission-gated
        at ``kv_pull_max_concurrency`` transfers in flight; an admitted
        pull is recorded as an ``engine.kv_transfer`` trace."""
        with self._kv_lock:
            if self._pull_inflight >= self.kv_pull_max_concurrency:
                self.kv_pull_rejected_total += 1
                return 503, {
                    "status": "rejected",
                    "error": "pull admission full "
                             f"({self.kv_pull_max_concurrency} in flight)"}, {
                    "Retry-After": "1"}
            self._pull_inflight += 1
        t0 = time.time()
        try:
            status, out = self._kv_pull(body)
        finally:
            with self._kv_lock:
                self._pull_inflight -= 1
        trace = self.trace_recorder.begin(
            request_id or f"kvpull-{uuid.uuid4().hex[:12]}", traceparent)
        attrs = {"status": status, "result": out.get("status", "error"),
                 "injected_blocks": out.get("injected_blocks", 0)}
        transfer = out.get("transfer") or {}
        attrs.update({k: transfer[k] for k in ("path", "bytes",
                                               "total_seconds")
                      if k in transfer})
        trace.add_span("engine.kv_transfer", t0, time.time(), **attrs)
        self.trace_recorder.record(trace)
        return status, out, {}

    def _kv_pull(self, body: dict):
        source = body.get("source_url")
        if not source:
            return 400, {"error": "source_url required"}
        req_body = body.get("request", body)
        if not isinstance(req_body, dict):
            return 400, {"error": "request must be a JSON object"}
        token_ids = self.tokens_from_body(req_body)
        kv_path = body.get("kv_path", "auto")
        if kv_path not in ("auto", "host", "device"):
            return 400, {"error": f"unknown kv_path {kv_path!r}"}
        bs = self.config.block_size
        peer = self._resolve_local_peer(source) if kv_path == "auto" else None
        if peer is not None:
            t0 = time.monotonic()
            try:
                injected = self.core.inject_from_core(
                    peer.core, token_ids,
                    self.resolve_adapter(req_body.get("model", "")))
            except Exception as e:  # noqa: BLE001 - fall to the next rung
                logger.warning("local-device pull failed, falling back: %s",
                               e)
                injected = 0
            if injected > 0:
                total = time.monotonic() - t0
                nbytes = injected * self.core._kv_bytes_per_block()
                with self._kv_lock:
                    self.kv_transfer_device_pulls += 1
                    self.kv_transfer_device_bytes += nbytes
                    self.kv_transfer_device_seconds += total
                    self.kv_transfer_pulls += 1
                return 200, {
                    "status": "ok", "injected_blocks": injected,
                    "num_tokens": injected * bs,
                    "transfer": {
                        "path": "local-device", "bytes": nbytes,
                        "total_seconds": round(total, 6),
                        "gigabytes_per_second": round(
                            nbytes / max(total, 1e-9) / 1e9, 6)}}
        if kv_path in ("auto", "device"):
            result = self._pull_device(source, token_ids, req_body)
            if result is not None:
                return 200, result
            if kv_path == "device":
                return 501, {"error": "device path unavailable"}
        t0 = time.monotonic()
        req = urllib.request.Request(
            source.rstrip("/") + "/kv/extract",
            data=json.dumps({"token_ids": token_ids,
                             "model": req_body.get("model", "")}).encode(),
            headers={"Content-Type": "application/json",
                     **self._auth_headers()})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                data = resp.read()
        except urllib.error.HTTPError:
            # The peer has no cached prefix: the L3 before a recompute.
            return 200, (self._l3_fallback(token_ids)
                         or {"status": "miss", "injected_blocks": 0})
        except (urllib.error.URLError, OSError) as e:
            l3 = self._l3_fallback(token_ids)
            if l3 is not None:
                return 200, l3
            return 502, {"error": f"source unreachable: {e}"}
        fetch_seconds = time.monotonic() - t0
        try:
            payload = unpack_transfer(data)
        except (ValueError, KeyError, struct.error) as e:
            logger.warning("bad TKV2 payload from %s: %s", source, e)
            return 200, (self._l3_fallback(token_ids)
                         or {"status": "miss", "injected_blocks": 0})
        injected = self.core.inject_kv(payload["hashes"], payload["k"],
                                       payload["v"])
        total = time.monotonic() - t0
        with self._kv_lock:
            self.kv_transfer_rx_bytes += len(data)
            self.kv_transfer_rx_seconds += total
            self.kv_transfer_pulls += 1
        return 200, {
            "status": "ok", "injected_blocks": injected,
            "num_tokens": payload["num_tokens"],
            "transfer": {
                "path": "host", "bytes": len(data),
                # fetch: the source's extract and the HTTP transfer; total
                # adds the inject here. Handoff throughput, not a link's.
                "fetch_seconds": round(fetch_seconds, 6),
                "total_seconds": round(total, 6),
                "gigabytes_per_second": round(
                    len(data) / max(fetch_seconds, 1e-9) / 1e9, 6)}}

    # -- the KV device pipe ----------------------------------------------
    def _get_device_pipe(self):
        """The KV device pipe, made at first use (the availability probe
        runs then); None when the pipe is unavailable here."""
        from production_stack_tpu_torch.kv.device_pipe import (
            KVDevicePipe,
            device_pipe_available,
        )

        with self._pipe_lock:
            if self._device_pipe is None and not self._device_pipe_failed:
                try:
                    if device_pipe_available():
                        self._device_pipe = KVDevicePipe(self.core.device)
                    else:
                        self._device_pipe_failed = True
                except Exception as e:  # noqa: BLE001 - relay instead
                    logger.warning("KV device pipe init failed: %s", e)
                    self._device_pipe_failed = True
            return self._device_pipe

    def kv_prepare_pull(self, body: dict):
        """(status, body) of ``POST /kv/prepare_pull``, the sender's side
        of the pipe: the prompt's cached prefix pages gathered on the
        device and parked for the puller. The answer names the offer
        (``uuid``, ``token``), its leaves' shapes and dtypes, and the
        pipe's ``transfer_port`` (the network transport, as in the JAX
        answer); it carries the pages' IPC handles only when the body's
        ``host_key`` is this host's. 501 without a pipe; 404 without a
        cached prefix (and in a job of several ranks, whose pulls the
        relay serves); 503 when the offer table is full."""
        from production_stack_tpu_torch.kv.device_pipe import leaf_specs

        pipe = self._get_device_pipe()
        if pipe is None:
            return 501, {"error": "device pipe unavailable on this backend"}
        payload = self.core.extract_kv_device(
            self.tokens_from_body(body),
            self.resolve_adapter(body.get("model", "")))
        if payload is None:
            return 404, {"error": "no cached prefix for these tokens"}
        leaves = [t for side in (payload["k"], payload["v"])
                  for t in (side if isinstance(side, tuple) else (side,))]
        same_host = body.get("host_key") == pipe.host
        uuid_ = pipe.offer(leaves, ipc=same_host)
        if uuid_ is None:
            return 503, {"error": "device pipe offer capacity exhausted"}
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        with self._kv_lock:
            self.kv_transfer_tx_bytes += nbytes
        k = leaves[0]
        out = {
            "uuid": uuid_, "token": pipe.token(uuid_),
            "address": pipe.address(), "transfer_port": pipe.transfer_port,
            "leaves": leaf_specs(leaves),
            "hashes": [int(h) for h in payload["hashes"]],
            "num_tokens": payload["num_tokens"], "shape": list(k.shape),
            "dtype": str(k.dtype).replace("torch.", ""), "bytes": nbytes}
        if same_host:
            out["handles"] = pipe.handles(uuid_)
        return 200, out

    def kv_release(self, body: dict) -> dict:
        """``POST /kv/release``: a pulled (or abandoned) offer frees its
        slot and its parked pages."""
        if self._device_pipe is not None and "uuid" in body:
            self._device_pipe.release(int(body["uuid"]))
        return {"status": "ok"}

    def _pull_device(self, source: str, token_ids: List[int],
                     req_body: dict) -> Optional[dict]:
        """The pipe's rung of ``/kv/pull``: the source's
        ``/kv/prepare_pull`` (with this host's key), the pull of its
        offer (over IPC when the answer carries handles, else over the
        network transport at the source URL's host and the answer's
        ``transfer_port``, as the JAX puller joins them), the release of
        its offer slot (whether or not the pull ran, and before the
        inject, whose failure must not keep the slot), then the inject.
        None to fall to the relay."""
        pipe = self._get_device_pipe()
        if pipe is None:
            return None
        t0 = time.monotonic()
        status, offer = self._post_json(
            "/kv/prepare_pull",
            {"token_ids": token_ids, "model": req_body.get("model", ""),
             "host_key": pipe.host},
            timeout=30, base=source)
        if status != 200:
            return None
        if "handles" in offer:
            address, specs = offer["address"], offer["handles"]
        elif "leaves" in offer:
            host = urllib.parse.urlparse(source).hostname
            address, specs = f"{host}:{offer['transfer_port']}", offer[
                "leaves"]
        else:  # a source whose pipe this one cannot pull from
            address = None
        cost: dict = {}
        got = None
        if address is not None:
            try:
                got = pipe.pull(address, offer["uuid"], specs,
                                device=self.core.device, stats=cost,
                                token=offer.get("token"))
            except Exception as e:  # noqa: BLE001 - the peer or transport
                logger.warning("device pull failed, falling back: %s", e)
        # A handle the pull opened keeps its block alive on its own (CUDA
        # IPC's reference count), and a network pull has received its
        # pages, so the sender may let the offer go now.
        for attempt in range(3):
            status, _ = self._post_json("/kv/release",
                                        {"uuid": offer["uuid"]}, base=source)
            if status is not None and status < 300:
                break
            if attempt == 2:
                logger.warning("kv/release to %s failed; its offer slot %s "
                               "stays held", source, offer["uuid"])
            else:
                time.sleep(0.2 * (attempt + 1))
        if got is None:
            return None
        half = len(got) // 2
        k, v = (tuple(x) if len(x) > 1 else x[0]
                for x in (got[:half], got[half:]))
        try:
            injected = self.core.inject_kv_blocks(
                [int(h) for h in offer["hashes"]], k, v)
        except Exception as e:  # noqa: BLE001 - local pool pressure etc.
            logger.warning("device pull injected 0 blocks, falling back: %s",
                           e)
            return None
        total = time.monotonic() - t0
        nbytes = int(offer.get("bytes", 0))
        with self._kv_lock:
            self.kv_transfer_device_pulls += 1
            self.kv_transfer_device_bytes += nbytes
            self.kv_transfer_device_seconds += total
            self.kv_transfer_pulls += 1
        # The pull alone: over IPC opening the peer's handles and copying
        # its pages out; over the network the pair's rendezvous (the first
        # pull's) and the transfer.
        return {"status": "ok", "injected_blocks": injected,
                "num_tokens": offer["num_tokens"],
                "transfer": {
                    "path": "device", "bytes": nbytes,
                    "total_seconds": round(total, 6),
                    "gigabytes_per_second": round(
                        nbytes / max(total, 1e-9) / 1e9, 6),
                    **{key: round(val, 6) if isinstance(val, float) else val
                       for key, val in cost.items()}}}

    # -- embeddings, score, rerank, tokenizer ------------------------------
    def embeddings(self, body: dict) -> dict:
        """``POST /v1/embeddings``: ``input`` is a string, strings, one id
        list or id lists."""
        self.check_awake()
        inputs = body.get("input", [])
        if isinstance(inputs, str):
            inputs = [inputs]
        elif isinstance(inputs, list) and inputs and all(
                isinstance(t, int) for t in inputs):
            inputs = [inputs]
        data, total_tokens = [], 0
        for i, text in enumerate(inputs):
            if isinstance(text, list):
                ids = [int(t) for t in text]  # pre-tokenized
            else:
                ids = self.core.tokenizer.encode(str(text))
            total_tokens += len(ids)
            data.append({"object": "embedding", "index": i,
                         "embedding": self._embed(ids)})
        return {"object": "list",
                "model": body.get("model", self.config.model), "data": data,
                "usage": {"prompt_tokens": total_tokens,
                          "total_tokens": total_tokens}}

    def _embed(self, ids: List[int]) -> List[float]:
        try:
            return self.core.embed(ids)
        except RuntimeError as exc:  # fell asleep meanwhile
            raise BadRequest(str(exc), 503, "ServiceUnavailable")

    def _embed_texts(self, texts: List[str]):
        """Embeddings of ``texts`` (one forward a distinct text) and the
        token count over every occurrence."""
        cache: dict = {}
        total, out = 0, []
        for text in texts:
            if text not in cache:
                ids = self.core.tokenizer.encode(text)
                cache[text] = (self._embed(ids), len(ids))
            emb, n_tokens = cache[text]
            total += n_tokens
            out.append(emb)
        return out, total

    @staticmethod
    def _as_text_list(value) -> Optional[List[str]]:
        if isinstance(value, str):
            return [value]
        if isinstance(value, list) and all(isinstance(t, str) for t in value):
            return list(value)
        return None

    @staticmethod
    def _dot(a: List[float], b: List[float]) -> float:
        # Embeddings are L2-normalised: the dot product is the cosine.
        return float(sum(x * y for x, y in zip(a, b)))

    def score(self, body: dict) -> dict:
        """``POST /v1/score``: cosine similarity of pooled embeddings of
        ``text_1`` (one text broadcast, or a list pairing element-wise)
        and ``text_2``."""
        self.check_awake()
        list_1 = self._as_text_list(body.get("text_1"))
        list_2 = self._as_text_list(body.get("text_2"))
        if list_1 is None or list_2 is None:
            raise BadRequest("text_1 and text_2 are required and must each "
                             "be a string or a list of strings")
        if len(list_1) == 1:
            list_1 = list_1 * len(list_2)
        if len(list_1) != len(list_2):
            raise BadRequest(
                f"text_1 ({len(list_1)}) and text_2 ({len(list_2)}) must "
                "pair up (or text_1 must be a single text)")
        embs, total = self._embed_texts(list_1 + list_2)
        emb_1, emb_2 = embs[:len(list_1)], embs[len(list_1):]
        return {
            "id": f"score-{uuid.uuid4().hex[:16]}", "object": "list",
            "created": int(time.time()),
            "model": body.get("model", self.config.model),
            "data": [{"index": i, "object": "score", "score": self._dot(a, b)}
                     for i, (a, b) in enumerate(zip(emb_1, emb_2))],
            "usage": {"prompt_tokens": total, "total_tokens": total}}

    def rerank(self, body: dict) -> dict:
        """``POST /v1/rerank``: ``documents`` scored against ``query``,
        the ``top_n`` best first."""
        self.check_awake()
        query, documents = body.get("query"), body.get("documents")
        if not query or not isinstance(documents, list) or not documents:
            raise BadRequest(
                "query and a non-empty documents list are required")
        documents = [d.get("text", "") if isinstance(d, dict) else str(d)
                     for d in documents]
        try:
            top_n = int(body.get("top_n", len(documents)))
        except (TypeError, ValueError):
            raise BadRequest("top_n must be an integer")
        embs, total = self._embed_texts([str(query)] + documents)
        q_emb = embs[0]
        ranked = sorted(
            ({"index": i, "document": {"text": doc},
              "relevance_score": self._dot(q_emb, emb)}
             for i, (doc, emb) in enumerate(zip(documents, embs[1:]))),
            key=lambda r: r["relevance_score"], reverse=True)[:max(top_n, 0)]
        return {"id": f"rerank-{uuid.uuid4().hex[:16]}",
                "model": body.get("model", self.config.model),
                "usage": {"total_tokens": total}, "results": ranked}

    def tokenize(self, body: dict) -> dict:
        tok = self.core.tokenizer
        text = body.get("prompt")
        if text is None and "messages" in body:
            text = tok.apply_chat_template(body["messages"])
        ids = tok.encode(text or "")
        return {"tokens": ids, "count": len(ids),
                "max_model_len": self.config.max_model_len}

    def detokenize(self, body: dict) -> dict:
        return {"prompt": self.core.tokenizer.decode(body.get("tokens", []))}

    # -- LoRA adapters -----------------------------------------------------
    def load_lora(self, body: dict):
        name = body.get("lora_name")
        if not name:
            return 400, {"error": "lora_name required"}
        if not self.core.load_lora_adapter(name, rank=body.get("lora_rank")):
            return 400, {"error": f"could not load adapter {name!r} "
                                  "(no free slots or LoRA disabled)"}
        return 200, {"status": "ok", "lora_name": name}

    def unload_lora(self, body: dict):
        name = body.get("lora_name")
        if not self.core.unload_lora_adapter(name or ""):
            return 400, {"error": f"adapter {name!r} not loaded"}
        return 200, {"status": "ok", "lora_name": name}

    def lora_adapters(self) -> dict:
        """The residency surface the router's adapter registry scrapes
        (slot 0 is the base model: ``max_loras - 1`` slots load)."""
        max_loras = int(self.config.max_loras)
        return {"adapters": [{"lora_name": n, "slot": s}
                             for n, s in self.core.lora_slots.items()],
                "max_loras": max_loras,
                "capacity": max(max_loras - 1, 0),
                "base_model": self.config.model}

    def models(self) -> dict:
        now = int(self.start_time)
        owner = "production-stack-tpu-torch"
        return {"object": "list", "data": [
            {"id": m, "object": "model", "created": now, "owned_by": owner}
            for m in self.served_models] + [
            {"id": name, "object": "model", "created": now,
             "owned_by": owner, "parent": self.config.model}
            for name in self.core.lora_slots]}

    # -- lifecycle ---------------------------------------------------------
    def drain(self, query: dict):
        """(status, body) of ``POST /drain?timeout_s=``: stop admitting
        the inference surface, stop the KV-controller heartbeat and
        resync (a beat after the deregistration would register again),
        post ``/kv/deregister``, then wait until nothing is in flight,
        at most ``timeout_s`` (30 by default). Repeat calls only wait."""
        try:
            timeout_s = float(query.get("timeout_s", "30"))
        except ValueError:
            return 400, {"error": {"message": "timeout_s must be a number",
                                   "type": "BadRequestError"}}
        first_drain = not self.draining
        self.draining = True
        if first_drain:
            logger.info("Drain requested: admission stopped, %d in flight",
                        self._inflight)
            self._stop_kv_leases()
            if self.kv_controller_url is not None:
                self._post_json("/kv/deregister",
                                {"instance_id": self.instance_id})
                self._kv_registered = False
        deadline = time.monotonic() + max(0.0, timeout_s)
        while self._inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        drained = self._inflight == 0
        return (200 if drained else 202,
                {"status": "drained" if drained else "draining",
                 "in_flight": self._inflight})

    def _stop_kv_leases(self) -> None:
        """Stop the heartbeat and resync threads (the report thread keeps
        draining its queue)."""
        self._kv_stop.set()
        leases = [th for th in self._kv_threads if th.name != "kv-report"]
        for th in leases:
            th.join(timeout=10)
        self._kv_threads = [th for th in self._kv_threads
                            if th not in leases]

    def metrics_text(self) -> str:
        s = self.core.stats()
        labels = f'model_name="{self.config.model}"'
        headroom = s.get("hbm_headroom_bytes")
        rows = [
            ("vllm:num_requests_running", "gauge", s["num_requests_running"]),
            ("vllm:num_requests_waiting", "gauge", s["num_requests_waiting"]),
            ("vllm:gpu_cache_usage_perc", "gauge", f"{s['kv_usage']:.6f}"),
            ("tpu:hbm_kv_usage_perc", "gauge", f"{s['kv_usage']:.6f}"),
            ("vllm:gpu_prefix_cache_hits_total", "counter",
             s["prefix_cache_hits"]),
            ("vllm:gpu_prefix_cache_queries_total", "counter",
             s["prefix_cache_queries"]),
            ("tpu:prefix_cache_hits_total", "counter", s["prefix_cache_hits"]),
            ("tpu:prefix_cache_queries_total", "counter",
             s["prefix_cache_queries"]),
            ("vllm:prompt_tokens_total", "counter", s["prompt_tokens_total"]),
            ("vllm:generation_tokens_total", "counter",
             s["generation_tokens_total"]),
            ("vllm:request_success_total", "counter",
             s["requests_finished_total"]),
            ("vllm:num_preemptions_total", "counter",
             s["num_preempted_total"]),
            ("tpu:num_kv_blocks", "gauge", s["num_blocks"]),
            ("tpu:hbm_headroom_bytes", "gauge",
             0 if headroom is None else headroom),
            ("tpu:kv_cache_bytes_per_token", "gauge",
             s["kv_cache_bytes_per_token"],
             f',kv_cache_dtype="{s["kv_cache_dtype"]}"'),
            ("tpu:engine_sleeping", "gauge", int(s["is_sleeping"])),
            ("tpu:engine_draining", "gauge", int(self.draining)),
            ("tpu:cached_prompt_tokens_total", "counter",
             s["cached_tokens_total"]),
            ("tpu:decode_forward_steps_total", "counter",
             s["decode_forward_steps_total"]),
            # Structured output: grammar constraints compiled to token FSMs
            # whose masks join the logit shaping.
            ("tpu:structured_requests_total", "counter",
             s["structured_requests_total"]),
            ("tpu:structured_compile_seconds_total", "counter",
             f"{s['structured_compile_seconds_total']:.6f}"),
            ("tpu:structured_mask_states_total", "counter",
             s["structured_mask_states_total"]),
            ("tpu:structured_violations_total", "counter",
             s["structured_violations_total"]),
            # Disaggregated-prefill handoff (both rungs) and /kv/pull
            # admission.
            ("tpu:kv_transfer_tx_bytes_total", "counter",
             self.kv_transfer_tx_bytes),
            ("tpu:kv_transfer_rx_bytes_total", "counter",
             self.kv_transfer_rx_bytes),
            ("tpu:kv_transfer_rx_seconds_total", "counter",
             f"{self.kv_transfer_rx_seconds:.6f}"),
            ("tpu:kv_transfer_pulls_total", "counter", self.kv_transfer_pulls),
            ("tpu:kv_transfer_device_pulls_total", "counter",
             self.kv_transfer_device_pulls),
            ("tpu:kv_transfer_device_bytes_total", "counter",
             self.kv_transfer_device_bytes),
            ("tpu:kv_transfer_device_seconds_total", "counter",
             f"{self.kv_transfer_device_seconds:.6f}"),
            ("tpu:kv_pull_inflight", "gauge", self._pull_inflight),
            ("tpu:kv_pull_rejected_total", "counter",
             self.kv_pull_rejected_total),
            # Evictions dispatched without an offload tier, and listener
            # calls that raised (reports the resync has to heal).
            ("tpu:prefix_evicts_total", "counter", s["prefix_evicts_total"]),
            ("tpu:evict_listener_errors_total", "counter",
             s["evict_listener_errors_total"]),
            # Pool-shrink ladder rungs taken at the KV pool's allocation.
            ("tpu:pool_shrink_retries_total", "counter",
             s["pool_shrink_retries_total"]),
            # Chunked prefill: chunks dispatched, prompt tokens a step plan
            # deferred, the last plan's share of the token budget.
            ("tpu:prefill_chunks_total", "counter", s["prefill_chunks_total"]),
            ("tpu:deferred_prefill_tokens_total", "counter",
             s["deferred_prefill_tokens_total"]),
            ("tpu:batched_token_utilization", "gauge",
             f"{s['batched_token_utilization']:.6f}"),
            # Fused step (--fused-step): prefill-chunk + decode-burst pairs
            # launched as one dispatch.
            ("tpu:fused_steps_total", "counter", s["fused_steps_total"]),
            # Request tracing: slow requests, traces head sampling dropped
            # and slow-trace log lines the interval suppressed.
            ("tpu:slow_requests_total", "counter",
             self.trace_recorder.slow_requests),
            ("tpu:trace_sampled_out_total", "counter",
             self.trace_recorder.sampled_out_total),
            ("tpu:slow_trace_logs_suppressed_total", "counter",
             self.trace_recorder.slow_logs_suppressed_total),
        ]
        off = s["offload"]
        if off:
            rows += [("tpu:kv_offload_blocks", "gauge", off["blocks"]),
                     ("tpu:kv_offload_bytes", "gauge", off["bytes"]),
                     ("tpu:kv_offload_hits_total", "counter", off["hits"]),
                     ("tpu:kv_offload_misses_total", "counter",
                      off["misses"])]
            if off["remote"]:
                rows += [("tpu:l3_spill_blocks_total", "counter",
                          off["remote_put_blocks"]),
                         ("tpu:l3_spill_bytes_total", "counter",
                          off["remote_put_bytes"]),
                         ("tpu:l3_hit_blocks_total", "counter",
                          off["remote_get_blocks"]),
                         ("tpu:l3_hit_bytes_total", "counter",
                          off["remote_get_bytes"]),
                         ("tpu:l3_pull_hits_total", "counter",
                          self.l3_pull_hits)]
        lines = []
        for name, kind, value, *extra in rows:
            family = name[:-len("_total")] if kind == "counter" else name
            lines.append(f"# TYPE {family} {kind}")
            lines.append(f"{name}{{{labels}{''.join(extra)}}} {value}")
        # Every label value always present, so rate() never sees a series
        # vanish: preemptions by the victim's class, admission rejections
        # by reason, cached-prefill dispatches by attention route ("pallas"
        # is the kernel route here; the JAX engine's "xla" fallback has no
        # counterpart and stays 0).
        rejected = s["rejected_requests"]
        for family, label, values in (
                ("tpu:preempted_requests", "priority",
                 {k: s["preempted_by_priority"].get(k, 0)
                  for k in ("interactive", "batch")}),
                ("tpu:rejected_requests", "reason",
                 {k: rejected.get(k, 0) for k in sorted(
                     set(rejected) | {"length", "kv_capacity"})}),
                ("tpu:prefill_attention_dispatch", "path",
                 {k: s["prefill_attention_dispatch_total"].get(k, 0)
                  for k in ("pallas", "xla")})):
            lines.append(f"# TYPE {family} counter")
            lines += [f'{family}_total{{{labels},{label}="{k}"}} {n}'
                      for k, n in values.items()]
        # Request stage times from the trace recorder (sum/count pairs).
        stage = self.trace_recorder.stage_stats()
        for family, span in (("tpu:queue_time_seconds", "engine.queue"),
                             ("tpu:prefill_time_seconds", "engine.prefill"),
                             ("tpu:decode_time_seconds", "engine.decode")):
            total, count = stage.get(span, (0.0, 0))
            lines += [f"# TYPE {family} summary",
                      f"{family}_sum{{{labels}}} {total:.6f}",
                      f"{family}_count{{{labels}}} {count}"]
        # Per-adapter request metering: present once an adapter has served.
        if self.lora_request_counts:
            lines.append("# TYPE tpu:lora_requests counter")
            lines += [f'tpu:lora_requests_total{{{labels},adapter="{name}"}} '
                      f"{count}" for name, count
                      in sorted(self.lora_request_counts.items())]
        # Pages allocated on the card and blocks in the offload tier.
        lines.append("# TYPE tpu:kv_page_occupancy gauge")
        for tier, n in s["kv_page_occupancy"].items():
            lines.append(f'tpu:kv_page_occupancy{{{labels},tier="{tier}"}} '
                         f"{n}")
        # Speculative decoding, as the JAX server exports it: proposed and
        # accepted draft tokens by proposer (both label values always
        # present), the acceptance rate, latched-off requests, verify
        # bursts and the drafter's own forwards (not target forwards).
        proposed = s["spec_proposed_tokens_total"]
        rate = (s["spec_accepted_tokens_total"] / proposed
                if proposed else 0.0)
        for family, key in (("tpu:spec_proposed_tokens",
                             "spec_proposed_by_source"),
                            ("tpu:spec_accepted_tokens",
                             "spec_accepted_by_source")):
            lines.append(f"# TYPE {family} counter")
            for source in ("ngram", "draft_model"):
                lines.append(f'{family}_total{{{labels},source="{source}"}} '
                             f"{s[key].get(source, 0)}")
        lines += ["# TYPE tpu:spec_acceptance_rate gauge",
                  f"tpu:spec_acceptance_rate{{{labels}}} {rate:.6f}"]
        for family, key in (
                ("tpu:spec_disabled_requests",
                 "spec_disabled_requests_total"),
                ("tpu:spec_verify_bursts", "spec_verify_bursts_total"),
                ("tpu:spec_draft_forward_steps",
                 "spec_draft_forward_steps_total")):
            lines += [f"# TYPE {family} counter",
                      f"{family}_total{{{labels}}} {s[key]}"]
        rec = self.core.step_recorder
        if rec is not None:
            # Step flight recorder, as the JAX server exports it: every
            # kind always present, so rate() never sees a series vanish.
            kind_stats = rec.kind_stats()
            lines.append("# TYPE tpu:step_duration_seconds summary")
            for kind in sorted(kind_stats):
                kl, ks = f'{labels},kind="{kind}"', kind_stats[kind]
                lines += [f"tpu:step_duration_seconds_sum{{{kl}}} "
                          f"{ks['wall_s']:.6f}",
                          f"tpu:step_duration_seconds_count{{{kl}}} "
                          f"{ks['count']}"]
            for family, key in (("tpu:step_scheduled_tokens", "tokens"),
                                ("tpu:step_hbm_bytes", "hbm_bytes")):
                lines.append(f"# TYPE {family} counter")
                for kind in sorted(kind_stats):
                    lines.append(f'{family}_total{{{labels},kind="{kind}"}} '
                                 f"{kind_stats[kind][key]}")
            lines += ["# TYPE tpu:model_bandwidth_utilization gauge",
                      f"tpu:model_bandwidth_utilization{{{labels}}} "
                      f"{rec.bandwidth_utilization():.6f}"]
        mon = self.loop_monitor
        if mon is not None:
            # Interpreter-lock lag (--loop-monitor) under the JAX server's
            # event-loop names: lifetime sum and count, the ring's
            # rollups, stalls by severity bucket.
            pct = mon.percentiles()
            lines += [
                "# TYPE tpu:event_loop_lag_seconds summary",
                f"tpu:event_loop_lag_seconds_sum{{{labels}}} "
                f"{mon.lag_s_sum:.6f}",
                f"tpu:event_loop_lag_seconds_count{{{labels}}} "
                f"{mon.samples_total}",
                "# TYPE tpu:event_loop_lag_p50_seconds gauge",
                f"tpu:event_loop_lag_p50_seconds{{{labels}}} "
                f"{pct['p50']:.6f}",
                "# TYPE tpu:event_loop_lag_p99_seconds gauge",
                f"tpu:event_loop_lag_p99_seconds{{{labels}}} "
                f"{pct['p99']:.6f}",
                "# TYPE tpu:event_loop_lag_max_seconds gauge",
                f"tpu:event_loop_lag_max_seconds{{{labels}}} "
                f"{pct['max']:.6f}",
                "# TYPE tpu:loop_stalls counter",
            ]
            for bucket, count in sorted(mon.stalls().items()):
                lines.append(f'tpu:loop_stalls_total{{{labels},'
                             f'bucket="{bucket}"}} {count}')
        return "\n".join(lines) + "\n"

    def debug_traces(self, query: dict):
        """(status, body) of ``GET /debug/traces``: newest-first trace
        summaries, filtered by ``min_duration_s`` and ``limit``."""
        rec = self.trace_recorder
        try:
            min_duration = float(query.get("min_duration_s", 0) or 0)
        except ValueError:
            return 400, {"error": "min_duration_s must be a number"}
        try:
            limit = int(query.get("limit", 100) or 100)
        except ValueError:
            return 400, {"error": "limit must be an integer"}
        return 200, {"service": rec.service, "capacity": rec.capacity,
                     "recorded_total": rec.recorded_total,
                     "slow_requests": rec.slow_requests,
                     "traces": rec.list(min_duration_s=min_duration,
                                        limit=limit)}

    def debug_trace(self, request_id: str, query: dict):
        """(status, body) of ``GET /debug/traces/{request_id}``: the span
        timeline, or its OTLP-JSON form with ``?format=otlp``."""
        trace = self.trace_recorder.get(request_id)
        if trace is None:
            return 404, {"error": "trace not found"}
        if query.get("format") == "otlp":
            return 200, {"resourceSpans": [trace.to_otlp()]}
        return 200, trace.to_dict()

    def profile(self, body: dict):
        """(status, body) of ``POST /debug/profile``: a ``torch.profiler``
        capture of ``duration_s`` seconds (default 2, at most 60) of
        whatever the engine runs meanwhile (CPU ops and, on a card, its
        kernels), exported as a Chrome trace under ``profile_dir``. One
        capture at a time: a second one meanwhile gets 409."""
        try:
            duration_s = float(body.get("duration_s", 2.0))
        except (TypeError, ValueError):
            raise BadRequest("duration_s must be a number")
        if not duration_s > 0:
            raise BadRequest("duration_s must be > 0")
        duration_s = min(duration_s, 60.0)
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"error": {
                "message": "a profile capture is already running",
                "type": "Conflict"}}
        try:
            self._profile_runs += 1
            run = (f"run-{self._profile_runs:04d}-"
                   f"{time.strftime('%Y%m%d-%H%M%S')}")
            out_dir = os.path.join(self.profile_dir, run)
            result = self._capture_profile(out_dir, duration_s)
        finally:
            self._profile_lock.release()
        return (200 if result.get("ok") else 503), {
            "duration_s": duration_s, "run": run, "artifact_dir": out_dir,
            "artifacts_url": "/debug/profile/artifacts", **result}

    def _capture_profile(self, out_dir: str, duration_s: float) -> dict:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.core.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=activities)
        try:
            # On and off only between engine steps (see between_steps):
            # the steps in between run under the profiler as they come.
            with self.core.between_steps():
                prof.start()
            try:
                time.sleep(duration_s)
            finally:
                with self.core.between_steps():
                    prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        except Exception as e:  # noqa: BLE001 - reported, not raised
            return {"ok": False, "error": f"profiler failed: {e}"}
        return {"ok": True, "files": self.profile_files(out_dir)}

    def profile_files(self, root: Optional[str] = None) -> List[str]:
        """Artifact paths under ``root`` (default: every capture),
        relative to the profile directory."""
        files = []
        for base, _dirs, names in os.walk(root or self.profile_dir):
            files += [os.path.relpath(os.path.join(base, name),
                                      self.profile_dir) for name in names]
        return sorted(files)

    def profile_artifact(self, name: str) -> Optional[str]:
        """The file path of artifact ``name``, which must resolve inside
        the profile directory (400 otherwise); None when absent."""
        base = os.path.realpath(self.profile_dir)
        full = os.path.realpath(os.path.join(base, name))
        if not (full == base or full.startswith(base + os.sep)):
            raise BadRequest("invalid artifact path")
        return full if os.path.isfile(full) else None

    def debug_loop(self, query: dict):
        """``GET /debug/loop``: the monitor's summary and its top
        blockers (``?blockers=N``, default 10), as the JAX route."""
        try:
            blockers = int(query.get("blockers", 10) or 10)
        except ValueError:
            return 400, {"error": "blockers must be an integer"}
        if blockers < 1:
            return 400, {"error": "blockers must be >= 1"}
        out = self.loop_monitor.summary()
        out["top_blockers"] = self.loop_monitor.detector.top_blockers(
            limit=blockers)
        return 200, out

    def debug_steps(self, query: dict):
        """(status, body) of ``GET /debug/steps``: the recorder's summary,
        the pool's page occupancy and the newest-first records, filtered
        by ``limit`` and ``kind``; 400 on a bad filter."""
        rec = self.core.step_recorder
        try:
            limit = int(query.get("limit", 100) or 100)
        except ValueError:
            return 400, {"error": "limit must be an integer"}
        if limit < 1:
            return 400, {"error": "limit must be >= 1"}
        kind = query.get("kind") or None
        if kind is not None and kind not in STEP_KINDS:
            return 400, {"error": f"unknown kind {kind!r} "
                                  f"(one of: {', '.join(STEP_KINDS)})"}
        out = rec.summary()
        out["kv_page_occupancy"] = self.core.stats()["kv_page_occupancy"]
        out["steps"] = rec.snapshot(limit=limit, kind=kind)
        return 200, out


class _Handler(BaseHTTPRequestHandler):
    server_version = "production-stack-tpu-torch"
    engine: EngineServer  # set on the subclass built by build_server
    # (rid, model, clock, traceparent) of the request whose trace is not
    # recorded yet.
    _pending_trace: Optional[tuple] = None

    def log_message(self, fmt, *args):  # route access logs to our logger
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, obj, status: int = 200, headers=None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _send_error(self, exc: BadRequest) -> None:
        self._send_json({"error": {"message": str(exc), "type": exc.kind}},
                        exc.status, exc.headers)

    def _send_file(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _gated(self, path: str, handle) -> None:
        """Run ``handle()`` behind the deployment key (401 without it,
        its body read and dropped, so the close does not reset the
        connection under the answer); on the inference surface refuse
        it with 503 while draining, else count it in flight."""
        eng = self.engine
        if not eng.authorized(path, self.headers.get("Authorization")):
            length = int(self.headers.get("Content-Length") or 0)
            if 0 < length <= MAX_BODY_BYTES:
                self.rfile.read(length)
            self._send_json({"error": {
                "message": "invalid or missing API key",
                "type": "AuthenticationError"}}, 401)
            return
        if not auth.is_gated(path):
            handle()
            return
        if eng.draining:
            self._send_json({"error": {"message": "engine is draining",
                                       "type": "ServiceUnavailable"}}, 503,
                            {"Retry-After": "1"})
            return
        with eng._inflight_lock:
            eng._inflight += 1
        try:
            handle()
        finally:
            with eng._inflight_lock:
                eng._inflight -= 1

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.partition("?")[0]
        self._gated(path, lambda: self._get(path))

    def _get(self, path: str) -> None:
        qs = self.path.partition("?")[2]
        query = dict(urllib.parse.parse_qsl(qs))
        eng = self.engine
        if path == "/debug/steps" and eng.core.step_recorder is not None:
            status, body = eng.debug_steps(query)
            self._send_json(body, status)
        elif path == "/debug/loop" and eng.loop_monitor is not None:
            status, body = eng.debug_loop(query)
            self._send_json(body, status)
        elif path == "/debug/traces":
            status, body = eng.debug_traces(query)
            self._send_json(body, status)
        elif path.startswith("/debug/traces/"):
            status, body = eng.debug_trace(
                urllib.parse.unquote(path[len("/debug/traces/"):]), query)
            self._send_json(body, status)
        elif path == "/debug/profile/artifacts":
            self._send_json({"profile_dir": eng.profile_dir,
                             "files": eng.profile_files()})
        elif path.startswith("/debug/profile/artifacts/"):
            try:
                full = eng.profile_artifact(urllib.parse.unquote(
                    path[len("/debug/profile/artifacts/"):]))
            except BadRequest as exc:
                self._send_error(exc)
                return
            if full is None:
                self._send_json({"error": {"message": "artifact not found",
                                           "type": "NotFoundError"}}, 404)
            else:
                self._send_file(full)
        elif path in ("/health", "/healthz"):
            if eng.core.fatal_error is not None:
                self._send_json({"status": "failed",
                                 "error": eng.core.fatal_error}, 503)
            elif eng.draining:
                self._send_json({"status": "draining",
                                 "in_flight": eng._inflight}, 503,
                                {"Retry-After": "1"})
            else:
                body = {"status": "ok"}
                mhc = eng.core._mh
                if mhc is not None:
                    # Every rank joined by construction: report the span,
                    # as the JAX server does.
                    body.update({"role": "leader",
                                 "num_processes": mhc.num_processes,
                                 "mesh": dict(eng.core.layout.shape)})
                self._send_json(body)
        elif path == "/v1/models":
            self._send_json(eng.models())
        elif path == "/v1/lora_adapters":
            self._send_json(eng.lora_adapters())
        elif path == "/version":
            self._send_json({"version": __version__})
        elif path == "/is_sleeping":
            self._send_json({"is_sleeping": eng.core.is_sleeping})
        elif path == "/metrics":
            data = self.engine.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._send_json({"error": {"message": f"no route {path}",
                                       "type": "NotFoundError"}}, 404)

    def do_POST(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        self._gated(path, lambda: self._post(path))

    def _post(self, path: str) -> None:
        eng = self.engine
        query = dict(urllib.parse.parse_qsl(self.path.partition("?")[2]))
        # Routes answered with one JSON body; a BadRequest is the error.
        plain = {"/v1/embeddings": lambda: eng.embeddings(self._read_json()),
                 "/v1/score": lambda: eng.score(self._read_json()),
                 "/score": lambda: eng.score(self._read_json()),
                 "/v1/rerank": lambda: eng.rerank(self._read_json()),
                 "/rerank": lambda: eng.rerank(self._read_json()),
                 "/tokenize": lambda: eng.tokenize(self._read_json()),
                 "/detokenize": lambda: eng.detokenize(self._read_json()),
                 "/sleep": lambda: self._sleep(query),
                 "/wake_up": self._wake}
        # Routes that answer (status, body).
        status_routes = {
            "/drain": lambda: eng.drain(query),
            "/debug/profile": lambda: eng.profile(self._read_json()),
            "/v1/load_lora_adapter": lambda: eng.load_lora(
                self._read_json()),
            "/v1/unload_lora_adapter": lambda: eng.unload_lora(
                self._read_json())}
        if path in plain or path in status_routes:
            try:
                if path in plain:
                    self._send_json(plain[path]())
                else:
                    status, body = status_routes[path]()
                    self._send_json(body, status)
            except BadRequest as exc:
                self._send_error(exc)
            return
        kv_routes = {"/kv/extract": self._kv_extract,
                     "/kv/inject": self._kv_inject,
                     "/kv/pull": self._kv_pull,
                     "/kv/prepare_pull": self._kv_prepare_pull,
                     "/kv/release": self._kv_release}
        if path in kv_routes:
            try:
                kv_routes[path]()
            except BadRequest as exc:
                self._send_error(exc)
            return
        if path == "/v1/audio/transcriptions":
            self._transcriptions()
            return
        kinds = {"/v1/completions": "completion",
                 "/v1/chat/completions": "chat"}
        if path not in kinds:
            self._send_json({"error": {"message": f"no route {path}",
                                       "type": "NotFoundError"}}, 404)
            return
        kind = kinds[path]
        # The router's headers: its request id is adopted (and echoed),
        # X-Priority sets the request's scheduling class, traceparent
        # joins this request's trace to the caller's.
        request_id = self.headers.get("X-Request-Id") or None
        traceparent = self.headers.get("traceparent")
        clock = StageClock()
        body: dict = {}
        try:
            body = self._read_json()
            rid, model, prompt_ids, sampling, streams = self.engine.generate(
                body, kind, request_id=request_id,
                priority=parse_priority(self.headers.get("X-Priority")),
                clock=clock)
        except BadRequest as exc:
            if exc.traced:
                eng.record_trace(
                    request_id or f"rejected-{uuid.uuid4().hex[:16]}",
                    body.get("model", eng.config.model), clock, traceparent)
            self._send_error(exc)
            return
        # Tool calls are parsed from a choice's whole text, so a chat with
        # tools buffers its output.
        tools = (body.get("tools") or []) if kind == "chat" else []
        declared = (tool_names(tools)
                    if tools and body.get("tool_choice") != "none" else None)
        args = (kind, rid, model, prompt_ids, sampling, streams, declared)
        self._pending_trace = (rid, model, clock, traceparent)
        try:
            if len(streams) > 1:
                self._respond_n(bool(body.get("stream")), *args)
            elif body.get("stream"):
                self._respond_stream(*args)
            else:
                self._respond_full(*args)
        finally:
            # Refused or disconnected: the timeline is kept all the same.
            self._record_trace()

    def _record_trace(self) -> None:
        """Record this request's trace, once. A response records it just
        before its last bytes are written (the body, or a stream's ``data:
        [DONE]``), so a client that reads ``/debug/traces/{id}`` as soon
        as it has the response finds it."""
        pending, self._pending_trace = self._pending_trace, None
        if pending is not None:
            self.engine.record_trace(*pending)

    # -- KV transfer routes ----------------------------------------------
    def _kv_extract(self) -> None:
        """The cached prefix pages of the body's prompt as one TKV2
        payload, each buffer written as it is (no payload-sized join)."""
        eng = self.engine
        body = self._read_json()
        payload = eng.core.extract_kv(
            eng.tokens_from_body(body),
            eng.resolve_adapter(body.get("model", "")))
        if payload is None:
            self._send_json({"error": "no cached prefix for these tokens"},
                            404)
            return
        buffers = pack_transfer_buffers(payload["hashes"],
                                        payload["num_tokens"],
                                        payload["k"], payload["v"])
        total = sum(len(b) for b in buffers)
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(total))
        self.send_header("X-KV-Tokens", str(payload["num_tokens"]))
        self.end_headers()
        for buf in buffers:
            self.wfile.write(buf)
        with eng._kv_lock:
            eng.kv_transfer_tx_bytes += total

    def _kv_inject(self) -> None:
        """Install a TKV2 payload's blocks as cached prefix pages."""
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_KV_BODY_BYTES:
            raise BadRequest("payload too large", 413)
        data = bytearray(length)
        view, got = memoryview(data), 0
        while got < length:
            n = self.rfile.readinto(view[got:])
            if not n:
                raise BadRequest("payload cut short")
            got += n
        try:
            payload = unpack_transfer(data)
            injected = self.engine.core.inject_kv(
                payload["hashes"], payload["k"], payload["v"])
        except (ValueError, KeyError, TypeError, struct.error) as e:
            self._send_json({"error": f"bad payload: {e}"}, 400)
            return
        self._send_json({"status": "ok", "injected_blocks": injected,
                         "num_tokens": payload["num_tokens"]})

    def _kv_pull(self) -> None:
        status, out, headers = self.engine.kv_pull(
            self._read_json(), self.headers.get("X-Request-Id"),
            self.headers.get("traceparent"))
        data = json.dumps(out).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for key, value in headers.items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _sleep(self, query: dict) -> dict:
        try:
            level = int(query.get("level", "1"))
        except ValueError:
            raise BadRequest("level must be an integer")
        self.engine.core.sleep(level)
        return {"status": "sleeping", "level": level}

    def _wake(self) -> dict:
        self.engine.core.wake_up()
        return {"status": "awake"}

    def _kv_prepare_pull(self) -> None:
        status, out = self.engine.kv_prepare_pull(self._read_json())
        self._send_json(out, status)

    def _kv_release(self) -> None:
        self._send_json(self.engine.kv_release(self._read_json()))

    def _transcriptions(self) -> None:
        """Audio transcription is served by dedicated ASR pods
        (:mod:`production_stack_tpu_torch.engine.asr_server`) that the
        router proxies multipart audio to; this text server answers 501
        with a pointer rather than 404, so a misrouted client gets a
        diagnosis. The body is read and dropped."""
        length = int(self.headers.get("Content-Length") or 0)
        while length > 0:
            got = self.rfile.read(min(length, 1 << 20))
            if not got:
                break
            length -= len(got)
        self._send_json({"error": {
            "message": "this pod serves text generation; deploy a "
                       "whisper-class ASR pod (python -m production_"
                       "stack_tpu_torch.engine.asr_server, or a helm "
                       "modelSpec with modelType: transcription) and "
                       "route audio there",
            "type": "NotImplementedError"}}, 501)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            raise BadRequest("request body too large", 413)
        raw = self.rfile.read(length) if length else b"{}"
        try:
            body = json.loads(raw.decode("utf-8"))
        except (ValueError, RecursionError):
            raise BadRequest("request body is not valid JSON")
        if not isinstance(body, dict):
            raise BadRequest("request body must be a JSON object")
        return body

    def _chunk(self, kind, rid, model, created, choice) -> None:
        """Write one server-sent event of a streamed response."""
        obj = "chat.completion.chunk" if kind == "chat" else "text_completion"
        payload = {"id": rid, "object": obj, "created": created,
                   "model": model, "choices": [choice]}
        self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
        self.wfile.flush()

    @staticmethod
    def _tool_message(text: str, declared):
        """(message, tool calls) of a chat choice's whole text: the
        parsed calls and the text around them, or the text alone."""
        if declared is None:
            return {"role": "assistant", "content": text}, []
        content, calls = parse_tool_calls(text, declared)
        if not calls:
            return {"role": "assistant", "content": text}, []
        return ({"role": "assistant", "content": content or None,
                 "tool_calls": calls}, calls)

    @staticmethod
    def _tool_delta(index: int, text: str, declared, entries):
        """The one delta of a buffered (tools) streamed choice, and
        whether it carries calls; all of the choice's logprob entries
        ride it."""
        content, calls = parse_tool_calls(text, declared)
        delta = {"role": "assistant"}
        if calls:
            delta["tool_calls"] = [dict(tc, index=k)
                                   for k, tc in enumerate(calls)]
            if content:
                delta["content"] = content
        else:
            delta["content"] = text
        choice = {"index": index, "delta": delta, "finish_reason": None}
        if entries:
            choice["logprobs"] = {"content": entries}
        return choice, bool(calls)

    def _kv_capacity_refusal(self, stream, prompt_ids) -> Optional[tuple]:
        """The stream's first event, or None after answering 503 with
        ``Retry-After: 1`` when that event is a scheduler rejection for
        KV capacity before any token (the pool is pinned below the
        prompt's footprint for now: retryable, as the JAX server
        answers it)."""
        first = next(stream)
        if first[2] != "kv_capacity" or first[3]:
            return first
        self._send_json({"error": {
            "message": (f"prompt ({len(prompt_ids)} tokens) exceeds "
                        f"currently available KV cache capacity"),
            "type": "ServiceUnavailable"}}, 503, {"Retry-After": "1"})
        return None

    def _respond_full(self, kind, rid, model, prompt_ids, sampling, streams,
                      declared):
        pieces, entries, finish = [], [], "stop"
        n_generated = 0
        first = self._kv_capacity_refusal(streams[0], prompt_ids)
        if first is None:
            return
        for delta, entry, reason, is_token in itertools.chain(
                [first], streams[0]):
            pieces.append(delta)
            n_generated += is_token
            if entry is not None:
                entries.append(entry)
            if reason is not None:
                finish = reason
        text = "".join(pieces)
        usage = {"prompt_tokens": len(prompt_ids),
                 "completion_tokens": n_generated,
                 "total_tokens": len(prompt_ids) + n_generated}
        created = int(time.time())
        if kind == "chat":
            message, calls = self._tool_message(text, declared)
            choice = {"index": 0, "message": message,
                      "finish_reason": "tool_calls" if calls else finish}
            if entries:
                choice["logprobs"] = {"content": entries}
            obj = "chat.completion"
        else:
            if sampling.echo:
                text = self.engine.core.tokenizer.decode(prompt_ids) + text
            choice = {"index": 0, "text": text, "finish_reason": finish}
            if entries:
                choice["logprobs"] = self.engine.completions_logprobs(entries)
            obj = "text_completion"
        self._record_trace()
        self._send_json({"id": rid, "object": obj, "created": created,
                         "model": model, "choices": [choice],
                         "usage": usage}, headers={"X-Request-Id": rid})

    def _respond_stream(self, kind, rid, model, prompt_ids, sampling,
                        streams, declared):
        first_event = self._kv_capacity_refusal(streams[0], prompt_ids)
        if first_event is None:
            return
        stream = itertools.chain([first_event], streams[0])
        created = int(time.time())
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Request-Id", rid)
        self.end_headers()

        def event(delta: str, finish, first: bool, entries=None) -> None:
            if kind == "chat":
                d = {"role": "assistant"} if first else {}
                if delta:
                    d["content"] = delta
                choice = {"index": 0, "delta": d, "finish_reason": finish}
                if entries:
                    choice["logprobs"] = {"content": entries}
            else:
                choice = {"index": 0, "text": delta, "finish_reason": finish}
                if entries:
                    choice["logprobs"] = self.engine.completions_logprobs(
                        entries)
            self._chunk(kind, rid, model, created, choice)

        try:
            first = True
            if sampling.echo and kind == "completion":
                event(self.engine.core.tokenizer.decode(prompt_ids), None,
                      True)
                first = False
            pending: List[dict] = []
            finish = "stop"
            text = ""
            for delta, entry, reason, _ in stream:
                if entry is not None:
                    pending.append(entry)
                text += delta
                if declared is not None:
                    if reason is not None:
                        finish = reason
                        break
                    continue
                if reason is not None:
                    finish = reason
                    if delta:
                        event(delta, None, first, pending)
                        first, pending = False, []
                    break
                if delta or first:
                    event(delta, None, first, pending)
                    first, pending = False, []
            if declared is not None:
                choice, calls = self._tool_delta(0, text, declared, pending)
                self._chunk(kind, rid, model, created, choice)
                first, pending = False, []
                if calls:
                    finish = "tool_calls"
            event("", finish, first, pending)
            self._record_trace()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            streams[0].close()  # aborts the request in the engine

    def _respond_n(self, stream_mode: bool, kind, rid, model, prompt_ids,
                   sampling, streams, declared):
        """``n > 1``: the choices' streams, each drained by a thread of
        its own into one merged queue; a streamed response writes their
        chunks interleaved, tagged with the choice's ``index``, then a
        finish chunk a choice (after the buffered delta of a chat with
        tools), a whole one a choices array. A client that goes away
        aborts every choice."""
        n = len(streams)
        rids = [rid] + [f"{rid}-c{i}" for i in range(1, n)]
        texts, finishes, counts = [""] * n, ["stop"] * n, [0] * n
        lp_all: List[List[dict]] = [[] for _ in range(n)]
        # Entries whose text has not been written yet (held back by the
        # detokenizer, an EOS, a stop-trimmed tail): the finish chunk
        # drains them.
        pendings: List[List[dict]] = [[] for _ in range(n)]
        merged: "queue.Queue" = queue.Queue()

        def pump(i: int) -> None:
            try:
                for delta, entry, reason, is_token in streams[i]:
                    counts[i] += is_token
                    if entry is not None:
                        lp_all[i].append(entry)
                        pendings[i].append(entry)
                    texts[i] += delta
                    if reason is not None:
                        finishes[i] = reason
                    if delta:
                        merged.put((i, delta, pendings[i]))
                        pendings[i] = []
            finally:
                # The merge loop must not wait on a choice that is gone.
                merged.put((i, None, None))

        threads = [threading.Thread(target=pump, args=(i,), daemon=True,
                                    name=f"choice-{i}") for i in range(n)]
        for th in threads:
            th.start()
        created = int(time.time())
        chat = kind == "chat"
        try:
            if stream_mode:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Request-Id", rid)
                self.end_headers()
                if sampling.echo and not chat:
                    prompt_text = self.engine.core.tokenizer.decode(prompt_ids)
                    for i in range(n):
                        self._chunk(kind, rid, model, created, {
                            "index": i, "text": prompt_text,
                            "finish_reason": None})
            first = [True] * n
            live = n
            while live:
                i, emit, entries = merged.get()
                if emit is None:
                    live -= 1
                    continue
                if not stream_mode or declared is not None:
                    continue  # whole response, or parsed per choice below
                if chat:
                    delta = {"content": emit}
                    if first[i]:
                        delta = {"role": "assistant", "content": emit}
                    choice = {"index": i, "delta": delta,
                              "finish_reason": None}
                else:
                    choice = {"index": i, "text": emit,
                              "finish_reason": None}
                first[i] = False
                if entries:
                    choice["logprobs"] = (
                        {"content": entries} if chat
                        else self.engine.completions_logprobs(entries))
                self._chunk(kind, rid, model, created, choice)
            for th in threads:
                th.join()
            if stream_mode:
                for i in range(n):
                    finish = finishes[i]
                    if declared is not None:
                        choice, calls = self._tool_delta(i, texts[i],
                                                         declared, lp_all[i])
                        self._chunk(kind, rid, model, created, choice)
                        pendings[i] = []
                        if calls:
                            finish = "tool_calls"
                    choice = ({"index": i, "delta": {}, "finish_reason": finish}
                              if chat else {"index": i, "text": "",
                                            "finish_reason": finish})
                    if pendings[i]:
                        choice["logprobs"] = (
                            {"content": pendings[i]} if chat
                            else self.engine.completions_logprobs(pendings[i]))
                    self._chunk(kind, rid, model, created, choice)
                self._record_trace()
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                return
        except (BrokenPipeError, ConnectionResetError):
            for r in rids:
                self.engine.core.abort_request(r)
            return
        choices = []
        for i in range(n):
            if chat:
                message, calls = self._tool_message(texts[i], declared)
                choice = {"index": i, "message": message,
                          "finish_reason": ("tool_calls" if calls
                                            else finishes[i])}
                if lp_all[i]:
                    choice["logprobs"] = {"content": lp_all[i]}
            else:
                text = texts[i]
                if sampling.echo:
                    text = self.engine.core.tokenizer.decode(prompt_ids) + text
                choice = {"index": i, "text": text,
                          "finish_reason": finishes[i]}
                if lp_all[i]:
                    choice["logprobs"] = self.engine.completions_logprobs(
                        lp_all[i])
            choices.append(choice)
        total = sum(counts)
        self._record_trace()
        self._send_json({
            "id": rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": model, "choices": choices,
            "usage": {"prompt_tokens": len(prompt_ids),
                      "completion_tokens": total,
                      "total_tokens": len(prompt_ids) + total}},
            headers={"X-Request-Id": rid})


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="OpenAI engine server on PyTorch (CUDA by default)")
    p.add_argument("model", nargs="?", default=None)
    p.add_argument("--model", dest="model_flag", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' needs a card and raises "
                        "without one")
    p.add_argument("--served-model-name", action="append", default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantization", default=None, choices=["int8"],
                   help="weight-only quantization: int8 weights + "
                        "per-channel scales (llama family)")
    p.add_argument("--kv-cache-dtype", default="bf16",
                   choices=["bf16", "int8"],
                   help="KV cache storage dtype: int8 stores quantized "
                        "K/V pages with per-token per-kv-head f32 scales, "
                        "halving KV traffic and roughly doubling KV "
                        "capacity at equal memory")
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="run the model as N ranks, one process each, every "
                        "rank holding its slice of the weights and its KV "
                        "heads; without TPU_STACK_* in the environment the "
                        "server starts ranks 1..N-1 on this host (rank r "
                        "on cuda:(r %% cards)), with it this process joins "
                        "as TPU_STACK_PROCESS_ID says")
    p.add_argument("--pipeline-parallel-size", type=int, default=1,
                   help="stage-shard the layer stack over a pp mesh axis")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="GPipe microbatches per forward (0 -> pp)")
    p.add_argument("--data-parallel-size", type=int, default=1,
                   help="replicas of the pp x tp ranks, each holding the "
                        "model whole and replaying the same op stream (the "
                        "job has dp x pp x tp processes; under TPU_STACK_* "
                        "the replicas fill the job)")
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--hbm-utilization", type=float, default=0.7)
    p.add_argument("--hbm-headroom-reserve", type=float, default=0.0,
                   help="GiB of device memory kept free when auto-sizing "
                        "the KV pool")
    p.add_argument("--enable-prefix-caching", action="store_true",
                   default=True)
    p.add_argument("--no-enable-prefix-caching",
                   dest="enable_prefix_caching", action="store_false")
    p.add_argument("--max-loras", type=int, default=8)
    p.add_argument("--max-lora-rank", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefill-chunk-size", type=int, default=1024)
    p.add_argument("--enable-chunked-prefill", action="store_true",
                   default=False,
                   help="chunked prefill: schedule prompt prefills as "
                        "bucket-snapped chunks interleaved with decode "
                        "steps, bounded per step by "
                        "--max-num-batched-tokens")
    p.add_argument("--max-num-batched-tokens", type=int, default=0,
                   help="per-step prefill token budget of chunked prefill "
                        "(0 with --enable-chunked-prefill: use "
                        "--prefill-chunk-size; > 0 also enables it)")
    p.add_argument("--max-consecutive-prefills", type=int, default=2,
                   help="chunked prefill: force a decode step after this "
                        "many consecutive prefill steps while sequences "
                        "are running")
    p.add_argument("--fused-step", action="store_true", default=False,
                   help="fused step: when the chunked-prefill scheduler has "
                        "both a prefill plan and running decodes, launch "
                        "the prefill chunk span AND the decode burst as "
                        "ONE dispatch (one op-channel message under tp/pp; "
                        "requires --enable-chunked-prefill)")
    p.add_argument("--structured-cache-size", type=int, default=32,
                   help="LRU capacity of the compiled structured-output "
                        "token-FSM cache (one entry per distinct "
                        "schema/regex per tokenizer)")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="batch up to N queued long-prompt prefills into "
                        "one dispatch during an arrival storm (1 "
                        "disables)")
    p.add_argument("--speculative-num-tokens", type=int, default=0,
                   help="speculative decoding: verify up to this many "
                        "tokens per forward pass; 0 disables. Drafts come "
                        "from the draft model when "
                        "--speculative-draft-model is set, otherwise from "
                        "prompt lookup (an n-gram index over each "
                        "request's own prompt+output)")
    p.add_argument("--speculative-ngram-size", type=int, default=3,
                   help="n-gram length matched by the prompt-lookup "
                        "draft index (ignored when a draft model is "
                        "configured)")
    p.add_argument("--speculative-draft-model", default=None,
                   help="zoo model that drafts for the target (same "
                        "vocab; e.g. tpu-llama-1b drafting for "
                        "Llama-3-8B), with its own weights and page pool "
                        "in the model dtype on the same device; replaces "
                        "the prompt-lookup proposer")
    p.add_argument("--speculative-draft-probation", type=int, default=64,
                   help="plain bursts after which a request whose "
                        "draft-model speculation was adaptively latched "
                        "off retries drafting (0 = latch is permanent, "
                        "as prompt-lookup latches always are)")
    p.add_argument("--no-step-recorder", dest="step_recorder",
                   action="store_false", default=True,
                   help="disable the per-step flight recorder "
                        "(/debug/steps + tpu:step_* metrics)")
    p.add_argument("--step-record-capacity", type=int, default=1024,
                   help="step records kept in the flight-recorder ring")
    p.add_argument("--chat-template", default=None,
                   help="custom jinja chat-template file (HF checkpoints)")
    p.add_argument("--kv-offload-gb", type=float, default=0.0,
                   help="host-RAM KV offload tier size in GiB (0 = off): "
                        "evicted prefix pages spill here and are restored "
                        "instead of recomputed")
    p.add_argument("--kv-remote-url", default=None,
                   help="remote KV cache server URL (the L3 tier behind "
                        "host RAM)")
    p.add_argument("--kv-controller-url", default=None,
                   help="router URL hosting the KV controller: the engine "
                        "registers there and reports its prefix admissions "
                        "and evictions (kvaware routing)")
    p.add_argument("--advertise-url", default=None,
                   help="this engine's URL as the router reaches it "
                        "(default: http://<host>:<port>)")
    p.add_argument("--instance-id", default=None,
                   help="KV-controller instance id (default: random)")
    p.add_argument("--kv-heartbeat-interval", type=float, default=10.0,
                   help="seconds between KV-controller lease heartbeats "
                        "(0 disables)")
    p.add_argument("--kv-resync-interval", type=float, default=30.0,
                   help="seconds between KV-controller claim-digest "
                        "comparisons (0 disables)")
    p.add_argument("--kv-pull-max-concurrency", type=int, default=8,
                   help="/kv/pull transfers served at once; past it a pull "
                        "gets 503 + Retry-After")
    p.add_argument("--api-key", default=None,
                   help="deployment key(s), comma-separated: the inference "
                        "surface, /kv/* and /debug/* then require "
                        "'Authorization: Bearer <key>' (default: "
                        "VLLM_API_KEY, TPU_STACK_API_KEY or a keyfile from "
                        "VLLM_API_KEY_FILE / TPU_STACK_API_KEY_FILE)")
    p.add_argument("--trace-export", default=None,
                   help="export completed traces as OTLP-JSON: "
                        "'file:/path/traces.jsonl' (one line per trace) or "
                        "an 'http(s)://collector:4318/v1/traces' endpoint")
    p.add_argument("--slow-trace-threshold-s", type=float, default=0.0,
                   help="log one JSON line (the span timeline) for any "
                        "request slower than this many seconds; 0 disables")
    p.add_argument("--trace-buffer", type=int, default=512,
                   help="completed traces kept for /debug/traces")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of traces kept and exported "
                        "(deterministic by trace id); the stage metrics "
                        "still count every request")
    p.add_argument("--slow-trace-log-interval-s", type=float, default=0.0,
                   help="at most one slow-trace log line per this many "
                        "seconds (the rest are counted); 0 logs each")
    p.add_argument("--profile-dir", default=None,
                   help="directory of POST /debug/profile torch.profiler "
                        "artifacts (default: a per-process temp dir)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   default=True,
                   help="skip precompiling serving programs at startup")
    p.add_argument("--loop-monitor", action="store_true",
                   help="measure how late a ticker thread wakes (the "
                        "interpreter-lock wait every server thread pays) "
                        "and name the Python frames that held the lock "
                        "(watchdog stack sampler); serves GET /debug/loop "
                        "and the tpu:event_loop_* metrics. Off = no "
                        "thread, route or series")
    p.add_argument("--loop-stall-threshold-ms", type=float, default=100.0,
                   help="lag counted as a stall and sampled by the "
                        "blocking-call watchdog once the ticker has not "
                        "ticked for this long")
    return p


def config_from_args(args) -> EngineConfig:
    return EngineConfig(
        model=args.model_flag or args.model or "tiny-llama",
        device=args.device,
        dtype=args.dtype,
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        max_model_len=args.max_model_len,
        max_num_seqs=args.max_num_seqs,
        tensor_parallel_size=args.tensor_parallel_size,
        pipeline_parallel_size=args.pipeline_parallel_size,
        pp_microbatches=args.pp_microbatches,
        data_parallel_size=args.data_parallel_size,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        hbm_utilization=args.hbm_utilization,
        hbm_headroom_reserve=int(args.hbm_headroom_reserve * (1 << 30)),
        enable_prefix_caching=args.enable_prefix_caching,
        max_loras=args.max_loras,
        max_lora_rank=args.max_lora_rank,
        seed=args.seed,
        prefill_chunk_size=args.prefill_chunk_size,
        prefill_batch=args.prefill_batch,
        enable_chunked_prefill=args.enable_chunked_prefill,
        max_num_batched_tokens=args.max_num_batched_tokens,
        max_consecutive_prefills=args.max_consecutive_prefills,
        fused_step=args.fused_step,
        structured_cache_size=args.structured_cache_size,
        speculative_num_tokens=args.speculative_num_tokens,
        speculative_ngram_size=args.speculative_ngram_size,
        speculative_draft_model=args.speculative_draft_model,
        speculative_draft_probation=args.speculative_draft_probation,
        step_recorder=args.step_recorder,
        step_record_capacity=args.step_record_capacity,
        chat_template=args.chat_template,
        kv_offload_bytes=int(args.kv_offload_gb * (1 << 30)),
        kv_remote_url=args.kv_remote_url,
    )


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    engine: EngineServer
    # A sharded engine's leader's job: (multihost context, spawned ranks).
    ranks: Optional[tuple] = None

    def service_actions(self) -> None:
        """A latched engine fault (a lost rank of the job) ends
        ``serve_forever`` with exit status 1."""
        if self.engine.core.fatal_error is not None:
            raise SystemExit(1)

    def server_close(self) -> None:
        """Close the socket, then stop the KV reporting threads, drop the
        local-peer entry and close the trace exporter; a sharded engine's
        leader then stops the engine and its followers and leaves the
        job."""
        super().server_close()
        self.engine.close()
        self.engine.trace_recorder.close()
        if self.ranks is not None:
            ctx, procs = self.ranks
            self.ranks = None
            self.engine.core.stop()
            codes = multihost.shutdown(ctx, procs)
            if any(codes):
                logger.error("the job's ranks exited with %s", codes)


def _tp_job(args, argv):
    """The multihost context of a sharded engine, and the ranks this
    process started: none when the ``TPU_STACK_*`` environment names the
    job, ranks 1..N-1 (N = dp x pp x tp) on this host otherwise."""
    procs = []
    if multihost.distributed_env() is None:
        procs = multihost.spawn_local_ranks(
            _job_size(args),
            sys.argv[1:] if argv is None else argv,
            "production_stack_tpu_torch.engine.server")
    try:
        multihost.initialize_from_env()
        return multihost.maybe_context(), procs
    except BaseException:
        for p in procs:
            p.kill()
        raise


def _job_size(args) -> int:
    """The processes of the engine's job: dp x pp x tp."""
    return (max(args.data_parallel_size, 1)
            * max(args.pipeline_parallel_size, 1)
            * max(args.tensor_parallel_size, 1))


def build_server(argv: Optional[List[str]] = None,
                 core: Optional[EngineCore] = None):
    """Parse ``argv``, build (or take) the engine, start its thread and
    bind the HTTP server (registered as a local peer for ``/kv/pull``,
    and with the KV controller when one is configured). Unless
    ``--no-warmup`` is given, the engine (a handed-in ``core`` too) runs
    :meth:`EngineCore.warmup` before the socket is bound. Returns (httpd,
    core); the caller runs ``httpd.serve_forever()`` and, to stop,
    ``httpd.shutdown()``, ``httpd.server_close()`` and ``core.stop()``.
    With ``--tensor-parallel-size``, ``--pipeline-parallel-size`` and
    ``--data-parallel-size`` whose product N > 1 (or under a
    ``TPU_STACK_*`` job) this process is the leader (rank 0) of an
    N-process job (:func:`_tp_job`); ``server_close`` ends the job."""
    args = build_arg_parser().parse_args(argv)
    ranks = None
    if core is None:
        config = config_from_args(args)
        if _job_size(args) > 1 or multihost.distributed_env() is not None:
            ranks = _tp_job(args, argv)
    try:
        if core is None:
            core = EngineCore(config, multihost=ranks[0] if ranks else None)
        if args.warmup:
            # Before the socket is bound: /health first answers a warm
            # engine. A failure stops the start-up.
            core.warmup()
    except BaseException:
        if ranks is not None:
            for p in ranks[1]:
                p.kill()
            multihost.shutdown(*ranks)
        raise
    core.start()
    served = args.served_model_name or [core.config.model]
    engine = EngineServer(
        core, served, kv_controller_url=args.kv_controller_url,
        advertise_url=args.advertise_url, instance_id=args.instance_id,
        kv_heartbeat_interval=args.kv_heartbeat_interval,
        kv_resync_interval=args.kv_resync_interval,
        kv_pull_max_concurrency=args.kv_pull_max_concurrency,
        api_key=args.api_key, trace_buffer=args.trace_buffer,
        trace_sample_rate=args.trace_sample_rate,
        trace_export=args.trace_export,
        slow_trace_threshold_s=args.slow_trace_threshold_s,
        slow_trace_log_interval_s=args.slow_trace_log_interval_s,
        profile_dir=args.profile_dir, loop_monitor=args.loop_monitor,
        loop_stall_threshold_ms=args.loop_stall_threshold_ms)
    handler = type("Handler", (_Handler,), {"engine": engine})
    httpd = _HTTPServer((args.host, args.port), handler)
    httpd.engine = engine
    httpd.ranks = ranks
    engine.start_kv_reporting(args.host, httpd.server_address[1])
    if engine.loop_monitor is not None:
        engine.loop_monitor.start()
    return httpd, core


def run_follower(argv: Optional[List[str]] = None) -> int:
    """A follower rank (``TPU_STACK_PROCESS_ID`` > 0) of a sharded
    engine: build the same engine from the same
    arguments and replay the leader's ops until it stops. Serves no
    HTTP and runs no warm-up of its own: it replays the leader's, so the
    leader's ``--no-warmup`` decides. Returns the exit status (1 when the
    replay failed or the leader vanished)."""
    args = build_arg_parser().parse_args(argv)
    ctx = multihost.maybe_context()
    status = 0
    try:
        core = EngineCore(config_from_args(args), multihost=ctx)
        core.run_follower()
    except Exception:  # noqa: BLE001 - the process ends on it
        logger.exception("Follower rank %d failed", ctx.process_id)
        status = 1
    multihost.shutdown(ctx)
    return status


def main(argv: Optional[List[str]] = None) -> None:
    # Multi-host: join the torch.distributed job before any device use;
    # follower ranks replay the leader's ops instead of serving HTTP.
    env = multihost.initialize_from_env()
    if env is not None and env["process_id"] != 0:
        sys.exit(run_follower(argv))
    httpd, core = build_server(argv)
    host, port = httpd.server_address[:2]
    logger.info("Serving %s on http://%s:%d (device %s)",
                core.config.model, host, port, core.config.device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        core.stop()
    if core.fatal_error is not None:
        sys.exit(1)


if __name__ == "__main__":
    main()
