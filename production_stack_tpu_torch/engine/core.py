"""Engine core: model execution + continuous batching on one device.

The main-path subset of ``production_stack_tpu/engine/core.py``: owns the
parameters, the paged KV pool, the copied scheduler, sampling, and the
engine thread that drives them. The OpenAI server
(:mod:`production_stack_tpu_torch.engine.server`) talks to this class
only, through ``add_request``/``abort_request``/``stats`` and the token
callback ``on_token(token | (token, logprobs) | None, finish | None)``.

A step is either a prefill (one prompt: its uncached suffix runs in
chunks of at most ``prefill_chunk_size`` tokens, the first through causal
prefill attention, later ones and prefix-cache hits through the
cached-prefill kernel) or a decode burst: ``decode_steps`` forwards of
the whole batch, each attending through the paged decode kernel, with
the sampled tokens fed back on the device and read back once per burst.

The KV pool is bf16 (the model dtype) or, with ``kv_cache_dtype="int8"``,
int8 ``(data, scales)`` pairs that the page ops quantize on the scatter
and both kernels dequantize on the card; ``quantization="int8"`` stores
the weights as int8 with per-output-channel scales.

Not here yet, and refused at construction when configured: chunked-
prefill step plans, prefill batching, the fused step, speculation,
structured output, tensor/pipeline/data parallelism, multihost, KV
offload and extract/inject, sleep, LoRA load/unload, embeddings and the
step recorder.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kvcache import KVCacheManager
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGIT_BIAS,
    MAX_STOP_IDS,
    SamplingParams,
    gumbel_noise,
    logprob_outputs,
    sample_tokens,
    shape_logits,
)
from production_stack_tpu_torch.engine.scheduler import (
    EngineRequest,
    RunningSeq,
    Scheduler,
)
from production_stack_tpu_torch.engine.tokenizer import build_tokenizer
from production_stack_tpu_torch.models import build_model, get_model_config
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)


def _unsupported(config: EngineConfig) -> List[str]:
    """Configured features this engine does not run yet."""
    c = config
    checks = [
        (c.tensor_parallel_size > 1, "tensor_parallel_size > 1"),
        (c.data_parallel_size > 1, "data_parallel_size > 1"),
        (c.pipeline_parallel_size > 1, "pipeline_parallel_size > 1"),
        (c.kv_offload_bytes > 0 or bool(c.kv_remote_url), "KV offload"),
        (c.chunked_prefill_enabled, "chunked-prefill step plans"),
        (c.prefill_batch > 1, "prefill batching (prefill_batch > 1)"),
        (c.fused_step, "fused_step"),
        (c.decode_steps_pressure > 0, "decode_steps_pressure"),
        (c.speculative_num_tokens > 0 or bool(c.speculative_draft_model),
         "speculative decoding"),
        (c.step_recorder, "the step recorder"),
    ]
    return [name for bad, name in checks if bad]


def kv_bytes_per_block(model_config, block_size: int,
                       kv_cache_dtype: str = "bf16") -> int:
    """Device bytes of one block of the K and V pools over all layers, as
    allocated: "bf16" pages hold the model dtype; "int8" pages one byte a
    K/V element plus one float32 scale per (slot, kv head). (The JAX
    formula adds TPU tile padding; at Llama-family dims, head_dim 128, it
    has none and the two agree.)"""
    mc = model_config
    slot_heads = block_size * mc.num_kv_heads
    if kv_cache_dtype == "int8":
        return mc.num_layers * (2 * slot_heads * mc.head_dim
                                + 2 * slot_heads * 4)
    itemsize = torch.empty((), dtype=mc.torch_dtype).element_size()
    return mc.num_layers * 2 * slot_heads * mc.head_dim * itemsize


class EngineCore:
    def __init__(self, config: EngineConfig,
                 params: Optional[Dict] = None):
        """``params``: a parameter dict for the configured model (e.g. a
        JAX tree carried over by ``models/convert.py``); None draws the
        random init from ``config.seed`` on the device."""
        missing = _unsupported(config)
        if missing:
            raise NotImplementedError(
                "not supported by the torch engine yet: " + ", ".join(missing))
        self.config = config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {config.device!r} requested but no CUDA device is "
                f"available (pass device='cpu' to run on the CPU)")
        self.model_config = get_model_config(config.model)
        if config.dtype:
            self.model_config = self.model_config.replace(dtype=config.dtype)
        self.tokenizer = build_tokenizer(
            config.model, self.model_config.vocab_size,
            chat_template_path=config.chat_template)
        init_fn, self._apply = build_model(self.model_config)
        if params is None:
            lora_kwargs = {}
            if config.max_loras > 0:
                lora_kwargs = {"lora_slots": config.max_loras,
                               "lora_rank": config.max_lora_rank}
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            with torch.no_grad():
                # int8 weights quantize leaf by leaf inside the init, so
                # an 8B model never exists whole in bf16 on the card.
                params = init_fn(
                    self.model_config, gen, self.device,
                    quantization=config.quantization,
                    quantize_embeddings=config.quantize_embeddings,
                    **lora_kwargs)
        self.params = params

        # -- KV pages ------------------------------------------------------
        free_before = self._free_device_bytes()
        self.num_blocks = config.num_blocks or self._auto_num_blocks()
        mc = self.model_config
        self.kv = (self._alloc_pages(), self._alloc_pages())
        # Device memory left after the pool (tpu:hbm_headroom_bytes).
        self.hbm_headroom_bytes: Optional[int] = None
        if free_before is not None:
            self.hbm_headroom_bytes = max(
                free_before - self.num_blocks * self._kv_bytes_per_block(), 0)
        self.kv_mgr = KVCacheManager(
            self.num_blocks, config.block_size, config.enable_prefix_caching,
            namespace=config.model)
        self.scheduler = Scheduler(
            self.kv_mgr, config.max_num_seqs, config.max_model_len)

        # Adapter name -> slot. Loading adapters is a later slice, so only
        # slot 0 (the zero adapter) is ever selected.
        self.lora_slots: Dict[str, int] = {}
        _eos = getattr(self.tokenizer, "eos_token_id", None)
        self._eos_id = int(_eos) if _eos is not None else -1

        # -- counters (exported via /metrics) ------------------------------
        self.prompt_tokens_total = 0
        self.cached_tokens_total = 0
        self.generation_tokens_total = 0
        self.requests_finished_total = 0
        self.prefill_time_total = 0.0
        self.decode_time_total = 0.0
        self.prefill_chunks_total = 0
        self.decode_forward_steps_total = 0

        # Per-slot output-token counts [B, V] behind presence/frequency
        # penalties; a slot's row resets when a fresh output starts in it.
        self._token_counts = torch.zeros(
            (config.max_num_seqs, mc.vocab_size), dtype=torch.int32,
            device=self.device)
        self._counts_reset: "set[int]" = set()

        # -- engine thread -------------------------------------------------
        self._lock = threading.Condition()
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="engine-core")

    # ------------------------------------------------------------------ #
    # setup helpers
    # ------------------------------------------------------------------ #
    def _kv_bytes_per_block(self) -> int:
        return kv_bytes_per_block(self.model_config, self.config.block_size,
                                  self.config.kv_cache_dtype)

    def _alloc_pages(self):
        """One side (K or V) of the pool: zeros ``[L, NB, bs, KVH, D]`` in
        the model dtype, or for an int8 cache zero int8 data with float32
        scales ``[L, NB, bs*KVH]`` set to ONE, as the JAX engine sets them
        (a never-written slot dequantizes to exact zeros)."""
        mc, bs = self.model_config, self.config.block_size
        shape = (mc.num_layers, self.num_blocks, bs, mc.num_kv_heads,
                 mc.head_dim)
        if self.config.kv_cache_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                    torch.ones((mc.num_layers, self.num_blocks,
                                bs * mc.num_kv_heads), dtype=torch.float32,
                               device=self.device))
        return torch.zeros(shape, dtype=mc.torch_dtype, device=self.device)

    def _free_device_bytes(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return int(free)

    def _auto_num_blocks(self) -> int:
        """Size the KV pool from free device memory (hbm_utilization),
        as the JAX engine does from its HBM figure."""
        free = self._free_device_bytes()
        num = 0
        if free is not None:
            free = max(free - self.config.hbm_headroom_reserve, 0)
            num = int(free * self.config.hbm_utilization
                      // self._kv_bytes_per_block())
        num = max(num, self.config.max_blocks_per_seq * 2)
        # Cap by what max_num_seqs could ever use, plus prefix-cache headroom.
        cap = self.config.max_blocks_per_seq * (self.config.max_num_seqs * 4)
        return min(num, cap)

    # ------------------------------------------------------------------ #
    # request interface
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        self._thread.start()

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
        req = EngineRequest(
            request_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            sampling=sampling,
            on_token=on_token,
            adapter_id=adapter_id,
            adapter_name=(adapter_name or "") if adapter_id else "",
            priority=priority,
            trace=trace,
        )
        with self._lock:
            self.scheduler.add(req)
            self._lock.notify()

    def abort_request(self, request_id: str) -> bool:
        with self._lock:
            return self.scheduler.abort(request_id)

    def stop(self) -> None:
        with self._lock:
            self._running = False
            self._lock.notify()
        if self._thread.ident is not None:  # started
            self._thread.join(timeout=30)

    def kv_never_fits(self, n_tokens: int) -> bool:
        """True when a prompt (+1-token decode headroom) needs more pages
        than the whole pool holds."""
        bs = self.config.block_size
        return (n_tokens + 1 + bs - 1) // bs > self.num_blocks

    def stats(self) -> dict:
        alloc = self.kv_mgr.allocator
        return {
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "kv_usage": self.kv_mgr.usage(),
            "prefix_cache_hits": alloc.prefix_hits,
            "prefix_cache_queries": alloc.prefix_queries,
            "prompt_tokens_total": self.prompt_tokens_total,
            "cached_tokens_total": self.cached_tokens_total,
            "generation_tokens_total": self.generation_tokens_total,
            "requests_finished_total": self.requests_finished_total,
            "num_preempted_total": self.scheduler.num_preempted_total,
            "num_blocks": self.num_blocks,
            "hbm_headroom_bytes": self.hbm_headroom_bytes,
            "kv_cache_dtype": self.config.kv_cache_dtype,
            "kv_cache_bytes_per_token": (
                self._kv_bytes_per_block() // self.config.block_size),
            "prefill_time_total": round(self.prefill_time_total, 3),
            "decode_time_total": round(self.decode_time_total, 3),
            "prefill_chunks_total": self.prefill_chunks_total,
            "decode_forward_steps_total": self.decode_forward_steps_total,
        }

    # ------------------------------------------------------------------ #
    # engine loop
    # ------------------------------------------------------------------ #
    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._running and not self.scheduler.has_work():
                    self._lock.wait(timeout=0.1)
                if not self._running:
                    return
                action, req = self.scheduler.next_action()
            try:
                with torch.inference_mode():
                    if action == "prefill":
                        t0 = time.perf_counter()
                        self._do_prefill(req)
                        self.prefill_time_total += time.perf_counter() - t0
                    elif action == "decode":
                        t0 = time.perf_counter()
                        self._do_decode()
                        self.decode_time_total += time.perf_counter() - t0
                    else:
                        time.sleep(0.001)
            except Exception as e:  # noqa: BLE001 - the loop must keep serving
                # A failed step fails the requests it carried: the client
                # sees finish_reason "error" instead of hanging.
                logger.exception("Engine step failed: %s", e)
                self._fail_step(action, req)

    def _fail_step(self, action: str, req: Optional[EngineRequest]) -> None:
        with self._lock:
            if action == "prefill" and req is not None:
                seq = self.scheduler._running_by_id.get(req.request_id)
                if seq is not None:
                    self.scheduler.finish(seq, "error")
                else:
                    self.kv_mgr.free(req.request_id)
                    self.scheduler._requests.pop(req.request_id, None)
                    req.on_token(None, "error")
            elif action == "decode":
                for seq in self.scheduler.running():
                    self.scheduler.finish(seq, "error")

    # -- prefill -----------------------------------------------------------
    def _do_prefill(self, req: EngineRequest) -> None:
        """Allocate the prompt's pages (leading full blocks may come from
        the prefix cache), run its uncached suffix in chunks, and emit
        the first token."""
        cfg = self.config
        tokens = req.all_token_ids
        n = len(tokens)
        alloc = self.kv_mgr.allocate_prompt(
            req.request_id, tokens, adapter=req.adapter_name)
        if alloc is None:
            with self._lock:
                self.scheduler.requeue(req)
            return
        block_ids, cached, _ = alloc
        if req.trace is not None:
            if not req.trace.prefill_start:
                req.trace.prefill_start = time.time()
            req.trace.cached_tokens = cached
            req.trace.preemptions = req.num_preemptions
        # Only the uncached suffix runs through the model; long suffixes
        # run in chunks so attention memory stays O(chunk * context).
        chunk = cfg.prefill_chunk_size or (n - cached)
        start = cached
        while start < n:
            end = min(start + chunk, n)
            out = self._prefill_span(req, tokens, block_ids, start, end)
            self.prefill_chunks_total += 1
            start = end
        sampled, lp_arr, top_lp_arr, top_id_arr = (t.cpu() for t in out)
        self.prompt_tokens_total += n
        self.cached_tokens_total += cached
        with self._lock:
            slot = self.scheduler._free_slot()
            seq = self.scheduler.start_running(req, slot)
        token = int(sampled[0])
        lp = None
        if req.sampling.logprobs is not None:
            k = min(req.sampling.logprobs, top_lp_arr.shape[1])
            lp = {"logprob": float(lp_arr[0]),
                  "top": [(int(top_id_arr[0, j]), float(top_lp_arr[0, j]))
                          for j in range(k)]}
        prior = req.output_token_ids
        if prior and (req.sampling.presence_penalty
                      or req.sampling.frequency_penalty):
            # Resume after preemption with penalties: rebuild the slot's
            # count row from the carried-forward outputs + this token.
            ids = torch.tensor(prior + [token], dtype=torch.long).clamp(
                0, self.model_config.vocab_size - 1)
            row = torch.zeros((self.model_config.vocab_size,),
                              dtype=torch.int32)
            row.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            self._token_counts[slot] = row.to(self.device)
            with self._lock:
                self._counts_reset.discard(slot)
        else:
            with self._lock:
                # Fresh output in this slot: its counts reset at the next
                # burst (which also counts this token).
                self._counts_reset.add(slot)
        if req.trace is not None:
            req.trace.prefill_end = time.time()
        self._emit_token(seq, token, lp)
        req.scheduled_steps = len(req.output_token_ids)

    def _prefill_span(self, req: EngineRequest, tokens, block_ids,
                      start: int, end: int):
        """Run one prefill chunk (tokens[start:end]) and sample the next
        token from its last real position. Chunks after the first attend
        to earlier tokens through the pages (prefill_cached); the chunk's
        own K/V are written first."""
        cfg = self.config
        dev = self.device
        bs = cfg.block_size
        take = end - start
        bucket = cfg.bucket_for(take)
        # Power-of-two table width (min 4) over the context, as the JAX
        # engine buckets it, capped at max_blocks_per_seq.
        blocks_needed = (end + bs - 1) // bs
        maxb = 4
        while maxb < blocks_needed:
            maxb *= 2
        maxb = min(maxb, cfg.max_blocks_per_seq)

        token_arr = np.zeros((1, bucket), np.int64)
        token_arr[0, :take] = tokens[start:end]
        positions = (start + np.arange(bucket, dtype=np.int64))[None]
        slot_mapping = np.full((1, bucket), -1, np.int64)
        pos_idx = start + np.arange(take)
        blocks = np.asarray(block_ids, np.int64)
        slot_mapping[0, :take] = (blocks[pos_idx // bs] * bs + pos_idx % bs)
        block_table = np.zeros((1, maxb), np.int32)
        use = min(len(block_ids), maxb)
        block_table[0, :use] = block_ids[:use]
        seq_lens = torch.tensor([take], device=dev)

        def t(a):
            return torch.from_numpy(a).to(dev)

        logits, _ = self._apply(
            self.params, self.model_config, t(token_arr), t(positions),
            self.kv, torch.from_numpy(slot_mapping), t(block_table),
            torch.tensor([end], device=dev), seq_lens,
            mode="prefill_cached" if start > 0 else "prefill",
            adapter_ids=torch.tensor([req.adapter_id], device=dev),
            last_token=seq_lens - 1)
        sp = req.sampling
        bias_ids, bias_vals = self._bias_rows([self._resume_bias(req)])
        stop_ids, stop_valid = self._stop_rows([sp.stop_token_ids])
        shaped = shape_logits(
            logits[:, 0], bias_ids=bias_ids, bias_vals=bias_vals,
            suppress=torch.tensor(
                [len(req.output_token_ids) < sp.min_tokens], device=dev),
            stop_ids=stop_ids, stop_valid=stop_valid, eos_id=self._eos_id)
        temp, top_k, top_p, seed = self._sampling_for(req)
        noise = gumbel_noise(
            [self._draw_seed(seed, len(tokens)) if temp > 0 else None],
            self.config.max_top_k, dev)
        sampled = sample_tokens(
            shaped, torch.tensor([temp], device=dev),
            torch.tensor([top_k], device=dev),
            torch.tensor([top_p], device=dev), noise,
            max_top_k=self.config.max_top_k)
        return (sampled,) + logprob_outputs(shaped, sampled)

    # -- decode ------------------------------------------------------------
    def _do_decode(self) -> None:
        """One decode burst: ``decode_steps`` forwards of the whole batch,
        each step's sampled tokens fed back to the next on the device;
        the tokens are read back and emitted once, after the burst. Steps
        a sequence cannot use carry slot -1 (their page writes drop) and
        their tokens are discarded at emission."""
        cfg = self.config
        dev = self.device
        B = cfg.max_num_seqs
        K = max(cfg.decode_steps, 1)

        def seq_allow(r: EngineRequest) -> int:
            return max(1, min(
                K,
                r.sampling.max_tokens - len(r.output_token_ids),
                cfg.max_model_len - len(r.all_token_ids) + 1,
            ))

        with self._lock:
            active0 = self.scheduler.running()
            allows: Dict[str, int] = {}
            # Account the about-to-be-written tokens; preempt on OOM.
            for seq in list(self.scheduler.running()):
                if self.scheduler.slots[seq.slot] is not seq:
                    continue  # already preempted this pass
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
            reset_rows = sorted(self._counts_reset)
            self._counts_reset.clear()
        if not active:
            return

        max_blocks = max(len(self.kv_mgr.block_table(s.req.request_id))
                         for s in active)
        maxb = 4
        while maxb < max_blocks:
            maxb *= 2
        maxb = min(maxb, cfg.max_blocks_per_seq)

        tokens0 = np.zeros((B,), np.int64)
        positions0 = np.zeros((B,), np.int64)
        slot_mat = np.full((B, K), -1, np.int64)
        block_table = np.zeros((B, maxb), np.int32)
        context0 = np.ones((B,), np.int64)
        adapter_ids = np.zeros((B,), np.int64)
        temperature = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        top_p = np.ones((B,), np.float32)
        presence = np.zeros((B,), np.float32)
        frequency = np.zeros((B,), np.float32)
        min_tok = np.zeros((B,), np.int64)
        out_len0 = np.zeros((B,), np.int64)
        seeds: List[Optional[int]] = [None] * B
        biases, stops = [None] * B, [None] * B
        for seq in active:
            i, r = seq.slot, seq.req
            tokens0[i] = r.all_token_ids[-1]
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
            temperature[i], top_k[i], top_p[i], seeds[i] = (
                self._sampling_for(r))
            presence[i] = r.sampling.presence_penalty
            frequency[i] = r.sampling.frequency_penalty
            min_tok[i] = r.sampling.min_tokens
            out_len0[i] = r.scheduled_steps
            biases[i] = r.sampling.logit_bias
            stops[i] = r.sampling.stop_token_ids
            r.scheduled_steps += allow
        bias_ids, bias_vals = self._bias_rows(biases)
        stop_ids, stop_valid = self._stop_rows(stops)

        def t(a):
            return torch.from_numpy(a).to(dev)

        tokens = t(tokens0)
        counts = self._token_counts
        if reset_rows:
            rows = torch.tensor(reset_rows, device=dev)
            counts[rows] = 0
            counts[rows, tokens[rows]] += 1
        positions0_t, context0_t = t(positions0), t(context0)
        block_table_t, adapter_t = t(block_table), t(adapter_ids)
        temp_t, top_k_t, top_p_t = t(temperature), t(top_k), t(top_p)
        presence_t, frequency_t = t(presence), t(frequency)
        min_tok_t, out_len0_t = t(min_tok), t(out_len0)
        ones = torch.ones((B,), dtype=torch.long, device=dev)
        arange_b = torch.arange(B, device=dev)
        outs = []
        for s in range(K):
            step_slots = torch.from_numpy(slot_mat[:, s:s + 1])
            logits, _ = self._apply(
                self.params, self.model_config, tokens[:, None],
                (positions0_t + s)[:, None], self.kv, step_slots,
                block_table_t, context0_t + s, ones, mode="decode",
                adapter_ids=adapter_t)
            shaped = shape_logits(
                logits[:, 0], bias_ids=bias_ids, bias_vals=bias_vals,
                suppress=(out_len0_t + s) < min_tok_t, stop_ids=stop_ids,
                stop_valid=stop_valid, eos_id=self._eos_id, counts=counts,
                presence_penalty=presence_t, frequency_penalty=frequency_t)
            noise = gumbel_noise(
                [None if seeds[i] is None or temperature[i] <= 0
                 else self._draw_seed(seeds[i], int(context0[i]) + s)
                 for i in range(B)], cfg.max_top_k, dev)
            sampled = sample_tokens(shaped, temp_t, top_k_t, top_p_t, noise,
                                    max_top_k=cfg.max_top_k)
            outs.append((sampled,) + logprob_outputs(shaped, sampled))
            # Only steps whose page slot is live count toward penalties.
            live = torch.from_numpy(slot_mat[:, s] >= 0).to(dev)
            counts[arange_b, sampled] += live.to(torch.int32)
            tokens = sampled
        self.decode_forward_steps_total += K
        sampled, lps, top_lps, top_ids = (
            torch.stack(x, dim=1).cpu() for x in zip(*outs))
        self._emit_burst(active, allows, sampled, lps, top_lps, top_ids)

    def _emit_burst(self, active, allows, sampled, lps, top_lps,
                    top_ids) -> None:
        emitted_seqs = []
        for seq in active:
            allow = allows.get(seq.req.request_id, 1)
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
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(vals).to(self.device))

    def _stop_rows(self, stop_lists):
        """[R, MAX_STOP_IDS] (ids, valid) of stop_token_ids rows."""
        ids = np.zeros((len(stop_lists), MAX_STOP_IDS), np.int64)
        valid = np.zeros((len(stop_lists), MAX_STOP_IDS), np.float32)
        vocab = self.model_config.vocab_size
        for i, stops in enumerate(stop_lists):
            kept = [t for t in (stops or []) if 0 <= t < vocab][:MAX_STOP_IDS]
            for j, tid in enumerate(kept):
                ids[i, j], valid[i, j] = tid, 1.0
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(valid).to(self.device))

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
        """(temperature, clamped top_k, top_p, seed) of a request."""
        seed = (r.sampling.seed if r.sampling.seed is not None
                else hash(r.request_id) % (2**31))
        return (r.sampling.temperature,
                min(r.sampling.top_k, self.config.max_top_k),
                r.sampling.top_p, seed)

    def _draw_seed(self, seed: int, position: int) -> int:
        """Generator seed of the token sampled at ``position`` of a
        request: fixed by (engine seed, request seed, position), so a
        seeded request, and a preempted one resumed, draws the same."""
        return hash((self.config.seed, int(seed), int(position))) % (2**63)

    def _emit_token(self, seq: RunningSeq, token: int,
                    lp: Optional[dict] = None) -> None:
        """Deliver one generated token: ``(token, lp)`` when the request
        asked for logprobs, else the bare int."""
        req = seq.req
        req.output_token_ids.append(token)
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
            with self._lock:
                self.scheduler.finish(seq, finish)
            self.requests_finished_total += 1
