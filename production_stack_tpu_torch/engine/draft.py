"""Draft-model proposer for speculative decoding.

The port of ``production_stack_tpu/engine/draft.py``: a second model of
the zoo (``--speculative-draft-model``, the same vocabulary as the
target) served beside it on the same device, with its own parameters,
its own page pool and two greedy programs. It only changes where the
draft tokens of ``EngineCore._propose_spec_drafts`` come from; the
target's verify, acceptance and rollback stay as they are, so streams
stay those of plain decode.

- :meth:`DraftModel.forward`: one cached-prefill forward over ``[B,
  bucket]`` rows at the full-width block table, the mask term, and the
  greedy next token of each row's last real position. It catches the
  drafter's pages up with the tokens it has not seen (the whole prompt
  right after prefill, the last verified tokens in steady state), and
  takes the FSM-constrained draft steps of structured rows: ``[B, W0]``
  rows at the smallest bucket with one live token each, masked.
- :meth:`DraftModel.scan`: ``K - 2`` greedy decode steps, each sampled
  token fed back on the device, that extend the first draft token to the
  full draft width (only when ``speculative_num_tokens > 2``).

Both run through the port's attention kernels on a card (the catch-up
through the cached-prefill kernel, the scan through the decode kernel).

The parameters come from a ``params=`` dict, from the checkpoint when
the drafter is named by a local checkpoint directory
(``models/weights.py``), or else from ``config.seed`` through the port's
own ``init_params`` (no LoRA slots: the drafter proposes for every
adapter and the verify applies them; never quantized, whatever
``--quantization`` says). The pool holds
``max_blocks_per_seq * max_num_seqs + 1`` blocks in the model dtype
(never int8), enough for every slot's worst case, with prefix caching
off (draft pages are scratch owned by their request); it is carved out
before the target's pool is sized from free memory, so the drafter never
takes target KV capacity mid-flight.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.kvcache import KVCacheManager
from production_stack_tpu_torch.engine.sampling import apply_fsm_mask
from production_stack_tpu_torch.models import build_model, get_model_config
from production_stack_tpu_torch.models.convert import draft_params_from_numpy
from production_stack_tpu_torch.models.weights import (
    has_checkpoint,
    load_checkpoint,
)
from production_stack_tpu_torch.ops.attention import to_device


class DraftModel:
    """Device state, the two greedy programs and the host page
    bookkeeping of the draft model."""

    def __init__(self, config, target_model_config, device,
                 params: Optional[Dict] = None):
        self.config = config
        self.name = config.speculative_draft_model
        self.device = torch.device(device)
        mc = get_model_config(self.name)
        if config.dtype:
            mc = mc.replace(dtype=config.dtype)
        if mc.vocab_size != target_model_config.vocab_size:
            raise ValueError(
                f"speculative_draft_model {self.name!r} has vocab "
                f"{mc.vocab_size}, target has {target_model_config.vocab_size}"
                " — draft tokens must be target tokens")
        self.model_config = mc
        init_fn, self._apply = build_model(mc)
        if params is None and has_checkpoint(self.name):
            # A checkpoint directory: its weights, the whole tree (a
            # drafter has no LoRA slots to keep).
            params = draft_params_from_numpy(
                load_checkpoint(mc, self.name), config, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            with torch.no_grad():
                params = init_fn(mc, gen, self.device)
        self.params = params

        self.num_blocks = (
            config.max_blocks_per_seq * config.max_num_seqs + 1)
        shape = (mc.num_layers, self.num_blocks, config.block_size,
                 mc.num_kv_heads, mc.head_dim)
        self.kv = tuple(torch.zeros(shape, dtype=mc.torch_dtype,
                                    device=self.device) for _ in range(2))
        self.kv_mgr = KVCacheManager(
            self.num_blocks, config.block_size, enable_prefix_caching=False,
            namespace=f"draft|{self.name}")
        # request_id -> tokens the drafter's pages cover (positions
        # 0..computed-1 written).
        self.computed: Dict[str, int] = {}

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return to_device(torch.from_numpy(x), self.device)

    # -- programs ----------------------------------------------------------
    def forward(self, tokens, positions, slot_mapping, block_tables,
                context_lens, seq_lens, mask_bits, mask_on) -> torch.Tensor:
        """Greedy next token [B] (on the device) of each row's last real
        position, its pages written first. Host arrays in: tokens,
        positions, slot_mapping [B, W] (slot -1: no write), block_tables
        [B, MAXB], context_lens and seq_lens [B], the packed mask rows
        [B, MB] and their gates [B]. A padding row is token 0 at position
        0, context 1, seq_len 1, slot -1, an all-zero table. Every live
        row's positions ascend over the whole bucket, past its seq_len
        too: the cached-prefill kernel takes a query tile's key range from
        the tile's last position."""
        seq_lens_t = self._t(seq_lens)
        logits, _ = self._apply(
            self.params, self.model_config, self._t(tokens),
            self._t(positions), self.kv, torch.from_numpy(slot_mapping),
            self._t(block_tables), self._t(context_lens), seq_lens_t,
            mode="prefill_cached", adapter_ids=None,
            last_token=torch.clamp(seq_lens_t - 1, min=0))
        shaped = apply_fsm_mask(logits[:, 0], self._t(mask_bits),
                                self._t(mask_on))
        return torch.argmax(shaped, dim=-1)

    def scan(self, token0, positions0, slot_mat, block_tables,
             context0) -> torch.Tensor:
        """``slot_mat.shape[1]`` greedy decode steps from ``token0`` [B]
        at ``positions0`` [B] over contexts ``context0`` [B] (step s at
        position positions0 + s, context context0 + s, page slot
        slot_mat[:, s]). Returns the drafted tokens [B, S] on the
        device."""
        S = slot_mat.shape[1]
        tokens = self._t(token0)
        positions0_t, context0_t = self._t(positions0), self._t(context0)
        tables = self._t(block_tables)
        ones = torch.ones_like(context0_t)
        out = []
        for s in range(S):
            logits, _ = self._apply(
                self.params, self.model_config, tokens[:, None],
                (positions0_t + s)[:, None], self.kv,
                torch.from_numpy(slot_mat[:, s:s + 1]), tables,
                context0_t + s, ones, mode="decode", adapter_ids=None)
            tokens = torch.argmax(logits[:, 0], dim=-1)
            out.append(tokens)
        return torch.stack(out, dim=1)

    # -- host bookkeeping --------------------------------------------------
    def buckets(self):
        """The catch-up span buckets: the target's prefill buckets up to
        its chunk bucket."""
        cfg = self.config
        buckets = cfg.prefill_buckets()
        if cfg.prefill_chunk_size:
            buckets = [
                b for b in buckets
                if b <= cfg.bucket_for(
                    min(cfg.prefill_chunk_size, cfg.max_model_len))
            ]
        return buckets

    def ensure_capacity(self, rid: str, total: int) -> bool:
        """Grow the draft page table of ``rid`` to cover ``total`` tokens
        (the coming burst's worst case). False when the pool is out of
        pages: the caller runs a plain burst instead."""
        seq = self.kv_mgr.seqs.get(rid)
        if seq is None:
            res = self.kv_mgr.allocate_prompt(rid, [0] * max(total, 1))
            if res is None:
                return False
            # No allocator state refers to these blocks (prefix caching is
            # off); zero the registration frontier, which advances over
            # full blocks even so, so rollback_tokens can release the
            # pages of rejected draft positions.
            self.kv_mgr.seqs[rid].num_registered = 0
            self.computed[rid] = 0
            return True
        while seq.num_tokens < total:
            if not self.kv_mgr.append_token(rid, 0):
                return False
        return True

    def truncate(self, rid: str, keep: int) -> None:
        """Roll the draft table back to ``keep`` tokens after a verify
        (rejected draft positions release their pages, as the target's
        rollback does)."""
        seq = self.kv_mgr.seqs.get(rid)
        if seq is None:
            return
        if seq.num_tokens > keep:
            self.kv_mgr.rollback_tokens(rid, seq.num_tokens - keep)
        if self.computed.get(rid, 0) > keep:
            self.computed[rid] = keep

    def release(self, rid: str) -> None:
        """The target's free hook: the request is gone (finished,
        preempted or aborted); drop its draft pages and frontier."""
        self.kv_mgr.free(rid)
        self.computed.pop(rid, None)

    def block_table(self, rid: str):
        return self.kv_mgr.block_table(rid)
