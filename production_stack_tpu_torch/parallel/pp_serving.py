"""Pipeline-parallel serving forward: the Llama-family layer stack staged
over a pipeline group, drop-in compatible with the model's ``apply``.

The port of ``production_stack_tpu/parallel/pp_serving.py``. Where the
JAX engine runs one SPMD program over a ``pp`` mesh axis, the port runs
one process a rank (``parallel/pp.py``), and :func:`make_pp_apply` wraps
the Llama layer function in a GPipe schedule:

- each stage holds its own layers of every ``layers`` leaf and LoRA
  layer leaf and a KV pool of its own layers, ``[L/pp, NB, bs, KVH, D]``
  (``parallel/sharding.py``), indexed ``0 .. L/pp - 1``: both attention
  kernels read that pool at a stage-local layer index;
- the batch splits into ``_microbatch_count(B, microbatches)``
  microbatches; stage 0 takes each from the embedding, the other stages
  receive it from the stage before, every stage runs its layers over it
  (into its own pool) and hands it on;
- after the last microbatch the last stage's hidden states (sliced to
  ``last_token`` first, which is exact) are shared with every stage, and
  every rank runs the final norm and the head, with the tp vocab gather:
  sampling runs replicated, as under tensor parallelism;
- within a stage the tensor-parallel collectives run as in ``apply``:
  tp x pp compose, one pipeline per tp index.

JAX's bubble ticks, which run every stage on garbage while the pipeline
fills and drains and mask their page writes to slot ``-1``, have no
counterpart: separate processes run no garbage ticks, a stage simply
waits for its input.

At ``microbatches = 1`` every product and kernel sees the shapes of the
``pp = 1`` forward, so the bits are pp 1's. More microbatches change
the row counts of the GEMMs and the decode kernel's split-K plan (it
depends on the batch), so a bf16 stream may then differ from pp 1 by
rounding; float32 streams are held equal at every microbatch count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops.attention import kv_page_data, valid_slots


def _microbatch_count(batch: int, requested: int) -> int:
    """Largest divisor of ``batch`` that is <= requested (>=1)."""
    m = max(min(requested, batch), 1)
    while batch % m:
        m -= 1
    return m


def make_pp_apply(group, microbatches: int = 1):
    """A pipeline-parallel ``apply`` for the Llama family over ``group``
    (this rank's ``PPGroup``). ``microbatches`` bounds the GPipe
    microbatch count per forward (the count is the largest divisor of the
    batch size, so any batch shape works). Returns a function with the
    exact signature of
    :func:`production_stack_tpu_torch.models.llama.apply`."""
    from production_stack_tpu_torch.models.llama import (
        _layer,
        embed_tokens,
        project_out,
        rope_tables,
    )

    def pp_apply(
        params: Dict,
        cfg: ModelConfig,
        token_ids: torch.Tensor,  # [B, T]
        positions: torch.Tensor,  # [B, T]
        kv_pages: tuple,  # this stage's [L/pp, NB, bs, KVH, D] each
        slot_mapping: torch.Tensor,  # [B, T]
        block_tables: torch.Tensor,  # [B, MAXB]
        context_lens: torch.Tensor,  # [B]
        seq_lens: torch.Tensor,  # [B]
        *,
        mode: str,
        adapter_ids: Optional[torch.Tensor] = None,
        output_hidden: bool = False,
        last_token: Optional[torch.Tensor] = None,
        tp=None,
    ) -> Tuple[torch.Tensor, tuple]:
        B, T = token_ids.shape
        M = _microbatch_count(B, microbatches)
        Bm = B // M
        k_all, v_all = kv_pages
        device = kv_page_data(k_all).device
        L = kv_page_data(k_all).shape[0]
        # Every stage embeds, as the JAX forward does before its
        # shard_map; stage 0's embedding feeds the pipeline.
        x, lora_layers, lora_scaling, adapter_ids = embed_tokens(
            params, cfg, token_ids, adapter_ids)
        layers = params["layers"]
        per_layer = [
            ({k: v[i] for k, v in layers.items()},
             None if lora_layers is None
             else {k: v[i] for k, v in lora_layers.items()})
            for i in range(L)]
        shape = (Bm, T, cfg.hidden_size)
        outs = []
        for m in range(M):
            rows = slice(m * Bm, (m + 1) * Bm)
            if group.first:
                xm = x[rows]
            else:
                xm = group.recv_prev(
                    group.post_recv(shape, cfg.torch_dtype, tag=m))
            pos = positions[rows]
            valid = valid_slots(slot_mapping[rows], device)
            rotary = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
            aid = adapter_ids[rows] if adapter_ids is not None else None
            for layer, (p, lora_p) in enumerate(per_layer):
                xm = _layer(cfg, mode, xm, p, lora_p, (k_all, v_all), layer,
                            pos, rotary, valid, block_tables[rows],
                            context_lens[rows], seq_lens[rows],
                            lora_scaling, aid, tp)
            if group.last:
                outs.append(xm)
            else:
                group.send_next(xm, tag=m)
        group.wait_sends()
        if group.last:
            x = torch.cat(outs) if M > 1 else outs[0]
            if last_token is not None:
                x = x[torch.arange(B, device=x.device), last_token][:, None]
        else:
            width = 1 if last_token is not None else T
            x = torch.empty((B, width, cfg.hidden_size),
                            dtype=cfg.torch_dtype, device=device)
        x = group.share_last(x)
        return project_out(params, cfg, x, output_hidden, tp), (k_all, v_all)

    return pp_apply
