"""Sampling: request parameters (host) and batched token selection (device).

The host half is a copy of the JAX engine's: :class:`SamplingParams`
(structured-output specs parsed by the port's own
``structured.parse_structured``), ``_strict_int`` and the capacities
baked into the serving programs.

The device half ports ``sample_tokens``, ``logprob_outputs`` and the logit
shaping of the serving programs (logit_bias, min_tokens EOS masking,
stop ids, presence/frequency penalties). Greedy rows take the argmax;
sampled rows draw ``categorical`` over the temperature-scaled top-k/top-p
candidates under a threefry key per row (``engine/prng.py``), the key
the JAX engine derives with ``make_rng_keys``, so a seeded request
samples the JAX engine's tokens. Speculative decoding adds the verify's
acceptance rule (``accepted_prefix_len``); structured output adds the
packed FSM mask term (``apply_fsm_mask``) that every sampling site
applies after the rest of the shaping.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from production_stack_tpu_torch.engine import prng
from production_stack_tpu_torch.structured.api import parse_structured


def _strict_int(body: dict, key: str) -> Optional[int]:
    """JSON-typed integer field: present -> must be an actual integer."""
    value = body.get(key)
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"'{key}' must be an integer")
    return value


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    max_tokens: int = 16
    stop: Optional[list] = None
    seed: Optional[int] = None
    ignore_eos: bool = False
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    n: int = 1
    # None = no logprobs; an int = return the sampled token's logprob plus
    # that many top alternatives (raw log-softmax, OpenAI semantics).
    logprobs: Optional[int] = None
    # EOS is suppressed until this many output tokens exist (vLLM's
    # min_tokens).
    min_tokens: int = 0
    # Extra token ids that finish the request like EOS (vLLM ext).
    stop_token_ids: Optional[list] = None
    # token id -> additive logit bias (capped at MAX_LOGIT_BIAS entries).
    logit_bias: Optional[dict] = None
    # Completions-only: prepend the prompt text to the output.
    echo: bool = False
    # Structured output: a StructuredSpec (guided_json / guided_regex /
    # response_format), compiled by the engine to a token FSM whose mask
    # joins the logit shaping at every sampling site.
    structured: Optional[object] = None

    @staticmethod
    def from_request(body: dict, default_max_tokens: int = 16) -> "SamplingParams":
        stop = body.get("stop")
        if isinstance(stop, str):
            stop = [stop]
        t = body.get("temperature")
        p = body.get("top_p")
        # completions: logprobs is an int (top-N); chat: logprobs is a
        # bool gated by top_logprobs (OpenAI schema).
        lp_raw = body.get("logprobs")
        if isinstance(lp_raw, bool):
            logprobs = (int(body.get("top_logprobs") or 0)
                        if lp_raw else None)
        elif lp_raw is None:
            logprobs = None
        else:
            logprobs = int(lp_raw)
        bias_raw = body.get("logit_bias") or {}
        if not isinstance(bias_raw, dict):
            raise ValueError("'logit_bias' must be an object")
        logit_bias = {}
        for k, v in bias_raw.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(
                    "'logit_bias' values must be numbers")
            try:
                logit_bias[int(k)] = float(v)
            except (TypeError, ValueError):
                raise ValueError(
                    "'logit_bias' keys must be token ids")
        structured = parse_structured(body)
        min_tokens = _strict_int(body, "min_tokens") or 0
        if structured is not None and min_tokens > 0:
            # In a completed FSM state only EOS is legal, while min_tokens
            # masks EOS: the two constraints cannot both hold.
            raise ValueError(
                "'min_tokens' is incompatible with structured output")
        return SamplingParams(
            temperature=1.0 if t is None else float(t),
            top_p=1.0 if p is None else float(p),
            top_k=int(body.get("top_k") or 0),
            max_tokens=(
                _strict_int(body, "max_tokens")
                or _strict_int(body, "max_completion_tokens")
                or default_max_tokens
            ),
            stop=stop,
            seed=body.get("seed"),
            ignore_eos=bool(body.get("ignore_eos", False)),
            presence_penalty=float(body.get("presence_penalty") or 0.0),
            frequency_penalty=float(body.get("frequency_penalty") or 0.0),
            n=max(int(body.get("n") or 1), 1),
            logprobs=logprobs,
            min_tokens=min_tokens,
            stop_token_ids=[int(t) for t in
                            (body.get("stop_token_ids") or [])] or None,
            logit_bias=logit_bias or None,
            echo=bool(body.get("echo", False)),
            structured=structured,
        )


# Sparse logit_bias capacity of the serving programs (requests exceeding
# it are rejected with a 400 at the API layer rather than truncated).
MAX_LOGIT_BIAS = 32

# stop_token_ids capacity (masked alongside EOS while min_tokens is unmet).
MAX_STOP_IDS = 8

# Static top-K for logprob outputs (requests clamp their top_logprobs).
LOGPROB_K = 8


def keep_candidates(logits: torch.Tensor,  # [B, V] float32
                    temperature: torch.Tensor,  # [B]
                    top_k: torch.Tensor,  # [B] int; 0 disables
                    top_p: torch.Tensor,  # [B]
                    max_top_k: int = 64):
    """The top-``max_top_k`` candidates of every row and their
    temperature-scaled logits with everything outside the row's top-k and
    top-p (nucleus) set at -inf. Returns (top_idx [B, K], masked [B, K])."""
    K = min(max_top_k, logits.shape[-1])
    top_vals, top_idx = torch.topk(logits, K, dim=-1)  # sorted descending
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = top_vals / temp
    ranks = torch.arange(K, device=logits.device)[None, :]
    k_eff = torch.where(top_k[:, None] <= 0, K,
                        torch.clamp(top_k[:, None], max=K))
    keep_k = ranks < k_eff
    neg_inf = torch.full_like(scaled, float("-inf"))
    probs = torch.softmax(torch.where(keep_k, scaled, neg_inf), dim=-1)
    cumprobs = torch.cumsum(probs, dim=-1)
    keep_p = (cumprobs - probs) < top_p[:, None]  # always keeps rank 0
    return top_idx, torch.where(keep_k & keep_p, scaled, neg_inf)


# Per-sequence sampling keys from (engine seed, step, sequence seed), as
# the JAX engine's sampling module derives them.
make_rng_keys = prng.make_rng_keys


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    rng_keys: torch.Tensor,  # [B, 2] key data (one key per sequence)
    temperature: torch.Tensor,  # [B] float32; <= 0 means greedy
    top_k: torch.Tensor,  # [B] int; 0 disables
    top_p: torch.Tensor,  # [B] float32
    *,
    max_top_k: int = 64,
) -> torch.Tensor:
    """Sampled token ids [B]: argmax for greedy rows, ``categorical`` over
    the kept candidates under each row's key for the others."""
    K = min(max_top_k, logits.shape[-1])
    return sample_with_gumbel(logits, prng.gumbel(rng_keys, K), temperature,
                              top_k, top_p, max_top_k=max_top_k)


def sample_with_gumbel(logits, gumbel, temperature, top_k, top_p, *,
                       max_top_k: int = 64) -> torch.Tensor:
    """:func:`sample_tokens` with each row's Gumbel noise ``[B, K]``
    (``prng.gumbel`` of its key) drawn beforehand: a decode burst draws
    the noise of all its steps in one pass."""
    greedy_ids = torch.argmax(logits, dim=-1)
    top_idx, masked = keep_candidates(logits, temperature, top_k, top_p,
                                      max_top_k)
    choice = torch.argmax(gumbel + masked, dim=-1)
    sampled_ids = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy_ids, sampled_ids)


def logprob_outputs(logits: torch.Tensor, sampled: torch.Tensor,
                    k: int = LOGPROB_K):
    """Raw log-softmax stats for the OpenAI logprobs surface:
    (chosen_lp [B], top_lp [B, k], top_ids [B, k])."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(lp, 1, sampled[:, None].long())[:, 0]
    top_lp, top_ids = torch.topk(lp, k, dim=-1)
    return chosen, top_lp, top_ids


# Structured-output FSM mask: finite large-negative (like the stop-id term)
# so temperature scaling cannot make NaNs the way -inf can.
FSM_MASK_NEG = -1e30


def fsm_allowed(mask_bits: torch.Tensor,  # [B, ceil(V/8)] uint8
                mask_on: torch.Tensor,  # [B] bool
                vocab_size: int) -> torch.Tensor:
    """The allowed tokens ``[B, V]`` (bool) of packed FSM mask rows: bit
    ``v`` of row ``b`` (little bit order, ``numpy.packbits(...,
    bitorder="little")``) allows token ``v``; a row with ``mask_on``
    false allows every token."""
    B, MB = mask_bits.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=mask_bits.device)
    bits = (mask_bits[:, :, None] >> shifts[None, None, :]) & 1
    bits = bits.reshape(B, MB * 8)[:, :vocab_size]
    return (bits != 0) | ~mask_on[:, None]


def mask_disallowed(logits: torch.Tensor,
                    allowed: torch.Tensor) -> torch.Tensor:
    """``logits`` with the tokens ``allowed`` leaves out at
    ``FSM_MASK_NEG``."""
    return torch.where(allowed, logits,
                       torch.full_like(logits, FSM_MASK_NEG))


def apply_fsm_mask(logits: torch.Tensor,  # [B, V]
                   mask_bits: torch.Tensor,  # [B, ceil(V/8)] uint8
                   mask_on: torch.Tensor,  # [B] bool
                   ) -> torch.Tensor:
    """The dense packed-bitmask grammar term of the serving programs
    (:func:`fsm_allowed`): rows with ``mask_on`` false pass through
    unchanged; disallowed tokens get ``FSM_MASK_NEG``."""
    return mask_disallowed(
        logits, fsm_allowed(mask_bits, mask_on, logits.shape[-1]))


def accepted_prefix_len(draft, sampled_row) -> int:
    """Speculative-verify acceptance: how many draft tokens equal, in
    order from the first, what the verify sampled at their positions
    (under plain decode's keys and shaping). The caller emits
    ``sampled_row[:j + 1]``: the ``j`` accepted drafts and the sample at
    the first mismatch."""
    j = 0
    for d in draft:
        if int(sampled_row[j]) != int(d):
            break
        j += 1
    return j


def shape_logits(
    logits: torch.Tensor,  # [B, V] float32
    *,
    bias_ids: torch.Tensor,  # [B, MAX_LOGIT_BIAS] (padding: id 0, value 0)
    bias_vals: torch.Tensor,
    suppress: torch.Tensor,  # [B] bool: min_tokens not yet met
    stop_ids: torch.Tensor,  # [B, MAX_STOP_IDS]
    stop_valid: torch.Tensor,  # [B, MAX_STOP_IDS] float 1/0
    eos_id: int,  # -1 when the tokenizer has none
    counts: Optional[torch.Tensor] = None,  # [B, V] output-token counts
    presence_penalty: Optional[torch.Tensor] = None,  # [B]
    frequency_penalty: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """The serving programs' logit shaping, in their order: penalties
    over the slot's output-token counts (decode only), sparse logit_bias,
    EOS masked while min_tokens is unmet, and stop ids masked alongside
    it (finite sentinel: -inf * 0 padding would make NaNs)."""
    shaped = logits
    if counts is not None:
        shaped = (shaped - frequency_penalty[:, None] * counts
                  - presence_penalty[:, None] * (counts > 0))
    shaped = shaped.scatter_add(1, bias_ids.long(), bias_vals)
    if eos_id >= 0:
        vocab = torch.arange(shaped.shape[1], device=shaped.device)
        shaped = torch.where(
            suppress[:, None] & (vocab[None, :] == eos_id),
            torch.full_like(shaped, float("-inf")), shaped)
    return shaped.scatter_add(
        1, stop_ids.long(),
        -1e30 * stop_valid * suppress.float()[:, None])

