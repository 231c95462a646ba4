"""Draft-model speculative decoding A/B harness.

The port's counterpart of ``production_stack_tpu/testing/spec_draft_ab.py``,
on the port's :class:`EngineCore`, with the same legs, prompts, grammar
and counters:

- **Non-repetitive text** (:func:`run_nonrepetitive_ab`): prompts with no
  repeated n-gram, where prompt lookup has nothing to propose (its tokens
  per forward pin near 1.0), against a draft model, which proposes on any
  text. The drafter is the target model itself (identical weights, so
  greedy drafts are always right): the plumbing's ceiling on this
  workload, not a particular big/small pairing.
- **Structured JSON traffic** (:func:`run_structured_composition`): the
  same grammar-constrained traffic three ways. ``structured_alone`` (no
  speculation: a structured row takes one step a burst),
  ``drafter_alone`` (the drafter blind to the grammar,
  ``speculative_draft_constrain=False``: verify rejects at its first
  out-of-grammar token, and the fallback latches drafting off) and
  ``structured_drafter`` (the token FSM threaded into the drafter).

Tokens per forward is ``generation_tokens_total /
decode_forward_steps_total``: target forwards only; the drafter's are
``spec_draft_forward_steps``.

``_make_engine`` takes ``device`` and, optionally, ``params`` and
``draft_params`` (a test hands in the JAX engine's weights through
``models/convert.py``) and ``model`` / ``dtype``: tiny-llama as the JAX
harness on the CPU, tpu-llama-1b bf16 drafting for itself on the card.

  python -m production_stack_tpu_torch.testing.spec_draft_ab
  python -m production_stack_tpu_torch.testing.spec_draft_ab --device cpu \\
      --model tiny-llama --dtype float32 --max-tokens 8

Prints ONE JSON line (``"metric": "spec_draft_ab"``).
"""

from __future__ import annotations

import argparse
import json
import queue
import time
from typing import List, Optional, Tuple

# JSON-ish value grammar: every structural char is a forced (single
# allowed token) FSM state; only the 16 [ab] payload positions leave
# the drafter a real choice.
JSON_REGEX = '\\{"k": "[ab]{16}"\\}'

#: Prompt token streams with no repeated trigram (prompt lookup finds no
#: earlier occurrence of any current n-gram, so it drafts nothing).
NONREP_PROMPTS = (
    [31, 7, 2, 19, 44, 3, 28, 11],
    [13, 41, 5, 23, 37, 8, 29, 17, 47, 2],
    [6, 43, 12, 30, 9, 25, 40, 15],
)


def _make_engine(device="cuda", params=None, draft_params=None,
                 model: str = "tiny-llama", dtype: Optional[str] = None,
                 **over):
    """A started engine at the JAX harness's shape; a draft model named
    ``"self"`` is the target model (its weights ``draft_params``, or the
    drafter's own seeded init)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore

    if over.get("speculative_draft_model") == "self":
        over["speculative_draft_model"] = model
    kwargs = dict(
        model=model, device=str(device), max_model_len=256, max_num_seqs=4,
        block_size=8, num_blocks=128, min_prefill_bucket=16, max_loras=0,
    )
    if dtype:
        kwargs["dtype"] = dtype
    kwargs.update(over)
    eng = EngineCore(EngineConfig(**kwargs), params=params,
                     draft_params=(draft_params
                                   if kwargs.get("speculative_draft_model")
                                   else None))
    eng.start()
    return eng


def _run_leg(eng, requests: List[Tuple[str, list, object]],
             timeout_s: float = 600.0) -> dict:
    """Submit every request, drain them, and snapshot the speculation
    accounting; ``failed_requests`` counts those that finished with an
    error (one that never finishes raises). ``streams`` keeps each
    request's tokens."""
    done: "queue.Queue" = queue.Queue()
    finishes = {}
    streams = {}

    def make_cb(rid):
        def on_token(token, finish):
            if token is not None:
                streams.setdefault(rid, []).append(int(token))
            if finish is not None:
                finishes[rid] = finish
                done.put(rid)
        return on_token

    t0 = time.perf_counter()
    for rid, prompt_ids, sampling in requests:
        eng.add_request(rid, list(prompt_ids), sampling, make_cb(rid))
    remaining = len(requests)
    deadline = time.time() + timeout_s
    while remaining > 0 and time.time() < deadline:
        try:
            done.get(timeout=1.0)
            remaining -= 1
        except queue.Empty:
            continue
    wall = time.perf_counter() - t0
    if remaining:
        raise RuntimeError(f"{remaining} bench requests never finished")
    failed = sum(1 for f in finishes.values()
                 if f not in ("length", "stop"))
    return {
        "requests": len(requests),
        "failed_requests": failed,
        "generated_tokens": int(eng.generation_tokens_total),
        "decode_forwards": int(eng.decode_forward_steps_total),
        "tokens_per_forward": round(
            eng.generation_tokens_total
            / max(eng.decode_forward_steps_total, 1), 4),
        "wall_s": round(wall, 3),
        "spec_proposed_by_source": dict(eng.spec_proposed_by_source),
        "spec_accepted_by_source": dict(eng.spec_accepted_by_source),
        "spec_draft_forward_steps": int(eng.spec_draft_forward_steps_total),
        "spec_disabled_requests": int(eng.spec_disabled_requests_total),
        "streams": {rid: streams.get(rid, []) for rid, _, _ in requests},
    }


def _greedy_reqs(prefix: str, max_tokens: int,
                 guided_regex: Optional[str] = None,
                 n: int = 3) -> List[Tuple[str, list, object]]:
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    reqs = []
    for i in range(n):
        body = {"temperature": 0, "max_tokens": max_tokens,
                "ignore_eos": guided_regex is None}
        if guided_regex is not None:
            body["guided_regex"] = guided_regex
        reqs.append((f"{prefix}{i}", NONREP_PROMPTS[i % len(NONREP_PROMPTS)],
                     SamplingParams.from_request(body)))
    return reqs


def _leg(make, reqs) -> dict:
    eng = make()
    try:
        out = _run_leg(eng, reqs)
        out["structured_violations"] = int(
            eng.stats()["structured_violations_total"])
        return out
    finally:
        eng.stop()


def run_nonrepetitive_ab(*, max_tokens: int = 32, spec_tokens: int = 4,
                         **engine) -> dict:
    """Prompt lookup against the draft model on text with no repeats."""
    leg_ngram = _leg(lambda: _make_engine(
        speculative_num_tokens=spec_tokens, **engine),
        _greedy_reqs("ng", max_tokens))
    leg_draft = _leg(lambda: _make_engine(
        speculative_num_tokens=spec_tokens, speculative_draft_model="self",
        **engine), _greedy_reqs("dm", max_tokens))
    ratio = (leg_draft["tokens_per_forward"]
             / max(leg_ngram["tokens_per_forward"], 1e-9))
    return {
        "max_tokens": max_tokens,
        "speculative_num_tokens": spec_tokens,
        "prompt_lookup": leg_ngram,
        "draft_model": leg_draft,
        "tokens_per_forward_ratio": round(ratio, 4),
    }


def run_structured_composition(*, spec_tokens: int = 4,
                               max_tokens: int = 32, **engine) -> dict:
    """structured + drafter against structured alone and drafter alone,
    all on the same grammar-constrained traffic (``max_tokens`` past the
    grammar's length: the regex ends each request itself)."""
    leg_structured = _leg(lambda: _make_engine(**engine), _greedy_reqs(
        "sa", max_tokens, guided_regex=JSON_REGEX))
    leg_drafter = _leg(lambda: _make_engine(
        speculative_num_tokens=spec_tokens, speculative_draft_model="self",
        speculative_draft_constrain=False, **engine),
        _greedy_reqs("da", max_tokens, guided_regex=JSON_REGEX))
    leg_both = _leg(lambda: _make_engine(
        speculative_num_tokens=spec_tokens, speculative_draft_model="self",
        **engine), _greedy_reqs("sd", max_tokens, guided_regex=JSON_REGEX))
    return {
        "guided_regex": JSON_REGEX,
        "speculative_num_tokens": spec_tokens,
        "draft_model": engine.get("model", "tiny-llama"),
        "structured_alone": leg_structured,
        "drafter_alone": leg_drafter,
        "structured_drafter": leg_both,
        "structured_violations": leg_both["structured_violations"],
        "beats_structured_alone": (
            leg_both["tokens_per_forward"]
            > leg_structured["tokens_per_forward"]),
        "beats_drafter_alone": (
            leg_both["tokens_per_forward"]
            > leg_drafter["tokens_per_forward"]),
    }


def run_spec_draft_ab(*, max_tokens: int = 32, spec_tokens: int = 4,
                      **engine) -> dict:
    nonrep = run_nonrepetitive_ab(max_tokens=max_tokens,
                                  spec_tokens=spec_tokens, **engine)
    structured = run_structured_composition(spec_tokens=spec_tokens,
                                            **engine)
    failed = (nonrep["prompt_lookup"]["failed_requests"]
              + nonrep["draft_model"]["failed_requests"]
              + structured["structured_alone"]["failed_requests"]
              + structured["drafter_alone"]["failed_requests"]
              + structured["structured_drafter"]["failed_requests"])
    return {
        "metric": "spec_draft_ab",
        "unit": "tokens_per_forward_ratio",
        "value": nonrep["tokens_per_forward_ratio"],
        "nonrepetitive": nonrep,
        "structured_json": structured,
        "failed_requests": failed,
    }


def main(argv=None) -> dict:
    from production_stack_tpu_torch.probes import _profile_common as common

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--model", default="tpu-llama-1b")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--spec-tokens", type=int, default=4)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    out = run_spec_draft_ab(max_tokens=args.max_tokens,
                            spec_tokens=args.spec_tokens, device=device,
                            model=args.model, dtype=args.dtype)
    out.update(common.card(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
