"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample
of the finished requests, drawn from the seed with the longest in it, is
run through the plain reference (``model.py``) as prompt followed by
the served tokens. For each served token the gap is the reference's
best logit at that position minus the reference's logit of the served
token (0 where they agree). The readings are the widest gap over the
sample, the mean gap and the share of tokens that are not the
reference's best; the configuration names which are compared, each
with its limit (``check.limits``).

The control puts the reference in the program's place at float8
weights (``precision="fp8"``): at the same positions of the same
sequences it reads the gap of the token the float8 forward puts first.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from portbench.reference import model
from portbench.spec import Shape


def sample(finished: List[dict], seed: int, tokens: int) -> List[dict]:
    """Finished requests (each with ``prompt`` and ``served`` ids and
    ``cached``, the prompt tokens the engine served from its prefix
    cache): the longest, then one that hit the prefix cache if any
    did, then others drawn from the seed, until ``tokens`` served tokens
    are in."""
    if not finished:
        return []
    rng = random.Random(f"{seed}:check")
    order = sorted(finished, key=lambda r: r["rid"])
    longest = max(order, key=lambda r: (len(r["prompt"]) + len(r["served"]),
                                        r["rid"]))
    rest = [r for r in order if r is not longest]
    rng.shuffle(rest)
    hits = [r for r in rest if r.get("cached", 0) > 0]
    picked = [longest] + hits[:1]
    rest = [r for r in rest if r not in picked]
    total = sum(len(r["served"]) for r in picked)
    for r in rest:
        if total >= tokens:
            break
        picked.append(r)
        total += len(r["served"])
    return picked


def _sequences(reqs: List[dict]):
    seqs = [r["prompt"] + r["served"][:-1] for r in reqs]
    starts = [len(r["prompt"]) - 1 for r in reqs]
    return seqs, starts


def reference_logits(s: Shape, seed: int, reqs: List[dict], device,
                     precision: str = "fp32",
                     margins=None) -> List[torch.Tensor]:
    seqs, starts = _sequences(reqs)
    return model.next_token_logits(s, seed, seqs, starts, device,
                                   precision=precision, margins=margins)


def _stats(gaps: torch.Tensor) -> Dict:
    return {"max_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "not_best_pct": 100.0 * float((gaps > 0).float().mean()),
            "tokens": int(gaps.numel())}


def served_gap(ref: List[torch.Tensor], reqs: List[dict]) -> Dict:
    """Readings of the served tokens' gaps under the reference logits:
    the widest, the mean, and the share of tokens not the reference's
    best."""
    return _stats(_gaps(ref, reqs))


def control_gap(ref: List[torch.Tensor], ctrl: List[torch.Tensor]) -> Dict:
    """The same readings for the tokens the control's logits put first,
    at the same positions."""
    gaps = []
    for r, c in zip(ref, ctrl):
        pick = c.argmax(-1)
        gaps.append(r.max(-1).values - r.gather(1, pick[:, None])[:, 0])
    return _stats(torch.cat(gaps))


def _gaps(ref: List[torch.Tensor], reqs: List[dict]) -> torch.Tensor:
    out = []
    for logits, r in zip(ref, reqs):
        served = torch.tensor(r["served"], device=logits.device)
        out.append(logits.max(-1).values
                   - logits.gather(1, served[:, None])[:, 0])
    return torch.cat(out)


def margins_at_widest(ref: List[torch.Tensor], reqs: List[dict],
                      margins: List[torch.Tensor], n: int = 5) -> Dict:
    """Whether the widest gaps sit where the routing is on edge: the
    reference's smallest router margin over the layers (``model.
    router_margin``) at the ``n`` served tokens with the widest gaps, the
    share of all served tokens with a smaller margin (in %), and the
    median margin over all of them."""
    gaps = _gaps(ref, reqs)
    m = torch.cat(margins).float()
    at = gaps.topk(min(n, gaps.numel())).indices
    return {"widest_gaps": [float(g) for g in gaps[at]],
            "margin_at_widest": [float(x) for x in m[at]],
            "margin_rank_at_widest": [100.0 * float((m < x).float().mean())
                                      for x in m[at]],
            "margin_median": float(m.median())}
