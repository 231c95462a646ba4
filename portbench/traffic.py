"""The one traffic generator: a mix file's parameters and a seed in, the
run's requests out. Standard library only (the client process imports
it too).

A mix is a JSON object:

- ``loop``: ``"closed"`` (``clients`` callers, each sending its next
  request as soon as the last one finished, after ``think_s``; caller
  ``c`` starts at ``c * stagger_s / clients``) or ``"open"``
  (``rate_rps`` requests a second on a schedule, whatever the server
  does);
- ``prompt`` and ``answer``: length distributions of the unshared part
  of a prompt and of the answer (``max_tokens``);
- ``system_prompt_tokens`` (optional): a prefix every prompt starts with;
- ``docs`` (open loop, optional): sessions that ask about one document
  several times: ``length`` of the document, ``asks`` a session, and
  ``ask_gap_s`` between two asks. A prompt is then the document followed
  by its own question (``prompt``);
- ``ramp_s``: traffic before the measured window opens; ``grace_s``:
  how long after the window closes a window request may still take to
  answer before it counts as failed.

A distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}``, ``{"dist": "uniform", "min", "max"}`` (integers, both ends
included), ``{"dist": "exponential", "mean"}`` or ``{"dist":
"constant", "value"}``.

Every seed gets the same sizes and gaps, in another order: a pool of n
draws is the distribution's quantiles at (i + 0.5) / n, shuffled by the
seed (in a closed loop, one pool a turn: every caller's first requests
together are the same sizes for every seed, and so on). So two seeds
offer the same work, and differ in which request gets which size, when,
and in every token id.
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics
from typing import Dict, List, Optional, Tuple

_NORMAL = statistics.NormalDist()


def quantile(dist: dict, u: float) -> float:
    kind = dist["dist"]
    if kind == "lognormal":
        x = math.exp(math.log(dist["median"])
                     + dist["sigma"] * _NORMAL.inv_cdf(u))
        return min(max(x, dist["min"]), dist["max"])
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return lo + min(int(u * (hi - lo + 1)), hi - lo)
    if kind == "exponential":
        return -dist["mean"] * math.log(1.0 - u)
    if kind == "constant":
        return dist["value"]
    raise ValueError(f"unknown distribution {kind!r}")


def mean(dist: dict) -> float:
    kind = dist["dist"]
    if kind == "uniform":
        return (dist["min"] + dist["max"]) / 2.0
    if kind == "exponential":
        return dist["mean"]
    if kind == "constant":
        return dist["value"]
    n = 4096
    return sum(quantile(dist, (i + 0.5) / n) for i in range(n)) / n


def pool(dist: dict, n: int, rng: random.Random, integer: bool) -> list:
    """``n`` quantiles of ``dist``, shuffled by ``rng``."""
    vals = [quantile(dist, (i + 0.5) / n) for i in range(n)]
    if integer:
        vals = [int(round(v)) for v in vals]
    rng.shuffle(vals)
    return vals


@dataclasses.dataclass
class Request:
    rid: str
    # Token segments of the prompt, in order: (key, length); a key names
    # the segment's token ids (shared keys: shared tokens).
    segments: List[Tuple[str, int]]
    max_tokens: int
    due: Optional[float] = None  # open loop: seconds after traffic start
    client: Optional[int] = None  # closed loop: the caller

    @property
    def prompt_len(self) -> int:
        return sum(n for _, n in self.segments)


@dataclasses.dataclass
class Schedule:
    loop: str
    requests: List[Request]  # open: by due time; closed: by caller, turn
    clients: int = 0
    starts: List[float] = dataclasses.field(default_factory=list)
    think_s: float = 0.0
    seed: int = 0
    vocab: int = 0

    def prompt_ids(self, req: Request) -> List[int]:
        return prompt_ids(self.seed, self.vocab, req.segments)

    def by_client(self) -> Dict[int, List[Request]]:
        out: Dict[int, List[Request]] = {}
        for r in self.requests:
            out.setdefault(r.client, []).append(r)
        return out


def segment_ids(seed: int, vocab: int, key: str, n: int) -> List[int]:
    rng = random.Random(f"{seed}:tokens:{key}")
    return [rng.randrange(vocab) for _ in range(n)]


def prompt_ids(seed: int, vocab: int, segments) -> List[int]:
    out: List[int] = []
    for key, n in segments:
        out.extend(segment_ids(seed, vocab, key, n))
    return out


def build(mix: dict, seed: int, vocab: int, seconds: float) -> Schedule:
    """The requests of one run of ``seconds`` measured seconds after
    ``mix["ramp_s"]`` of ramp."""
    horizon = float(mix.get("ramp_s", 0)) + float(seconds)
    rng = random.Random(f"{seed}:schedule")
    system = int(mix.get("system_prompt_tokens", 0))
    prefix = [("system", system)] if system else []
    if mix["loop"] == "closed":
        clients = int(mix["clients"])
        per = int(mix.get("requests_per_client", 64))
        # Each caller's k-th turn: the same ``clients`` quantiles at every
        # turn, dealt to the callers in the seed's order.
        turns = [(pool(mix["prompt"], clients, rng, True),
                  pool(mix["answer"], clients, rng, True))
                 for _ in range(per)]
        stagger = float(mix.get("stagger_s", 0.0))
        reqs = []
        for c in range(clients):
            for k, (prompts, answers) in enumerate(turns):
                reqs.append(Request(
                    rid=f"c{c}-{k}", client=c, max_tokens=answers[c],
                    segments=prefix + [(f"p{c}.{k}", prompts[c])]))
        return Schedule(
            loop="closed", requests=reqs, clients=clients,
            starts=[c * stagger / clients for c in range(clients)],
            think_s=float(mix.get("think_s", 0.0)), seed=seed, vocab=vocab)
    if mix["loop"] != "open":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    docs = mix.get("docs")
    asks_mean = mean(docs["asks"]) if docs else 1.0
    rate = float(mix["rate_rps"])
    n_sessions = max(1, int(round(horizon * rate / asks_mean)))
    gaps = pool(mix.get("arrival", {"dist": "exponential", "mean": 1.0}),
                n_sessions, rng, False)
    scale = horizon / sum(gaps)
    starts, t = [], 0.0
    for g in gaps:
        starts.append(t)
        t += g * scale
    if docs:
        doc_lens = pool(docs["length"], n_sessions, rng, True)
        asks = pool(docs["asks"], n_sessions, rng, True)
        ask_gaps = pool(docs["ask_gap_s"], sum(asks), rng, False)
    else:
        doc_lens, asks, ask_gaps = [0] * n_sessions, [1] * n_sessions, []
    n_req = sum(asks)
    questions = pool(mix["prompt"], n_req, rng, True)
    answers = pool(mix["answer"], n_req, rng, True)
    reqs, i, g = [], 0, 0
    for s in range(n_sessions):
        due = starts[s]
        for a in range(asks[s]):
            if a > 0:
                due += ask_gaps[g]
                g += 1
            segs = list(prefix)
            if doc_lens[s]:
                segs.append((f"d{s}", doc_lens[s]))
            segs.append((f"q{i}", questions[i]))
            if due < horizon:
                reqs.append(Request(rid=f"s{s}-{a}", due=due,
                                    max_tokens=answers[i], segments=segs))
            i += 1
    reqs.sort(key=lambda r: r.due)
    return Schedule(loop="open", requests=reqs, seed=seed, vocab=vocab)


def shared_prefix_tokens(prompts: List[List[int]], block: int) -> List[int]:
    """For each prompt, in the order given, the tokens of the longest
    ``block``-aligned prefix it shares with an earlier prompt: the
    tokens a prefix cache of ``block``-token pages can skip."""
    seen = set()
    out = []
    for ids in prompts:
        n_full = len(ids) // block
        hit = 0
        key = ()
        keys = []
        for b in range(n_full):
            key = hash((key, tuple(ids[b * block:(b + 1) * block])))
            keys.append(key)
        for k in keys:
            if k not in seen:
                break
            hit += 1
        out.append(hit * block)
        seen.update(keys)
    return out
