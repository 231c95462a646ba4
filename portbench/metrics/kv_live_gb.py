"""Scheduling: the KV cache the requests in flight hold, averaged over
the window, in GB (1e9 bytes). A request holds the pages of its prompt
from the engine's prefill start (its first token where the span is
missing), and one token more with each token handed to its stream,
until its last; pages are whole blocks of bfloat16 keys and values in
every layer. Counted from the run's own log, so it shows how much of the
pool the traffic fills, whatever pool the configuration reserves."""

import math

from portbench import flops


def _pages(run, tokens):
    return math.ceil(tokens / run.block)


def read(run):
    s = run.shape
    page = 2 * s.layers * s.kv_heads * s.head_dim * flops.BF16 * run.block
    held = 0.0  # page-seconds inside the window
    for r in run.requests:
        times = r["token_times"]
        start = r["prefill_start"] if r["prefill_start"] is not None else (
            times[0] if times else None)
        if start is None:
            continue
        # (from, to, tokens held) for each stretch of the request's life.
        edges = [start] + list(times)
        for k in range(len(times)):
            lo = max(edges[k], run.t_open)
            hi = min(edges[k + 1], run.t_close)
            if hi > lo:
                held += (hi - lo) * _pages(run, r["prompt_len"] + k)
    if held == 0.0:
        return None
    return held * page / run.seconds / 1e9
