"""The per-layer readings of a traced run that need the device trace and
the frozen counts (``flops.py``); each ``metrics/<name>.py`` calls one.

Tokens are attributed to the traced window by the time the engine handed
them to their stream; a prompt is attributed by its first token. Every
function returns None where its run has nothing to read (no trace, no
kernel of that name, no token).
"""

from __future__ import annotations

from typing import Optional

from portbench import devtrace, flops


def _in(run, t) -> bool:
    return t is not None and run.dev_open <= t < run.dev_close


def decode_tokens(run):
    """(request, output index j >= 1) of each token a decode step made,
    handed out in the traced window: its input sat at position
    prompt + j - 1, so its attention read prompt + j positions."""
    for r in run.requests:
        for j, t in enumerate(r["token_times"]):
            if j >= 1 and _in(run, t):
                yield r, j


def prefills(run):
    return [r for r in run.requests
            if r["token_times"] and _in(run, r["token_times"][0])]


def matmul_us_per_tok(run) -> Optional[float]:
    mm = devtrace.kernel_seconds(run.trace, devtrace.MATMUL)
    if mm is None:
        return None
    n = sum(1 for _ in decode_tokens(run)) + sum(
        max(r["prompt_len"] - r["shared"], 1) for r in prefills(run))
    return 1e6 * mm / n if n else None


def paged_decode_roofline(run) -> Optional[float]:
    k = devtrace.kernel_seconds(run.trace, devtrace.PAGED_DECODE)
    if k is None:
        return None
    s = run.shape
    nbytes = ops = 0.0
    for r, j in decode_tokens(run):
        ctx = r["prompt_len"] + j
        nbytes += flops.decode_token_bytes(s, ctx, run.block)
        ops += flops.attention_flops(s, ctx)
    if nbytes <= 0:
        return None
    bound = max(nbytes / flops.PEAK_HBM_BYTES_PER_S,
                ops / flops.PEAK_BF16_FLOPS)
    return 100.0 * bound / k


def cached_prefill_roofline(run) -> Optional[float]:
    k = devtrace.kernel_seconds(run.trace, devtrace.CACHED_PREFILL)
    if k is None:
        return None
    ops = sum(flops.cached_prefill_flops(run.shape, r["prompt_len"],
                                         r["shared"], run.chunk)
              for r in prefills(run))
    if ops <= 0:
        return None
    return 100.0 * ops / flops.PEAK_BF16_FLOPS / k


def _traced(run) -> bool:
    """A trace with device activity in it (a CPU rehearsal has none)."""
    return run.trace is not None and bool(run.trace.events)


def device_idle_pct(run) -> Optional[float]:
    if not _traced(run) or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def mfu_pct(run) -> Optional[float]:
    if not _traced(run):
        return None
    s = run.shape
    total = sum(flops.token_flops(s, r["prompt_len"] + j, True)
                for r, j in decode_tokens(run))
    total += sum(flops.prefill_flops(s, r["prompt_len"], r["shared"])
                 for r in prefills(run))
    if total <= 0:
        return None
    return 100.0 * total / (run.trace.window_s * flops.PEAK_BF16_FLOPS)
