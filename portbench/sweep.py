"""Find an open-loop cell's knee: the highest offered rate it sustains
without a growing backlog. Run once, on the card, when a cell is
defined; its rate then goes into the traffic file as a number.

    python3 portbench/sweep.py --workload <cell> --rates 4,6,8,10 \\
        [--seed N] [--seconds 20]

One server a rate, in this process (the output check is skipped). A
JSON line a rate: TTFT p50/p90/p95 of the window's requests, their TTFT
over the window's first and last thirds, how many were still without a
first token when the window closed, and the engine's waiting queue at
the window's opening and close.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    from portbench import harness, run, spec

    run.prepare_env()

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    base = spec.load_cell(ROOT, args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        held = torch.cuda.memory_allocated()
        mix = dict(base.traffic, rate_rps=rate)
        cell = dataclasses.replace(base, traffic=mix, per_layer=[],
                                   end_to_end=[])
        seen = {}

        def keep(run):
            seen["run"] = run

        harness.run_cell(cell, args.seed, args.seconds, False,
                         check_output=False, inspect=keep)
        run = seen["run"]
        ttft = harness.ttft_values(run)
        w = run.window_requests()
        third = args.seconds / 3

        def part(lo, hi):
            v = [t for r, t in zip(w, ttft)
                 if lo <= r["start"] - run.t_open < hi]
            return harness.median(v)

        print(json.dumps({
            "rate_rps": rate, "requests": len(w),
            "memory_allocated_before": held,
            "ttft_p50_s": harness.median(ttft),
            "ttft_p90_s": harness.percentile(ttft, 90) if ttft else None,
            "ttft_p95_s": harness.percentile(ttft, 95) if ttft else None,
            "ttft_first_third_s": part(0, third),
            "ttft_last_third_s": part(2 * third, args.seconds),
            "no_first_token_at_close": sum(
                1 for r in w if r["first"] is None
                or r["first"] >= run.t_close),
            "waiting_at_open": run.stats0["num_requests_waiting"],
            "waiting_at_close": run.stats1["num_requests_waiting"],
            "prefix_hit_pct": 100.0 * run.delta("cached_tokens_total")
            / max(run.delta("prompt_tokens_total"), 1)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
