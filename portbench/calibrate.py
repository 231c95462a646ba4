"""Readings for a cell's output-check limits: for each seed, one run of
the cell (as ``run.py`` makes it) that also reads the control (the plain
reference at float8 weights) and the bfloat16 witness at the same
positions, and judges the control by the configuration's own limits.
The program's readings over the seeds give each limit's lower reading,
the control's its upper one. For a MoE it also reads the reference's
router margins at the widest gaps (``reference/check.py``).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 30]

All seeds in this process, one server each. A JSON line a seed. Exits 1
unless the control comes out not correct on every seed.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    seconds = args.seconds or cell.run_seconds
    control_passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(cell, seed, seconds, False, control=True)
        if res["control_correct"]:
            control_passed.append(seed)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": res["control_correct"],
                          "readings": res["readings"],
                          "check": res["check"],
                          "metrics": res["metrics"],
                          "failed": res["failed"],
                          "attempted": res["attempted"],
                          "memory_allocated_after": torch.cuda.memory_allocated()}),
              flush=True)
        torch.cuda.empty_cache()
    if control_passed:
        print("the control passed the limits on seeds "
              + ",".join(map(str, control_passed)), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
