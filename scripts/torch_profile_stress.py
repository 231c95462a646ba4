"""Stress ``POST /debug/profile`` of the port's engine server on the card.

A child process serves tiny-llama (random weights, seed 0) on ``cuda``,
keeps four greedy completions of seeded, varied lengths running
back to back, and takes ``--per-child`` profile captures of ``--duration-s`` seconds each while
they run, so the profiler is switched on and off again and again beside
a thread that launches kernels. The parent starts children until
``--captures`` captures were asked for, so that a crash ends only its own
child's share, and prints one JSON line: captures asked and taken,
captures that failed, children that died and how, and what a capture's
request took beyond its duration. It exits 1 if a child
died or a capture failed.

    python3 scripts/torch_profile_stress.py [--captures 200] [--root DIR]
        [--device cpu]

``--root`` imports ``production_stack_tpu_torch`` from another checkout
(for example a parent commit unpacked with ``git archive``), so that two
versions of the server can be held to the same load in one run. Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
CLIENTS = 4  # completions kept running beside the captures
CHILD_TIMEOUT_S = 600


def _post(port: int, path: str, body: dict, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def child(args) -> int:
    """Serve, load and capture; print one JSON line of counts."""
    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server([
        "tiny-llama", "--device", args.device, "--host", "127.0.0.1",
        "--port", "0", "--max-model-len", "512", "--max-num-seqs", "8",
        "--seed", "0"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    stop = threading.Event()
    served = [0]

    def load(i: int) -> None:
        # Prompts and answers of seeded, varied lengths: new prefill and
        # batch shapes keep coming, and with them kernels used the first
        # time, while the captures switch the profiler on and off.
        rng = random.Random(args.seed * 1000 + i)
        while not stop.is_set():
            _post(port, "/v1/completions", {
                "prompt": [rng.randrange(1, 500)
                           for _ in range(rng.randrange(1, 400))],
                "max_tokens": rng.randrange(4, 96), "temperature": 0})
            served[0] += 1

    clients = [threading.Thread(target=load, args=(i,), daemon=True)
               for i in range(CLIENTS)]
    for th in clients:
        th.start()
    # The first capture starts with the first requests' prefills.
    taken = failed = 0
    waits = []
    t0 = time.perf_counter()
    try:
        for _ in range(args.per_child):
            t1 = time.perf_counter()
            out = _post(port, "/debug/profile",
                        {"duration_s": args.duration_s})
            waits.append(time.perf_counter() - t1 - args.duration_s)
            if out.get("ok") and out.get("files"):
                taken += 1
            else:
                failed += 1
    finally:
        stop.set()
        for th in clients:
            th.join(timeout=60)
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    print(json.dumps({"taken": taken, "failed": failed,
                      "completions": served[0], "overheads_s": waits,
                      "capture_s": time.perf_counter() - t0}), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--captures", type=int, default=200)
    p.add_argument("--per-child", type=int, default=50)
    p.add_argument("--duration-s", type=float, default=0.1)
    p.add_argument("--device", default="cuda",
                   help="cpu rehearses the script without a card")
    p.add_argument("--root", default=os.path.dirname(HERE),
                   help="checkout whose production_stack_tpu_torch runs")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(args)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(args.root))
    asked = taken = failed = 0
    deaths, overheads = [], []
    t0 = time.perf_counter()
    while asked < args.captures:
        n = min(args.per_child, args.captures - asked)
        asked += n
        cmd = [sys.executable, "-X", "faulthandler",
               os.path.abspath(__file__), "--child",
               "--per-child", str(n), "--duration-s", str(args.duration_s),
               "--device", args.device, "--seed", str(asked)]
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S)
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode == 0 and last.startswith("{"):
            got = json.loads(last)
            taken += got["taken"]
            failed += got["failed"]
            overheads += got["overheads_s"]
        else:
            lines = proc.stderr.strip().splitlines()
            # faulthandler's dump starts with the thread that crashed.
            at = next((i for i, ln in enumerate(lines)
                       if ln.startswith("Fatal Python error")), None)
            tail = lines[at:at + 30] if at is not None else lines[-6:]
            deaths.append({"rc": proc.returncode, "stderr_tail": tail})
            print(f"child died, rc {proc.returncode}", file=sys.stderr,
                  flush=True)
            print("\n".join(tail), file=sys.stderr, flush=True)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "captures_asked": asked, "captures_taken": taken,
                      "captures_failed": failed,
                      "children_died": len(deaths),
                      "death_rcs": [d["rc"] for d in deaths],
                      # A capture's request time beyond its duration:
                      # waiting for a step boundary, start, stop, export.
                      "overhead_s_median": (
                          statistics.median(overheads) if overheads
                          else None),
                      "overhead_s_max": max(overheads, default=None),
                      "duration_s": args.duration_s,
                      "clients": CLIENTS,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    return 1 if deaths or failed else 0


if __name__ == "__main__":
    sys.exit(main())
