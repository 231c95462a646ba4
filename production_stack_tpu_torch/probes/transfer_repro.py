"""The KV device pipe's two-process handshake, run in crash-isolated
subprocesses, and exactly what happens.

The port's counterpart of ``benchmarks/transfer_repro.py``, which showed
in subprocesses that ``jax.experimental.transfer`` is unimplemented on
the runtimes the JAX package could reach. The port's pipe
(``kv/device_pipe.py``) is CUDA IPC, and this leg runs its real
protocol:

  handshake   an offerer process puts a tensor on the device and shares
              it (``share``: its IPC handle as JSON); a puller process
              opens the handle (``open_shared``), copies the tensor into
              its own memory, checks it bit for bit and releases it; the
              offerer exits once it is released. Each step's result and
              time is printed, or the exact error and exit code of the
              process that failed.
  cross_host  a server process with the pipe on serves a prompt, then
              ``POST /kv/prepare_pull`` arrives with another host's key:
              the 409 that a puller on another host gets (it takes the
              HTTP relay instead), with its body.

A failure (a CUDA device the process cannot reach, a handle that does
not open) ends a child, never this process: a bad handle can abort the
process that opens it. On a host with no card the offerer's refusal is
printed and the leg exits non-zero.

  python -m production_stack_tpu_torch.probes.transfer_repro [--device cpu]

Prints ONE JSON line (``"metric": "transfer_repro"``); exits 0 only when
the handshake ran and the cross-host pull was refused with 409.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from production_stack_tpu_torch.probes import _profile_common as common

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_OFFER = r"""
import json, os, sys, time
import torch
from production_stack_tpu_torch.kv.device_pipe import share
device, path = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
x = torch.arange(1 << 20, dtype=torch.float32, device=device).to(
    torch.bfloat16).reshape(256, 4096)
if x.is_cuda:
    torch.cuda.synchronize()
desc = share(x)
with open(path + ".tmp", "w") as f:
    json.dump(desc, f)
os.rename(path + ".tmp", path)
print(json.dumps({"offered": {"kind": desc["kind"], "bytes":
      x.numel() * x.element_size(), "seconds": time.perf_counter() - t0}}),
      flush=True)
deadline = time.monotonic() + 120
while not os.path.exists(path + ".released"):
    if time.monotonic() > deadline:
        sys.exit(4)
    time.sleep(0.01)
"""

_PULL = r"""
import json, sys, time
import torch
from production_stack_tpu_torch.kv.device_pipe import open_shared
path = sys.argv[1]
with open(path) as f:
    desc = json.load(f)
t0 = time.perf_counter()
view = open_shared(desc)
opened = time.perf_counter()
got = view.clone()
if got.is_cuda:
    torch.cuda.synchronize()
copied = time.perf_counter()
want = torch.arange(1 << 20, dtype=torch.float32, device=got.device).to(
    torch.bfloat16).reshape(256, 4096)
equal = bool(torch.equal(got, want))
del view
open(path + ".released", "w").close()
print(json.dumps({"pulled": {"device": str(got.device), "equal": equal,
      "open_seconds": opened - t0, "copy_seconds": copied - opened}}),
      flush=True)
sys.exit(0 if equal else 5)
"""


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p), **extra)


def _outcome(proc: subprocess.CompletedProcess) -> dict:
    """A child's result: its JSON line, or its exit code and the last
    lines of what it printed."""
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    out = {"exit_code": proc.returncode}
    if lines:
        out.update(json.loads(lines[-1]))
    if proc.returncode != 0:
        out["stderr_tail"] = proc.stderr.strip().splitlines()[-6:]
    return out


def handshake(device: str, timeout: float = 180.0) -> dict:
    """Offerer and puller, each a process of its own."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "offer.json")
        offerer = subprocess.Popen(
            [sys.executable, "-c", _OFFER, device, path], env=_env(),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if offerer.poll() is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if not os.path.exists(path):
            if offerer.poll() is None:
                offerer.kill()
            stdout, stderr = offerer.communicate()
            return {"ok": False, "failed": "offer",
                    "offer": _outcome(subprocess.CompletedProcess(
                        offerer.args, offerer.returncode, stdout, stderr))}
        pull = subprocess.run(
            [sys.executable, "-c", _PULL, path], env=_env(), cwd=REPO,
            capture_output=True, text=True, timeout=timeout)
        try:
            stdout, stderr = offerer.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            offerer.kill()
            stdout, stderr = offerer.communicate()
        offer = _outcome(subprocess.CompletedProcess(
            offerer.args, offerer.returncode, stdout, stderr))
        pulled = _outcome(pull)
        ok = (offer["exit_code"] == 0 and pulled["exit_code"] == 0
              and pulled.get("pulled", {}).get("equal", False))
        return {"ok": ok, "offer": offer, "pull": pulled}


def cross_host(device: str) -> dict:
    """A pipe-enabled server in a child process refuses a puller from
    another host with 409."""
    from production_stack_tpu_torch.probes import kv_handoff_bench as kvb

    args = kvb.server_args("tiny-llama", device, 256, "float32", 16)
    proc, port = kvb.start_child(args, env={"TPU_STACK_KV_DEVICE_PIPE": "1"})
    try:
        tokens = list(range(1, 65))
        status, _ = kvb.post(port, "/v1/completions", {
            "prompt": tokens, "max_tokens": 1, "temperature": 0.0})
        same = kvb.post(port, "/kv/prepare_pull", {
            "token_ids": tokens, "host_key": "another-host"})
        return {"ok": same[0] == 409, "served": status,
                "prepare_pull_status": same[0], "body": same[1]}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = "cuda:0" if args.device == "cuda" else args.device
    out = {"metric": "transfer_repro", "requested_device": args.device}
    out["handshake"] = handshake(device)
    if out["handshake"]["ok"]:
        out["cross_host"] = cross_host(args.device)
        out.update(common.card(device))
    out["ok"] = bool(out["handshake"]["ok"]
                     and out.get("cross_host", {}).get("ok"))
    common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
