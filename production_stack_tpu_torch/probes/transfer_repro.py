"""The KV device pipe's two transports, each run between
crash-isolated subprocesses, and exactly what happens.

The port's counterpart of ``benchmarks/transfer_repro.py``, which showed
in subprocesses that ``jax.experimental.transfer`` is unimplemented on
the runtimes the JAX package could reach. The port's pipe
(``kv/device_pipe.py``) moves pages over CUDA IPC on one host and over a
two-rank communicator between hosts, and this leg runs both protocols:

  handshake   an offerer process puts a tensor on the device and shares
              it (``share``: its IPC handle as JSON); a puller process
              opens the handle (``open_shared``), copies the tensor into
              its own memory, checks it bit for bit and releases it; the
              offerer exits once it is released.
  cross_host  an offerer process parks a tensor in its pipe (no IPC
              handle); a puller process whose pipe names another host
              pulls it twice over the network transport (the first pull
              makes the pair: the rendezvous), checks each bit for bit,
              and reports each pull's rendezvous, transfer and host
              times. NCCL with a card for each process on a host of two
              or more cards, gloo on CPU tensors otherwise (``--device
              cpu``, or a host of one card, where NCCL cannot hold both
              ranks).

Each step's result and time is printed, or the exact error and exit
code of the process that failed. A failure (a CUDA device the process
cannot reach, a handle that does not open, a peer that never joins)
ends a child, never this process: a bad handle can abort the process
that opens it. On a host with no card the offerer's refusal is printed
and the leg exits non-zero.

  python -m production_stack_tpu_torch.probes.transfer_repro [--device cpu]

Prints ONE JSON line (``"metric": "transfer_repro"``); exits 0 only when
both legs ran and every pulled tensor is bit for bit the offered one.
"""

from __future__ import annotations

import argparse
import json
import os
import select
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


_NET_OFFER = r"""
import json, sys, time
import torch
from production_stack_tpu_torch.kv.device_pipe import KVDevicePipe
device = sys.argv[1]
t0 = time.perf_counter()
pipe = KVDevicePipe(device, timeout=120.0)
x = torch.arange(1 << 20, dtype=torch.float32, device=device).to(
    torch.bfloat16).reshape(256, 4096)
uuid = pipe.offer([x], ipc=False)
print(json.dumps({"offered": {"port": pipe.transfer_port, "uuid": uuid,
      "token": pipe.token(uuid), "device": str(x.device),
      "bytes": x.numel() * x.element_size(),
      "seconds": time.perf_counter() - t0}}), flush=True)
sys.stdin.readline()  # the puller has ended
pipe.close()
"""

_NET_PULL = r"""
import json, sys, time
import torch
from production_stack_tpu_torch.kv.device_pipe import KVDevicePipe
device = sys.argv[1]
pipe = KVDevicePipe(device, timeout=120.0)
port, uuid, token = sys.stdin.readline().split()  # the offer
pipe.host = "another-host"
want = torch.arange(1 << 20, dtype=torch.float32, device=device).to(
    torch.bfloat16).reshape(256, 4096)
leaves = [{"shape": [256, 4096], "dtype": "bfloat16"}]
pulls = []
for _ in range(2):
    stats = {}
    t0 = time.perf_counter()
    got = pipe.pull(f"127.0.0.1:{port}", int(uuid), leaves, stats=stats,
                    token=token)[0]
    seconds = time.perf_counter() - t0
    pulls.append(dict(stats, seconds=seconds, device=str(got.device),
                      equal=bool(torch.equal(got.view(torch.int16),
                                             want.view(torch.int16)))))
pipe.close()
equal = all(p["equal"] for p in pulls)
print(json.dumps({"pulled": {"pulls": pulls, "equal": equal}}), flush=True)
sys.exit(0 if equal else 5)
"""


def cross_host(backend: str = "gloo", timeout: float = 180.0) -> dict:
    """The network transport between an offerer and a puller process
    whose pipe names another host: ``"nccl"`` from ``cuda:0`` to
    ``cuda:1``, ``"gloo"`` between CPU tensors."""
    devices = ("cuda:0", "cuda:1") if backend == "nccl" else ("cpu", "cpu")
    # Both start at once; the puller reads the offer from its stdin.
    offerer, puller = (subprocess.Popen(
        [sys.executable, "-c", script, dev], env=_env(), cwd=REPO,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for script, dev in ((_NET_OFFER, devices[0]),
                            (_NET_PULL, devices[1])))
    try:
        ready, _, _ = select.select([offerer.stdout], [], [], timeout)
        line = offerer.stdout.readline() if ready else ""
        if not line.startswith("{"):
            for proc in (offerer, puller):
                proc.kill()
            stdout, stderr = offerer.communicate()
            puller.communicate()
            return {"ok": False, "failed": "offer", "backend": backend,
                    "offer": _outcome(subprocess.CompletedProcess(
                        offerer.args, offerer.returncode, line + stdout,
                        stderr))}
        offered = json.loads(line)["offered"]
        p_out, p_err = puller.communicate(
            f"{offered['port']} {offered['uuid']} {offered['token']}\n",
            timeout=timeout)
        stdout, stderr = offerer.communicate("\n", timeout=60)
    except subprocess.TimeoutExpired as e:
        return {"ok": False, "failed": f"timeout: {e}", "backend": backend}
    finally:
        for proc in (offerer, puller):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    pull = subprocess.CompletedProcess(puller.args, puller.returncode, p_out,
                                       p_err)
    offer = _outcome(subprocess.CompletedProcess(
        offerer.args, offerer.returncode, line + stdout, stderr))
    pulled = _outcome(pull)
    offer["offered"].pop("token", None)
    ok = (offer["exit_code"] == 0 and pulled["exit_code"] == 0
          and pulled.get("pulled", {}).get("equal", False))
    return {"ok": ok, "backend": backend, "offer": offer, "pull": pulled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = "cuda:0" if args.device == "cuda" else args.device
    out = {"metric": "transfer_repro", "requested_device": args.device}
    out["handshake"] = handshake(device)
    if out["handshake"]["ok"]:
        import torch

        backend = ("nccl" if args.device != "cpu"
                   and torch.cuda.device_count() >= 2 else "gloo")
        out["cross_host"] = cross_host(backend)
        if args.device != "cpu" and backend == "gloo":
            out["cross_host"]["note"] = (
                "one card: NCCL holds one rank a card, so the leg ran on "
                "CPU tensors over gloo")
        out.update(common.card(device))
    out["ok"] = bool(out["handshake"]["ok"]
                     and out.get("cross_host", {}).get("ok"))
    common.emit(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
