"""Disaggregated-prefill KV handoff bench.

The port's counterpart of ``benchmarks/kv_handoff_bench.py``: a prefill
engine and a decode engine, each behind the port's own server; a long
prompt (8,000 tokens of tpu-llama-1b by default) is served by the
prefill engine, then the decode engine pulls its prefix pages over
``POST /kv/pull`` and continues the prompt from them. The rungs of the
port's ladder:

  auto     both engines in this process: the local-device rung, card to
           card inside one process (``inject_from_core``)
  device   the prefill engine in a child process: the KV device pipe
           (``kv/device_pipe.py``: the source's ``/kv/prepare_pull``, its
           pages' CUDA IPC handles opened and copied here)
  network  the device rung with this engine's pipe naming another host:
           the pipe's network transport (a two-rank NCCL communicator
           between the two processes, gloo on the CPU); on a card the
           prefill engine runs on a second card (NCCL holds one rank a
           card), so the rung needs a host of two
  host     the prefill engine in a child process: the TKV2 relay over
           HTTP

Two distinct prompts go through, as in the JAX bench: the first pull
pays one-time costs (the network rung's rendezvous among them), the
second is the steady state. The result carries the bytes, seconds, GB/s
and the rung taken, the pipe's transport and its own times where the
pipe ran (IPC: open and copy; network: the rendezvous and the sends'
device time), the copy's byte bound (read and write of the bytes at
3.35e12 B/s), the network transfer's bound on the link between the two
cards (``_profile_common.link``), and the decode engine's greedy
continuation after the pull. The client is standard library (the
card's host has no ``aiohttp``).

  python -m production_stack_tpu_torch.probes.kv_handoff_bench [--path device]
  python -m production_stack_tpu_torch.probes.kv_handoff_bench --device cpu \\
      --model tiny-llama --dtype float32 --prompt-tokens 200

Prints ONE JSON line (``"metric": "kv_handoff"``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import torch

from production_stack_tpu_torch.probes import _profile_common as common

MODEL = "tpu-llama-1b"
PROMPT_TOKENS = 8000
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def post(port: int, path: str, body: dict, timeout: float = 900.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def server_args(model: str, device, prompt_tokens: int, dtype=None,
                block_size: int = 64) -> list:
    blocks = 2 * (prompt_tokens // block_size + 8)
    args = [model, "--device", str(device), "--host", "127.0.0.1",
            "--max-model-len", str(prompt_tokens + 256), "--max-num-seqs",
            "2", "--block-size", str(block_size), "--num-blocks",
            str(blocks), "--max-loras", "0", "--no-warmup"]
    return args + (["--dtype", dtype] if dtype else [])


def start_local(args: list):
    """A server of this process: (httpd, core, port)."""
    from production_stack_tpu_torch.engine.server import build_server

    httpd, core = build_server(args + ["--port", "0"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, core, httpd.server_address[1]


def stop_local(httpd, core) -> None:
    httpd.shutdown()
    httpd.server_close()
    core.stop()


def start_child(args: list, timeout: float = 600.0, env=None):
    """A server in a child process (a CUDA IPC handle opens only in
    another process), ``env`` added to its environment: (proc, port)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server"]
        + args + ["--port", str(port)], env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError("source server exited: "
                               + proc.stderr.read()[-2000:])
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=5):
                return proc, port
        except OSError:
            time.sleep(0.5)
    proc.kill()
    raise TimeoutError("source server never answered /health")


def prompts(n_tokens: int, vocab: int) -> list:
    """The JAX bench's two distinct prompts, folded into ``vocab``."""
    return [[(7 + 13 * i + 31 * r) % min(vocab, 30000) for i in
             range(n_tokens)] for r in (1, 2)]


def _pull_and_continue(d_port: int, s_port: int, path: str, tokens_list,
                       continue_tokens: int) -> tuple:
    """Each prompt served by the source, pulled by the decode engine over
    ``path`` and continued there: (pull answers, continuations)."""
    bodies, conts = [], []
    for tokens in tokens_list:
        status, out = post(s_port, "/v1/completions", {
            "prompt": tokens, "max_tokens": 2, "temperature": 0.0})
        if status != 200:
            raise RuntimeError(f"prefill: {status} {out}")
        status, out = post(d_port, "/kv/pull", {
            "source_url": f"http://127.0.0.1:{s_port}",
            "token_ids": tokens, "kv_path": path})
        if status != 200 or out.get("status") != "ok":
            raise RuntimeError(f"kv/pull ({path}): {status} {out}")
        bodies.append(out)
        status, cont = post(d_port, "/v1/completions", {
            "prompt": tokens, "max_tokens": continue_tokens,
            "temperature": 0.0, "ignore_eos": True})
        if status != 200:
            raise RuntimeError(f"continuation: {status} {cont}")
        conts.append(cont["choices"][0]["text"])
    return bodies, conts


def _result(device, model, prompt_tokens, path, bodies, conts, hits):
    t = bodies[-1]["transfer"]
    out = {
        "metric": "kv_handoff",
        **common.card(device),
        "model": model, "prompt_tokens": prompt_tokens,
        "path_requested": path,
        "injected_blocks": bodies[-1]["injected_blocks"],
        "num_tokens": bodies[-1]["num_tokens"],
        "path": t["path"], "bytes": t["bytes"],
        "seconds": t["total_seconds"],
        "gigabytes_per_second": t["bytes"] / max(t["total_seconds"],
                                                 1e-9) / 1e9,
        "cold_seconds": bodies[0]["transfer"]["total_seconds"],
        "copy_bound_ms": 1e3 * 2 * t["bytes"] / common.HBM_BYTES_PER_S,
        "prefix_cache_hits": hits,
        "continuations": conts,
    }
    for key in ("transport", "backend", "open_seconds", "copy_ms",
                "transfer_ms", "fetch_seconds"):
        if key in t:
            out[key] = t[key]
    if t.get("transport") == "network":
        out["rendezvous_seconds"] = bodies[0]["transfer"][
            "rendezvous_seconds"]
        out["transfer_gigabytes_per_second"] = (
            t["bytes"] / max(t["transfer_ms"], 1e-9) / 1e6)
        lk = (common.link(1, 0) if torch.device(device).type == "cuda"
              else {"link": "loopback (no published rate)",
                    "gigabytes_per_second": None})
        out["link"] = lk["link"]
        out["link_bound_ms"] = (t["bytes"] / lk["gigabytes_per_second"] / 1e6
                                if lk["gigabytes_per_second"] else None)
    return out


def run_paths(model: str = MODEL, prompt_tokens: int = PROMPT_TOKENS,
              paths=("auto",), device="cuda", dtype=None,
              continue_tokens: int = 8, block_size: int = 64,
              source=None) -> dict:
    """Each rung of ``paths`` with a fresh decode engine of this process;
    ``auto``'s source is a server of this process, the ``device`` and
    ``host`` rungs share one source process (and ``network`` too on the
    CPU; on a card it takes a source process on card 1). Both prompts go
    through each rung; the second pull's transfer is its result.
    ``source``, a ``(proc, port)`` of :func:`start_child` on
    :func:`server_args`, is the shared source process, started beforehand
    (it is stopped here)."""
    device = common.resolve_device(str(device))
    args = server_args(model, device, prompt_tokens, dtype, block_size)
    child, c_port = source if source is not None else (None, None)
    results = {}
    try:
        for path in paths:
            d_httpd, d_core, d_port = start_local(args)
            s_httpd = s_core = card1 = None
            try:
                if path == "auto":
                    s_httpd, s_core, s_port = start_local(args)
                elif path == "network" and device.type == "cuda":
                    if torch.cuda.device_count() < 2:
                        raise RuntimeError(
                            "the network rung needs a second card: NCCL "
                            "holds one rank a card")
                    card1, s_port = start_child(
                        args, env={"CUDA_VISIBLE_DEVICES": "1"})
                else:
                    if child is None:
                        child, c_port = start_child(args)
                    s_port = c_port
                if path == "network":
                    pipe = d_httpd.engine._get_device_pipe()
                    if pipe is None:
                        raise RuntimeError("the network rung: the KV device "
                                           "pipe is unavailable here")
                    pipe.host = "another-host"
                bodies, conts = _pull_and_continue(
                    d_port, s_port, "device" if path == "network" else path,
                    prompts(prompt_tokens, d_core.model_config.vocab_size),
                    continue_tokens)
                hits = d_core.stats()["prefix_cache_hits"]
            finally:
                stop_local(d_httpd, d_core)
                if s_httpd is not None:
                    stop_local(s_httpd, s_core)
                if card1 is not None:
                    _stop_child(card1)
            results[path] = _result(device, model, prompt_tokens, path,
                                    bodies, conts, hits)
    finally:
        if child is not None:
            _stop_child(child)
    return results


def _stop_child(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()


def run(model: str = MODEL, prompt_tokens: int = PROMPT_TOKENS,
        path: str = "auto", device="cuda", dtype=None,
        continue_tokens: int = 8, block_size: int = 64) -> dict:
    """One rung (:func:`run_paths`)."""
    return run_paths(model, prompt_tokens, (path,), device, dtype,
                     continue_tokens, block_size)[path]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--prompt-tokens", type=int, default=PROMPT_TOKENS)
    ap.add_argument("--path", default="auto",
                    choices=("auto", "device", "network", "host"))
    args = ap.parse_args(argv)
    out = run(args.model, args.prompt_tokens, args.path, args.device,
              args.dtype)
    common.emit(out)
    return out


if __name__ == "__main__":
    main()
