"""The port's multi-process bring-up (``parallel/multihost.py``) against
the JAX package's: the same environment contract, the op channel's
token check, a lost follower, and tensor parallelism started through
the server entry.

- ``distributed_env`` gives the JAX function's answers and errors for
  the same environment;
- a follower with a wrong ``TPU_STACK_OP_TOKEN`` is refused at the
  handshake (and a right one then joins);
- a follower that dies makes the leader fail its requests with "error"
  within a time limit (the engine latches the fault, never hangs);
- ``--tensor-parallel-size 2`` on the server entry with no ``TPU_STACK_*``
  environment starts rank 1 on this host (``python -m ...engine.server``,
  gloo on the CPU), serves the tp 1 server's greedy text, answers 501 for
  what tensor parallelism refuses, and ends the job with the server.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from production_stack_tpu.parallel import multihost as jax_multihost
from production_stack_tpu_torch.parallel import multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENVS = [
    {},
    {"TPU_STACK_NUM_PROCESSES": "1"},
    {"TPU_STACK_NUM_PROCESSES": "4",
     "TPU_STACK_COORDINATOR": "engine-0.engines:8476",
     "TPU_STACK_PROCESS_ID": "2"},
    {"TPU_STACK_NUM_PROCESSES": "2",
     "TPU_STACK_COORDINATOR": "10.0.0.5:9000", "TPU_STACK_PROCESS_ID": "1",
     "TPU_STACK_OP_PORT": "9100"},
    {"TPU_STACK_NUM_PROCESSES": "4",
     "TPU_STACK_COORDINATOR": "engine-0.engines:8476"},  # hostname ordinal
    {"TPU_STACK_NUM_PROCESSES": "3"},  # no coordinator: an error
]


@pytest.mark.parametrize("env", _ENVS)
@pytest.mark.parametrize("hostname", ["engine-3", "engine"])
def test_distributed_env_matches_jax(monkeypatch, env, hostname):
    for key in list(os.environ):
        if key.startswith("TPU_STACK_") and key != "TPU_STACK_LOG_LEVEL":
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(socket, "gethostname", lambda: hostname)

    def answer(fn):
        try:
            return ("ok", fn())
        except ValueError as e:
            return ("ValueError", str(e))

    assert answer(multihost.distributed_env) == answer(
        jax_multihost.distributed_env)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_op_channel_refuses_a_wrong_token():
    port = _free_port()
    env = {"coordinator": f"127.0.0.1:{port - 1}", "num_processes": 2,
           "op_port": port}
    leader = {}

    def lead():
        leader["ch"] = multihost.OpChannel(
            dict(env, process_id=0), {"TPU_STACK_OP_TOKEN": "right"})

    th = threading.Thread(target=lead, daemon=True)
    th.start()
    with pytest.raises(ConnectionError, match="rejected"):
        multihost.OpChannel(dict(env, process_id=1),
                            {"TPU_STACK_OP_TOKEN": "wrong"})
    follower = multihost.OpChannel(dict(env, process_id=1),
                                   {"TPU_STACK_OP_TOKEN": "right"})
    th.join(timeout=30)
    assert not th.is_alive()
    leader["ch"].send(("decode", {"K": 2}, [[1, 2, 3]]))
    assert follower.recv() == ("decode", {"K": 2}, [[1, 2, 3]])
    with pytest.raises(ValueError, match="TPU_STACK_OP_TOKEN"):
        multihost.OpChannel(dict(env, process_id=1), {})
    leader["ch"].close()
    follower.close()


# Rank 1 replays three ops and dies; the leader's request must end with
# "error" (the engine latched the lost rank) well inside the limit.
_DYING = r"""
import json, os, sys, threading, time
import torch
torch.set_num_threads(1)
from production_stack_tpu_torch.parallel import multihost
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams

env = multihost.initialize_from_env()
ctx = multihost.maybe_context()
core = EngineCore(EngineConfig(
    model="tiny-llama", device="cpu", dtype="float32", max_model_len=256,
    max_num_seqs=2, block_size=8, num_blocks=64, max_loras=0,
    decode_steps=2, tensor_parallel_size=2), multihost=ctx)
if env["process_id"] == 1:
    ops = []
    replay = core._exec_op

    def dying(*args):
        ops.append(args[0])
        if len(ops) > 3:
            os._exit(3)
        return replay(*args)

    core._exec_op = dying
    core.run_follower()
    sys.exit(0)
core.start()
done = threading.Event()
got = []

def cb(t, f):
    got.append(f if f is not None else int(t))
    if f is not None:
        done.set()

t0 = time.monotonic()
core.add_request("r0", list(range(1, 30)),
                 SamplingParams(temperature=0.0, max_tokens=200,
                                ignore_eos=True), cb)
finished = done.wait(60)
late = []
core.add_request("r1", [1, 2, 3], SamplingParams(max_tokens=4),
                 lambda t, f: late.append(f))
print("RESULT " + json.dumps({
    "finished": finished, "finish": got[-1] if got else None,
    "tokens": len(got) - 1, "seconds": time.monotonic() - t0,
    "fatal": core.fatal_error, "late": late}), flush=True)
core.stop()
os._exit(0)
"""


def test_a_follower_that_dies_fails_the_leaders_requests():
    port = multihost._free_port_pair()
    procs = []
    for rank in range(2):
        env = dict(os.environ, TPU_STACK_COORDINATOR=f"127.0.0.1:{port}",
                   TPU_STACK_NUM_PROCESSES="2",
                   TPU_STACK_PROCESS_ID=str(rank),
                   TPU_STACK_OP_TOKEN="test-op-token", PYTHONPATH=REPO,
                   TPU_STACK_LOG_LEVEL="WARNING")
        env.pop("TPU_STACK_OP_PORT", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DYING], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 3, outs[1][-3000:]
    line = next((ln for ln in outs[0].splitlines()
                 if ln.startswith("RESULT ")), None)
    assert line is not None, outs[0][-3000:]
    res = json.loads(line[7:])
    assert res["finished"] and res["finish"] == "error", res
    assert res["tokens"] < 200
    assert res["seconds"] < 60
    # The watcher's lost rank, or the step whose collective failed first.
    assert res["fatal"], res
    assert res["late"] == ["error"]  # a request after the fault fails


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_entry_starts_and_ends_the_ranks():
    from production_stack_tpu_torch.engine.server import build_server

    argv = ["tiny-llama", "--device", "cpu", "--dtype", "float32",
            "--host", "127.0.0.1", "--port", "0", "--max-model-len", "256",
            "--block-size", "8", "--num-blocks", "64", "--max-loras", "0"]
    body = {"prompt": "tensor parallel ranks", "max_tokens": 8,
            "temperature": 0.0}
    texts = {}
    for tp in (1, 2):
        httpd, core = build_server(argv + ["--tensor-parallel-size",
                                           str(tp)])
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        port = httpd.server_address[1]
        try:
            status, out = _post(port, "/v1/completions", body)
            assert status == 200, out
            texts[tp] = out["choices"][0]["text"]
            if tp == 2:
                procs = httpd.ranks[1]
                assert len(procs) == 1 and procs[0].poll() is None
                stats = core.stats()["tensor_parallel"]
                assert stats["size"] == 2 and stats["backend"] == "gloo"
                for path in ("/sleep", "/kv/extract", "/kv/pull"):
                    status, out = _post(port, path, {
                        "prompt": "x", "source_url": "http://127.0.0.1:9"})
                    assert status == 501, (path, out)
                    assert ("tensor or pipeline parallelism"
                            in out["error"]["message"])
        finally:
            httpd.shutdown()
            httpd.server_close()
            core.stop()
            th.join(timeout=10)
        if tp == 2:
            assert procs[0].wait(timeout=30) == 0
            assert "TPU_STACK_NUM_PROCESSES" not in os.environ
            assert not torch.distributed.is_initialized()
    assert texts[2] == texts[1]
