"""The KV device pipe (``kv/device_pipe.py``) and its server rungs,
against the JAX server's answers (``tests/test_kv_device_pipe.py``).

On this host the pipe shares CPU storages through shared memory, as it
shares card memory through CUDA IPC handles on a card, so the
two-process protocol runs here:

- an offer made in one process is pulled, whole and bit for bit, in
  another; a release frees the offer's slot;
- ``/kv/prepare_pull`` answers 404 without a cached prefix, 501 without
  a pipe and 503 past ``MAX_PENDING_OFFERS`` offers; a puller that names
  another host, or none, gets an offer with a ``transfer_port`` and no
  IPC handles, and its ``/kv/pull`` takes the pipe's network transport
  (``tests/test_torch_kv_net.py`` holds that transport to the rest);
- ``kv_path`` negotiation: ``"device"`` answers 501 when the pipe is
  unavailable; ``"auto"`` from a source without a pipe (the JAX server)
  falls to the relay; ``"device"`` between port servers moves the pages
  through the pipe, releases the sender's slot, and the puller then
  serves the sender's own prefix-hit stream; the answer's ``path`` names
  the rung;
- the same pull between two server processes;
- the availability probe survives an offerer that aborts.

The IPC path on a card runs in ``chip_smoke.py`` and in the ``cuda``
test below, which skips without a card. The servers' tests import the
JAX server's harness (``tests/test_torch_disagg.py``) when they run, so
the ``cuda`` test collects on a card's host, which has no JAX.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from production_stack_tpu_torch.engine.server import build_server
from production_stack_tpu_torch.kv import device_pipe as dp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A process that pulls the offer described on stdin and prints each
# tensor's bytes (hex), dtype, shape and device.
_PULLER = r"""
import json, sys
import torch
from production_stack_tpu_torch.kv.device_pipe import KVDevicePipe
a = json.loads(sys.stdin.read())
got = KVDevicePipe().pull(a["address"], a["uuid"], a["handles"])
print(json.dumps([[t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                   .tobytes().hex(), str(t.dtype), list(t.shape),
                   str(t.device)] for t in got]))
"""


def _env(**over):
    return dict(os.environ, PYTHONPATH=REPO, TPU_STACK_LOG_LEVEL="WARNING",
                **over)


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def test_offer_and_pull_between_two_processes():
    pipe = dp.KVDevicePipe()
    g = torch.Generator().manual_seed(0)
    tensors = [torch.randn((2, 3, 4, 2, 8), generator=g).to(torch.bfloat16),
               torch.randint(-127, 128, (2, 3, 4, 2, 8), dtype=torch.int8,
                             generator=g),
               torch.rand((2, 3, 8), generator=g)]
    uuid = pipe.offer(tensors)
    assert pipe.pending() == 1
    proc = subprocess.run(
        [sys.executable, "-c", _PULLER], env=_env(), cwd=REPO, text=True,
        capture_output=True, timeout=120,
        input=json.dumps({"address": pipe.address(), "uuid": uuid,
                          "handles": pipe.handles(uuid)}))
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for t, (hexed, dtype, shape, _) in zip(tensors, got):
        assert bytes.fromhex(hexed) == _bytes(t)
        assert dtype == str(t.dtype) and shape == list(t.shape)
    pipe.release(uuid)
    assert pipe.pending() == 0 and pipe.handles(uuid) is None
    with pytest.raises(RuntimeError, match="another host"):
        pipe.pull("elsewhere-0/1", uuid, [])


def _disagg():
    """``tests/test_torch_disagg.py``: the servers and their HTTP helpers
    (imported when a test needs them; they import JAX)."""
    import test_torch_disagg

    return test_torch_disagg


@pytest.fixture(scope="module")
def srv():
    s = _disagg().Servers()
    yield s
    s.stop()


def _reset_pipes(*engines):
    for eng in engines:
        if eng._device_pipe is not None:
            eng._device_pipe.close()
        eng._device_pipe, eng._device_pipe_failed = None, False


BS = 8  # the servers' block size (tests/test_torch_n_sampling.py's CFG)


def _ids(start):
    return list(range(start, start + 5 * BS + 1))  # 5 full blocks + 1


def _post(*args, **kw):
    return _disagg()._post(*args, **kw)


def _pull(*args, **kw):
    return _disagg()._pull(*args, **kw)


def _complete(*args, **kw):
    return _disagg()._complete(*args, **kw)


def test_prepare_pull_answers(srv, monkeypatch):
    p_eng = srv.httpd.engine
    _reset_pipes(p_eng)
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "0")
    _post(srv.port, "/kv/prepare_pull", {"prompt": _ids(10)}, expect=501)
    _reset_pipes(p_eng)
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "1")
    here = dp.host_key()
    _post(srv.port, "/kv/prepare_pull",
          {"prompt": _ids(1000), "host_key": here}, expect=404)
    ids = _ids(1100)
    _complete(srv.port, ids, max_tokens=1)
    uuids = []
    for _ in range(p_eng._device_pipe.MAX_PENDING_OFFERS):
        raw, _ = _post(srv.port, "/kv/prepare_pull",
                       {"token_ids": ids, "host_key": here})
        offer = json.loads(raw)
        assert offer["hashes"] and offer["num_tokens"] == 5 * BS
        assert offer["bytes"] > 0 and len(offer["handles"]) == 2
        uuids.append(offer["uuid"])
    raw, _ = _post(srv.port, "/kv/prepare_pull",
                   {"token_ids": ids, "host_key": here}, expect=503)
    assert "capacity" in json.loads(raw)["error"]
    for u in uuids:
        raw, _ = _post(srv.port, "/kv/release", {"uuid": u})
        assert json.loads(raw) == {"status": "ok"}
    assert p_eng._device_pipe.pending() == 0
    _post(srv.port, "/kv/prepare_pull",  # a slot again
          {"token_ids": ids, "host_key": here})
    _reset_pipes(p_eng)


def test_puller_on_another_host_takes_the_relay(srv, monkeypatch):
    """A puller that names another host, or none, gets an offer with the
    pipe's ``transfer_port``, its token and leaves, and no IPC handles;
    its ``"auto"`` pull takes the network transport (the relay no
    longer), over one cached pair, and frees the sender's slot each
    time."""
    p_eng, d_eng = srv.httpd.engine, srv.d_httpd.engine
    _reset_pipes(p_eng, d_eng)
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "1")
    ids = _ids(1400)
    _complete(srv.port, ids, max_tokens=1)
    for body in ({"token_ids": ids},
                 {"token_ids": ids, "host_key": "elsewhere-0"}):
        raw, _ = _post(srv.port, "/kv/prepare_pull", body)
        offer = json.loads(raw)
        assert "handles" not in offer and offer["token"]
        assert offer["transfer_port"] == p_eng._device_pipe.transfer_port
        assert [leaf["dtype"] for leaf in offer["leaves"]] == ["float32"] * 2
        _post(srv.port, "/kv/release", {"uuid": offer["uuid"]})
    assert p_eng._device_pipe.pending() == 0
    # The two servers share this process: take the local-device rung out
    # of the way, as between two hosts.
    monkeypatch.setattr(d_eng, "_resolve_local_peer", lambda source: None)
    d_eng._get_device_pipe().host = "elsewhere-0"
    for i in range(d_eng._device_pipe.MAX_PENDING_OFFERS + 1):
        out, _ = _pull(srv.d, srv.port, ids, "auto")
        assert out["transfer"]["path"] == "device"
        assert out["transfer"]["transport"] == "network"
        assert out["transfer"]["backend"] == "gloo"
        assert (out["transfer"]["rendezvous_seconds"] > 0) == (i == 0)
        assert p_eng._device_pipe.pending() == 0
    cached = srv.d_core.cached_tokens_total
    assert _complete(srv.d, ids) == _complete(srv.port, ids)
    assert srv.d_core.cached_tokens_total - cached == 5 * BS
    _reset_pipes(p_eng, d_eng)


@pytest.mark.parametrize("case", ["device-unavailable", "auto-from-jax",
                                  "device"])
def test_kv_path_negotiation(srv, monkeypatch, case):
    p_eng, d_eng = srv.httpd.engine, srv.d_httpd.engine
    _reset_pipes(p_eng, d_eng)
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE",
                       "0" if case == "device-unavailable" else "1")
    if case == "device-unavailable":
        out, _ = _pull(srv.d, srv.port, _ids(10), "device", expect=501)
        assert "unavailable" in out["error"]
        return
    if case == "auto-from-jax":
        # The JAX server has no pipe on this host: its /kv/prepare_pull
        # answers 501, and the pull takes the relay.
        monkeypatch.setattr(srv.jax, "_device_pipe_failed", True)
        ids = _ids(1200)
        _complete(srv.ref, ids, max_tokens=1)
        out, _ = _pull(srv.d, srv.ref, ids, "auto")
        assert out["transfer"]["path"] == "host"
        assert out["injected_blocks"] == 5
        assert _complete(srv.d, ids) == _complete(srv.ref, ids)
        return
    ids = _ids(1300)
    _complete(srv.port, ids, max_tokens=1)
    metrics = urllib.request.urlopen(srv.d + "/metrics").read().decode()
    before = _series(metrics, "tpu:kv_transfer_device_pulls_total")
    out, _ = _pull(srv.d, srv.port, ids, "device")
    assert out["status"] == "ok" and out["injected_blocks"] == 5
    assert out["num_tokens"] == 5 * BS
    assert out["transfer"]["path"] == "device"
    assert out["transfer"]["bytes"] > 0
    assert p_eng._device_pipe.pending() == 0  # released before the inject
    metrics = urllib.request.urlopen(srv.d + "/metrics").read().decode()
    assert _series(metrics, "tpu:kv_transfer_device_pulls_total") == (
        before + 1)
    cached = srv.d_core.cached_tokens_total
    assert _complete(srv.d, ids) == _complete(srv.port, ids)
    assert srv.d_core.cached_tokens_total - cached == 5 * BS
    _reset_pipes(p_eng, d_eng)


def _series(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pull_between_two_server_processes(monkeypatch):
    """A port server process as the source, a server of this process on
    the same seeded weights pulling over ``kv_path: "device"``."""
    argv = ["tiny-llama", "--device", "cpu", "--dtype", "float32",
            "--host", "127.0.0.1", "--max-model-len", "256",
            "--block-size", "8", "--num-blocks", "64", "--max-loras", "0",
            "--no-warmup"]
    port = _free_port()
    child = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server"]
        + argv + ["--port", str(port)], cwd=REPO,
        env=_env(TPU_STACK_KV_DEVICE_PIPE="1"), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "1")
    httpd, core = build_server(argv + ["--port", "0"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    source = f"http://127.0.0.1:{port}"
    mine = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(source + "/health", timeout=5)
                break
            except OSError:
                assert child.poll() is None, child.stderr.read()[-2000:]
                assert time.monotonic() < deadline
                time.sleep(0.2)
        ids = _ids(2000)
        _complete(source, ids, max_tokens=1)
        out, _ = _pull(mine, source, ids, "device")
        assert out["transfer"]["path"] == "device"
        assert out["injected_blocks"] == 5
        assert _complete(mine, ids) == _complete(source, ids)
        # The source's offer slot went back: another eight pulls' worth.
        body = {"token_ids": ids, "host_key": dp.host_key()}
        for _ in range(dp.KVDevicePipe.MAX_PENDING_OFFERS):
            _post(source, "/kv/prepare_pull", body)
        _post(source, "/kv/prepare_pull", body, expect=503)
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
        th.join(timeout=10)
        child.terminate()
        child.wait(timeout=30)


def test_probe_is_crash_safe(monkeypatch):
    monkeypatch.delenv("TPU_STACK_KV_DEVICE_PIPE", raising=False)
    monkeypatch.setattr(dp, "_probe_result", None)
    # An offerer that aborts: the probe reports unavailable, and this
    # process lives on.
    monkeypatch.setattr(dp, "_PROBE_OFFER", "import os; os.abort()")
    assert dp.device_pipe_available(timeout=60.0) is False
    assert dp.device_pipe_available() is False  # cached: no new process
    monkeypatch.undo()
    monkeypatch.delenv("TPU_STACK_KV_DEVICE_PIPE", raising=False)
    monkeypatch.setattr(dp, "_probe_result", None)
    assert dp.device_pipe_available(timeout=120.0) is True  # shared memory
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "0")
    assert dp.device_pipe_available() is False


@pytest.mark.cuda
def test_cuda_ipc_offer_and_pull():
    """Card pages offered here are pulled bit for bit by another process
    through their CUDA IPC handles."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    pipe = dp.KVDevicePipe()
    g = torch.Generator(device="cuda").manual_seed(0)
    tensors = [torch.randn((4, 8, 64, 8, 128), generator=g,
                           device="cuda").to(torch.bfloat16),
               torch.rand((4, 8, 512), generator=g, device="cuda")]
    uuid = pipe.offer(tensors)
    proc = subprocess.run(
        [sys.executable, "-c", _PULLER], env=_env(), cwd=REPO, text=True,
        capture_output=True, timeout=300,
        input=json.dumps({"address": pipe.address(), "uuid": uuid,
                          "handles": pipe.handles(uuid)}))
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for t, (hexed, _, _, device) in zip(tensors, got):
        assert bytes.fromhex(hexed) == _bytes(t.cpu())
        assert device == "cuda:0"  # opened on the card the handle names
    pipe.release(uuid)
