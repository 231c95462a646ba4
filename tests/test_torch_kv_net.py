"""The KV device pipe's network transport (``kv/device_pipe.py``): the
pages of an offer cross between processes, or hosts, over a two-rank
communicator of the two pipes (gloo here, NCCL between cards), as the JAX
pipe's ``jax.experimental.transfer`` pulls them over the network.

- an offer of bf16 leaves, and one of int8 data with f32 scales, made in
  this process and pulled in another, bit for bit;
- a second pull reuses the cached pair: no second rendezvous;
- two pullers at once each get their own pages;
- an offerer killed mid-transfer fails the pull within the pipe's
  timeout: the puller's ``"auto"`` pull then takes the relay, its
  ``"device"`` pull answers 501, and it goes on serving;
- between two port servers whose pipes name different hosts, ``/kv/pull``
  with ``"device"`` injects the blocks over the network transport, and
  the decode server's greedy continuation equals the JAX engine's on the
  same weights (``tests/test_torch_disagg.py``'s servers).

One pair of servers and one pair of pipes (this process's offerer and a
puller process) serve the module. Each test bounds its own time.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from production_stack_tpu_torch.kv import device_pipe as dp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A puller process: one network pull a line of stdin ({"address", "uuid",
# "leaves", "token"}), answered by a line of each leaf's bytes (hex),
# dtype and shape, and the pull's stats, or by the pull's error.
_PULLER = r"""
import json, sys
import torch
from production_stack_tpu_torch.kv.device_pipe import KVDevicePipe
pipe = KVDevicePipe(timeout=20.0)
pipe.host = "elsewhere-0"
print("READY", flush=True)
for line in sys.stdin:
    a = json.loads(line)
    stats = {}
    try:
        got = pipe.pull(a["address"], a["uuid"], a["leaves"], stats=stats,
                        token=a["token"])
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        continue
    print(json.dumps({"leaves": [
        [t.contiguous().view(-1).view(torch.uint8).numpy().tobytes().hex(),
         str(t.dtype), list(t.shape)] for t in got], "stats": stats}),
        flush=True)
"""

# An offerer that dies mid-transfer: it offers zeros of the leaves on
# stdin, prints the offer, and exits (code 3) once its first leaf is sent.
_DYING_OFFERER = r"""
import json, os, sys, time
import torch
from production_stack_tpu_torch.kv import device_pipe as dp

def send_one_then_die(pair, tensors, stream, deadline):
    dp._settle([pair.group.send([tensors[0]], 1, 0)], deadline, True)
    os._exit(3)

dp.KVDevicePipe._send = staticmethod(send_one_then_die)
leaves = json.loads(sys.stdin.readline())
pipe = dp.KVDevicePipe()
ts = [torch.zeros(s["shape"], dtype=dp._DTYPES[s["dtype"]]) for s in leaves]
uuid = pipe.offer(ts, ipc=False)
print(json.dumps({"port": pipe.transfer_port, "uuid": uuid,
                  "token": pipe.token(uuid)}), flush=True)
time.sleep(120)
"""


@contextlib.contextmanager
def within(seconds):
    """Fail the test if its body takes longer than ``seconds``."""
    def expire(*_):
        raise TimeoutError(f"over the test's {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _env():
    return dict(os.environ, PYTHONPATH=REPO, TPU_STACK_LOG_LEVEL="WARNING")


def _spawn(script):
    return subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                            env=_env(), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=30)


class Puller:
    """A puller process of its own: its pipe names another host."""

    def __init__(self):
        self.proc = _spawn(_PULLER)
        line = self.proc.stdout.readline()
        assert line.strip() == "READY", self.proc.stderr.read()[-2000:]

    def ask(self, offerer, uuid, tensors, token=None):
        self.proc.stdin.write(json.dumps({
            "address": f"127.0.0.1:{offerer.transfer_port}", "uuid": uuid,
            "leaves": dp.leaf_specs(tensors),
            "token": token or offerer.token(uuid)}) + "\n")
        self.proc.stdin.flush()

    def answer(self):
        line = self.proc.stdout.readline()
        assert line, self.proc.stderr.read()[-2000:]
        return json.loads(line)

    def pull(self, offerer, uuid, tensors, token=None):
        self.ask(offerer, uuid, tensors, token)
        return self.answer()


@pytest.fixture(scope="module")
def pipes():
    """This process's offerer and a puller process."""
    offerer = dp.KVDevicePipe()
    puller = Puller()
    yield offerer, puller
    _stop(puller.proc)
    offerer.close()


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _leaves(kind, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "bf16":
        return [torch.randn((2, 3, 8, 2, 16), generator=g).to(torch.bfloat16)
                for _ in range(2)]
    data = [torch.randint(-127, 128, (2, 3, 8, 2, 16), dtype=torch.int8,
                          generator=g) for _ in range(2)]
    scales = [torch.rand((2, 3, 8, 2), generator=g) for _ in range(2)]
    return [data[0], scales[0], data[1], scales[1]]  # k, k scale, v, v s.


def _same(tensors, got):
    assert len(got["leaves"]) == len(tensors)
    for t, (hexed, dtype, shape) in zip(tensors, got["leaves"]):
        assert bytes.fromhex(hexed) == _bytes(t)
        assert dtype == str(t.dtype) and shape == list(t.shape)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_offer_crosses_bit_for_bit(pipes, kind):
    with within(60):
        offerer, puller = pipes
        tensors = _leaves(kind, 1 if kind == "bf16" else 2)
        uuid = offerer.offer(tensors, ipc=False)
        assert offerer.handles(uuid) is None  # no IPC handle was made
        got = puller.pull(offerer, uuid, tensors)
        _same(tensors, got)
        assert got["stats"]["transport"] == "network"
        assert got["stats"]["backend"] == "gloo"
        offerer.release(uuid)
        assert offerer.pending() == 0


def test_second_pull_reuses_the_pair(pipes):
    with within(30):
        offerer, puller = pipes
        tensors = _leaves("bf16", 3)
        uuid = offerer.offer(tensors, ipc=False)
        pulls = [puller.pull(offerer, uuid, tensors) for _ in range(2)]
        _same(tensors, pulls[1])
        # The pair the first pull made (or found) served the second.
        assert pulls[1]["stats"]["rendezvous_seconds"] == 0.0
        assert len(offerer._served) == 1
        # A pull that names the offer with the wrong token is refused
        # before anything is sent, and the pair stays good.
        bad = puller.pull(offerer, uuid, tensors, token="0" * 32)
        assert "wrong token" in bad["error"]
        again = puller.pull(offerer, uuid, tensors)
        _same(tensors, again)
        assert again["stats"]["rendezvous_seconds"] == 0.0
        assert len(offerer._served) == 1
        offerer.release(uuid)
        assert "no such offer" in puller.pull(offerer, uuid,
                                              tensors)["error"]


def test_two_pullers_at_once_get_their_own_pages(pipes):
    with within(60):
        offerer, puller = pipes
        other = Puller()
        try:
            a, b = _leaves("bf16", 4), _leaves("int8", 5)
            ua, ub = (offerer.offer(t, ipc=False) for t in (a, b))
            puller.ask(offerer, ua, a)
            other.ask(offerer, ub, b)
            got_b, got_a = other.answer(), puller.answer()
            _same(a, got_a)
            _same(b, got_b)
            assert got_b["stats"]["rendezvous_seconds"] > 0  # its own pair
            offerer.release(ua)
            offerer.release(ub)
        finally:
            _stop(other.proc)


@pytest.fixture(scope="module")
def srv():
    """``tests/test_torch_disagg.py``'s servers (the JAX server, port
    servers P and D on its weights), imported here: they import JAX."""
    import test_torch_disagg

    s = test_torch_disagg.Servers()
    yield s, test_torch_disagg
    s.stop()


def _fresh_pipes(monkeypatch, *engines):
    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "1")
    for eng in engines:
        if eng._device_pipe is not None:
            eng._device_pipe.close()
        eng._device_pipe, eng._device_pipe_failed = None, False


def test_device_pull_between_hosts_matches_the_jax_engine(srv, monkeypatch):
    with within(60):
        s, h = srv
        p_eng, d_eng = s.httpd.engine, s.d_httpd.engine
        _fresh_pipes(monkeypatch, p_eng, d_eng)
        monkeypatch.setattr(d_eng, "_resolve_local_peer", lambda src: None)
        d_eng._get_device_pipe().host = "elsewhere-0"
        ids = h._ids(2100)
        h._complete(s.port, ids, max_tokens=1)  # P prefills
        cached = s.d_core.cached_tokens_total
        out, _ = h._pull(s.d, s.port, ids, "device")
        assert out["status"] == "ok" and out["injected_blocks"] == 5
        assert out["transfer"]["path"] == "device"
        assert out["transfer"]["transport"] == "network"
        assert out["transfer"]["rendezvous_seconds"] > 0
        assert p_eng._device_pipe.pending() == 0
        got = h._complete(s.d, ids)
        assert s.d_core.cached_tokens_total - cached == 5 * h.BS
        assert got == h._complete(s.ref, ids)  # the JAX engine's stream
        _fresh_pipes(monkeypatch, p_eng, d_eng)


def test_killed_offerer_fails_over_to_the_relay(srv, monkeypatch):
    with within(60):
        s, h = srv
        p_eng, d_eng = s.httpd.engine, s.d_httpd.engine
        _fresh_pipes(monkeypatch, p_eng, d_eng)
        monkeypatch.setattr(d_eng, "_resolve_local_peer", lambda src: None)
        d_pipe = d_eng._get_device_pipe()
        d_pipe.host, d_pipe.timeout = "elsewhere-0", 10.0
        ids = h._ids(2200)
        h._complete(s.port, ids, max_tokens=1)
        status, real = p_eng.kv_prepare_pull({"token_ids": ids})
        assert status == 200
        p_eng.kv_release({"uuid": real["uuid"]})
        # P's offers now name an offerer process that dies after its
        # first leaf.
        dying = _spawn(_DYING_OFFERER)
        try:
            dying.stdin.write(json.dumps(real["leaves"]) + "\n")
            dying.stdin.flush()
            fake = json.loads(dying.stdout.readline())
            prepare = p_eng.kv_prepare_pull

            def answer(body):
                status, out = prepare(body)
                p_eng.kv_release({"uuid": out["uuid"]})
                return status, dict(out, uuid=fake["uuid"],
                                    token=fake["token"],
                                    transfer_port=fake["port"])

            monkeypatch.setattr(p_eng, "kv_prepare_pull", answer)
            t0 = time.monotonic()
            out, _ = h._pull(s.d, s.port, ids, "auto")
            assert time.monotonic() - t0 < d_pipe.timeout
            assert dying.wait(timeout=30) == 3  # died mid-transfer
            assert out["transfer"]["path"] == "host"
            assert out["injected_blocks"] == 5
            d_pipe.timeout = 2.0  # the dead port refuses: no wait needed
            out, _ = h._pull(s.d, s.port, ids, "device", expect=501)
            assert "unavailable" in out["error"]
        finally:
            _stop(dying)
        assert h._complete(s.d, ids) == h._complete(s.port, ids)
        _fresh_pipes(monkeypatch, p_eng, d_eng)


def test_transfer_probe_crosses_hosts_over_gloo():
    """``probes/transfer_repro.py``'s cross_host leg: two pulls between
    two processes over the network transport, bit for bit, the first
    paying the rendezvous."""
    from production_stack_tpu_torch.probes import transfer_repro

    with within(60):
        out = transfer_repro.cross_host("gloo")
        assert out["ok"], out
        pulls = out["pull"]["pulled"]["pulls"]
        assert [p["equal"] for p in pulls] == [True, True]
        assert {p["backend"] for p in pulls} == {"gloo"}
        assert pulls[0]["rendezvous_seconds"] > 0
        assert pulls[1]["rendezvous_seconds"] == 0.0
        assert "token" not in out["offer"]["offered"]


def test_handoff_bench_network_rung(monkeypatch):
    """``probes/kv_handoff_bench.py``'s network rung on the CPU: the
    device rung over the network transport, whose decode engine then
    continues with the stream of an engine that had no handoff."""
    from production_stack_tpu_torch.probes import kv_handoff_bench as kvb

    monkeypatch.setenv("TPU_STACK_KV_DEVICE_PIPE", "1")
    with within(90):
        out = kvb.run("tiny-llama", 64, "network", "cpu", "float32",
                      continue_tokens=4, block_size=16)
        assert out["path_requested"] == "network"
        assert out["path"] == "device" and out["transport"] == "network"
        assert out["backend"] == "gloo" and out["injected_blocks"] == 4
        assert out["rendezvous_seconds"] > 0 and out["transfer_ms"] > 0
        assert out["link_bound_ms"] is None  # loopback: no published rate
        args = kvb.server_args("tiny-llama", "cpu", 64, "float32", 16)
        httpd, core, port = kvb.start_local(args)
        try:
            fresh = [kvb.post(port, "/v1/completions", {
                "prompt": tokens, "max_tokens": 4, "temperature": 0.0,
                "ignore_eos": True})[1]["choices"][0]["text"]
                for tokens in kvb.prompts(64, core.model_config.vocab_size)]
        finally:
            kvb.stop_local(httpd, core)
        assert out["continuations"] == fresh
