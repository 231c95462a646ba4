"""Multi-process serving bring-up: ``torch.distributed`` + the lockstep op
channel.

The port's own copy of ``production_stack_tpu/parallel/multihost.py``,
with ``torch.distributed`` in place of ``jax.distributed``. A sharded
engine (tensor or pipeline parallelism, data-parallel replicas) runs as
one process a rank, ``dp x pp x tp`` of them (:func:`job_dp`), on one
host or spread over hosts, and both take this path:

- every process joins one ``torch.distributed`` job
  (:func:`initialize_from_env`, a gloo group over TCP; the engine adds an
  NCCL group for its collectives where every rank has a card of its own);
- process 0, the leader, owns the scheduler, the KV block accounting and
  the HTTP surface; the followers replay every device op the leader
  issues, from its host arguments, through the same
  ``EngineCore._exec_op`` chokepoint, so every rank launches the same
  kernels and collectives in the same order;
- the leader serializes each op's host-side arguments (a few KB of numpy
  a step) over a TCP side channel (:class:`OpChannel`), authenticated by
  a shared token. Device state (weights, KV pages, penalty counts, the
  in-flight burst's feedback tokens) never crosses the wire: each rank
  holds its own slice of the same weights and its own KV heads (of its
  own pipeline stage's layers).

Why TCP and not a broadcast collective: a collective would put extra
device work on every engine step and entangle control ordering with
compute ordering. A socket write is microseconds and keeps the op stream
host-side.

Readiness: ``init_process_group`` blocks until every process joins, and
the leader's channel bind blocks until every follower connects, so by
the time the leader can serve the job is complete. A follower whose
connection drops (it died) is reported to the leader's ``on_lost``
callback by a watcher thread; the engine then fails its requests.

The environment contract is the JAX package's: ``TPU_STACK_COORDINATOR``,
``TPU_STACK_NUM_PROCESSES``, ``TPU_STACK_PROCESS_ID`` (or the trailing
ordinal of the hostname), ``TPU_STACK_OP_PORT`` and
``TPU_STACK_OP_TOKEN``, so the multi-host StatefulSet starts the port as
it starts the JAX engine. :func:`spawn_local_ranks` sets the same
variables for ranks started as processes of one host.
"""

from __future__ import annotations

import datetime
import hmac
import os
import pickle
import secrets
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Callable, List, Optional

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# Port offset of the op channel relative to the coordinator port
# (overridable: TPU_STACK_OP_PORT).
_OP_PORT_OFFSET = 1

# How long a collective (and the job's first rendezvous) waits for a
# slow rank before failing: ranks that share a card load their weights
# one after the other.
COLLECTIVE_TIMEOUT_S = 600.0


def distributed_env(environ=None) -> Optional[dict]:
    """Multi-host settings from the environment, or None when single-host.

    - ``TPU_STACK_COORDINATOR``: ``host:port`` of process 0 (in K8s, the
      pod-0 DNS name of the headless service — see
      ``helm/templates/statefulset-engine-multihost.yaml``).
    - ``TPU_STACK_NUM_PROCESSES``: total process count.
    - ``TPU_STACK_PROCESS_ID``: this process's id; when unset, derived
      from the trailing ordinal of the hostname (StatefulSet pods are
      named ``<name>-<ordinal>``).
    """
    env = os.environ if environ is None else environ
    n = int(env.get("TPU_STACK_NUM_PROCESSES", "1") or 1)
    if n <= 1:
        return None
    coord = env.get("TPU_STACK_COORDINATOR")
    if not coord:
        raise ValueError(
            "TPU_STACK_NUM_PROCESSES > 1 requires TPU_STACK_COORDINATOR "
            "(host:port of process 0)")
    pid_s = env.get("TPU_STACK_PROCESS_ID")
    if pid_s is None or pid_s == "":
        host = socket.gethostname()
        tail = host.rsplit("-", 1)[-1]
        if not tail.isdigit():
            raise ValueError(
                f"TPU_STACK_PROCESS_ID unset and hostname {host!r} has no "
                f"trailing ordinal")
        pid = int(tail)
    else:
        pid = int(pid_s)
    op_port = int(env.get("TPU_STACK_OP_PORT", "0") or 0)
    if not op_port:
        op_port = int(coord.rsplit(":", 1)[-1]) + _OP_PORT_OFFSET
    return {
        "coordinator": coord,
        "num_processes": n,
        "process_id": pid,
        "op_port": op_port,
    }


def job_dp(num_processes: int, data_parallel_size: int, pp: int,
           tp: int) -> int:
    """The data-parallel size of a job of ``num_processes`` ranks, which
    must be ``dp x pp x tp``. As in the JAX engine, an unset
    ``data_parallel_size`` (<= 1) fills the job: every process serves a
    replica. Raises ValueError when the sizes do not cover the job."""
    dp = (max(num_processes // (tp * pp), 1) if data_parallel_size <= 1
          else data_parallel_size)
    if dp * pp * tp != num_processes:
        raise ValueError(
            f"multi-host mesh tp={tp} x pp={pp} x dp={dp} covers "
            f"{dp * pp * tp} devices but the job has {num_processes}; "
            f"size the parallelism to the whole slice")
    return dp


def initialize_from_env() -> Optional[dict]:
    """Join the ``torch.distributed`` job when configured (a gloo group
    over TCP at the coordinator). Must run before the first device use.
    Returns the distributed env dict (or None)."""
    import torch.distributed as dist

    env = distributed_env()
    if env is None:
        return None
    if not dist.is_initialized():
        logger.info(
            "Joining distributed job: coordinator=%s process %d/%d",
            env["coordinator"], env["process_id"], env["num_processes"])
        dist.init_process_group(
            "gloo", init_method=f"tcp://{env['coordinator']}",
            world_size=env["num_processes"], rank=env["process_id"],
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return env


class OpChannel:
    """Ordered, one-way op stream from the leader to every follower.

    Leader: ``send(obj)`` fans a pickled frame out to all follower
    connections. Follower: ``recv()`` blocks for the next frame. Frames
    are length-prefixed; per-connection TCP FIFO plus the engine's
    single dispatch lock give a total order identical on every process.
    """

    def __init__(self, env: dict, environ=None):
        environ = os.environ if environ is None else environ
        self.num_processes = env["num_processes"]
        self.process_id = env["process_id"]
        self.is_leader = env["process_id"] == 0
        host = env["coordinator"].rsplit(":", 1)[0]
        port = env["op_port"]
        # The op stream carries user prompt token ids over a port that is
        # published on the headless Service — authentication is REQUIRED
        # in multi-host mode (the helm chart generates a per-release
        # secret; see statefulset-engine-multihost.yaml). The explicit
        # insecure flag exists for closed-network bring-up only.
        self._token = environ.get("TPU_STACK_OP_TOKEN") or ""
        if not self._token and not environ.get("TPU_STACK_OP_INSECURE"):
            raise ValueError(
                "multi-host mode requires TPU_STACK_OP_TOKEN (a shared "
                "secret set on every pod; the helm chart wires one "
                "automatically) — or set TPU_STACK_OP_INSECURE=1 to "
                "accept unauthenticated followers on a closed network")
        self._send_lock = threading.Lock()
        self._closed = False
        if self.is_leader:
            self._conns = self._accept_followers(port)
            self._sock = None
        else:
            self._sock = self._connect(host, port)
            self._conns = []

    def _token_bytes(self) -> bytes:
        """Fixed 32-byte token field (zeros when auth is disabled) — ALWAYS
        sent/read, so a token config mismatch can never desynchronize the
        frame stream into garbage pickles."""
        return self._token.encode().ljust(32, b"\0")[:32]

    # How long the leader waits for all followers to join before giving
    # up (a missing pod produces a diagnosable error, not a silent hang).
    ACCEPT_TIMEOUT_SEC = 600.0

    def _accept_followers(self, port: int) -> List[socket.socket]:
        """Accept exactly one connection per follower pid. Hardened
        against strays: the port is published on the headless Service, so
        probes/scanners may connect — a connection only claims a slot
        after a valid, non-duplicate pid handshake; anything else is
        closed and does not consume a slot or crash bring-up."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(self.num_processes)
        srv.settimeout(5.0)
        by_pid: dict = {}
        deadline = time.monotonic() + self.ACCEPT_TIMEOUT_SEC
        last_log = 0.0
        while len(by_pid) < self.num_processes - 1:
            now = time.monotonic()
            if now > deadline:
                srv.close()
                missing = sorted(set(range(1, self.num_processes))
                                 - set(by_pid))
                raise TimeoutError(
                    f"op channel: followers {missing} did not connect "
                    f"within {self.ACCEPT_TIMEOUT_SEC:.0f}s")
            if now - last_log > 30.0:
                missing = sorted(set(range(1, self.num_processes))
                                 - set(by_pid))
                logger.info("Op channel: waiting for followers %s", missing)
                last_log = now
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue
            try:
                conn.settimeout(5.0)
                # Handshake: pid (8 bytes) + token field (32 bytes, ALWAYS
                # present — zeros when auth is off), answered by a 1-byte
                # ack so a rejected follower fails immediately instead of
                # believing it connected.
                (pid,) = struct.unpack("!q", self._read_exact(conn, 8))
                got = self._read_exact(conn, 32)
                if self._token and not hmac.compare_digest(
                        got, self._token_bytes()):
                    raise ConnectionError("bad op-channel token")
            except (ConnectionError, socket.timeout, struct.error):
                conn.close()  # stray probe/scanner: no slot consumed
                continue
            if not (1 <= pid < self.num_processes):
                logger.warning(
                    "Op channel: rejecting connection with out-of-range "
                    "pid %d", pid)
                conn.close()
                continue
            if pid in by_pid:
                # A reconnect (pod restarted inside the accept window)
                # supersedes the stale socket.
                logger.warning(
                    "Op channel: follower %d reconnected, replacing the "
                    "previous connection", pid)
                try:
                    by_pid[pid].close()
                except OSError:
                    pass
            try:
                conn.sendall(b"\x01")  # handshake ack
            except OSError:
                conn.close()
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            by_pid[pid] = conn
            logger.info("Op channel: follower %d connected", pid)
        srv.close()
        return [by_pid[pid] for pid in sorted(by_pid)]

    def _connect(self, host: str, port: int,
                 timeout: float = 120.0) -> socket.socket:
        deadline = time.monotonic() + timeout
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(30.0)
                sock.sendall(struct.pack("!q", self.process_id))
                sock.sendall(self._token_bytes())
                # Wait for the leader's 1-byte handshake ack: a rejection
                # (token mismatch, bad pid) closes the socket, which must
                # fail HERE, loudly.
                ack = sock.recv(1)
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.25)
                continue
            if ack != b"\x01":
                sock.close()
                raise ConnectionError(
                    "op channel handshake rejected by leader (token "
                    "mismatch or bad process id) — check that every pod "
                    "has the same TPU_STACK_OP_TOKEN")
            sock.settimeout(None)
            return sock

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("op channel closed")
            buf += chunk
        return buf

    def send(self, obj: Any) -> None:
        if not self.is_leader:
            raise RuntimeError("only the leader sends ops")
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        frame = struct.pack("!q", len(payload)) + payload
        with self._send_lock:
            for conn in self._conns:
                conn.sendall(frame)

    def recv(self) -> Any:
        """The next op (a follower). Frames come only from the leader
        whose token matched at the handshake."""
        if self.is_leader:
            raise RuntimeError("the leader receives no ops")
        (n,) = struct.unpack("!q", self._read_exact(self._sock, 8))
        return pickle.loads(self._read_exact(self._sock, n))

    def watch(self, on_lost: Callable[[int], None]) -> None:
        """Leader: call ``on_lost(pid)`` from a daemon thread when a
        follower's connection closes (followers never send after the
        handshake, so any read that returns is a lost follower)."""
        for pid, conn in enumerate(self._conns, start=1):
            def wait(pid=pid, conn=conn):
                try:
                    conn.recv(1)
                except OSError:
                    pass
                if not self._closed:
                    on_lost(pid)

            threading.Thread(target=wait, daemon=True,
                             name=f"op-channel-watch-{pid}").start()

    def close(self) -> None:
        self._closed = True
        for conn in self._conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class MultihostContext:
    """Per-process handle the engine uses: the op channel plus a dispatch
    lock serializing (send, enqueue) pairs so the leader's op order is
    exactly the followers' replay order. ``on_lost`` is the current
    engine's handler of a lost follower (leader only)."""

    def __init__(self, env: dict, environ=None):
        self.env = env
        self.channel = OpChannel(env, environ)
        self.is_leader = self.channel.is_leader
        self.num_processes = env["num_processes"]
        self.process_id = env["process_id"]
        self.lock = threading.RLock()
        self.on_lost: Optional[Callable[[int], None]] = None
        if self.is_leader:
            self.channel.watch(self._lost)

    def _lost(self, pid: int) -> None:
        logger.error("Op channel: follower %d is gone", pid)
        handler = self.on_lost
        if handler is not None:
            handler(pid)

    def close(self) -> None:
        self.channel.close()


def maybe_context() -> Optional[MultihostContext]:
    """A MultihostContext when this process is part of a multi-host job
    (``initialize_from_env`` already ran), else None."""
    import torch.distributed as dist

    env = distributed_env()
    if env is None:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            "multi-host env configured but torch.distributed not "
            "initialized; call multihost.initialize_from_env() before "
            "building the engine")
    return MultihostContext(env)


def _free_port_pair() -> int:
    """A port p with p and p + 1 free now (the coordinator and the op
    channel)."""
    for _ in range(50):
        s1 = socket.socket()
        s1.bind(("127.0.0.1", 0))
        port = s1.getsockname()[1]
        s2 = socket.socket()
        try:
            s2.bind(("127.0.0.1", port + 1))
        except OSError:
            continue
        finally:
            s1.close()
            s2.close()
        return port
    raise RuntimeError("no adjacent free port pair")


_SPAWN_KEYS = ("TPU_STACK_COORDINATOR", "TPU_STACK_NUM_PROCESSES",
               "TPU_STACK_OP_TOKEN", "TPU_STACK_PROCESS_ID")


def spawn_local_ranks(n: int, argv: List[str],
                      module: str) -> List[subprocess.Popen]:
    """Start ranks 1..n-1 of an ``n``-rank job on this host as processes
    running ``python -m module argv`` and make this process rank 0: the
    ``TPU_STACK_*`` variables of a fresh loopback coordinator and a
    random op token go into this process's environment and each child's.
    Returns the children; :func:`shutdown` waits for them."""
    port = _free_port_pair()
    shared = {
        "TPU_STACK_COORDINATOR": f"127.0.0.1:{port}",
        "TPU_STACK_NUM_PROCESSES": str(n),
        "TPU_STACK_OP_TOKEN": secrets.token_hex(16),
    }
    os.environ.pop("TPU_STACK_OP_PORT", None)
    # The children import this package from where this process did.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    procs = []
    for rank in range(1, n):
        env = dict(os.environ, **shared, TPU_STACK_PROCESS_ID=str(rank),
                   PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + list(argv), env=env))
    os.environ.update(shared, TPU_STACK_PROCESS_ID="0")
    return procs


def shutdown(ctx: Optional[MultihostContext],
             procs: List[subprocess.Popen] = (),
             timeout: float = 60.0) -> List[int]:
    """Close the op channel, leave the ``torch.distributed`` job and wait
    for spawned ranks (killed past ``timeout``), whose ``TPU_STACK_*``
    variables then leave this process's environment. Returns their exit
    codes. The job is left before the wait: a follower tearing down its
    NCCL communicators may wait for this process's side of them."""
    import torch.distributed as dist

    if ctx is not None:
        ctx.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    if procs:
        for key in _SPAWN_KEYS:
            os.environ.pop(key, None)
    return codes
