"""Device-to-device KV pipe between engine processes: CUDA IPC on one
host, a two-rank NCCL communicator between hosts.

The port's counterpart of ``production_stack_tpu/kv/device_pipe.py``,
which parks gathered pages as device arrays behind a
``jax.experimental.transfer`` server (listening on ``0.0.0.0:0``) for a
peer to pull over the network. Here the sending engine parks the
gathered pages on its card, and the puller takes them by one of two
transports:

- **IPC**, when the offer was made on the puller's host: the offer's
  CUDA IPC handles (``torch.multiprocessing.reductions``:
  ``reduce_tensor`` on the sender, ``rebuild_cuda_tensor`` on the
  puller) travel in ``/kv/prepare_pull``'s JSON answer; the puller opens
  them and copies the pages into its own memory. CPU tensors are shared
  the same way through shared memory.
- **Network**, otherwise: every pipe hosts a ``torch.distributed``
  ``TCPStore`` on a port it binds when it is made (its
  ``transfer_port``). A puller's first pull from a pipe makes a two-rank
  communicator between the two processes through that store (a
  ``PrefixStore`` a pair): ``ProcessGroupNCCL`` when both sides hold
  card tensors, ``ProcessGroupGloo`` when both hold CPU tensors (a card
  tensor never crosses on gloo), never the default group, which belongs
  to the engine's own ranks. The pair is cached by the peer's address.
  A pull names the offer by its uuid and a per-offer random token (both
  from the ``/kv/prepare_pull`` answer, which sits behind the server's
  API key); the offerer then sends every parked leaf, in the offer's
  order and dtype, and the puller receives each into memory it
  allocated from the offer's shapes. One transfer runs on a pair at a
  time, so both sides post in the same order.

- The sender synchronizes the gather's stream before it offers, so no
  transport reads half-gathered pages.
- An offer's tensors stay referenced until ``/kv/release`` or the
  offer's TTL. As in the JAX pipe, the TTL does not reclaim device
  memory an IPC handle was issued for (CUDA keeps a shared block until
  the puller's reference is gone), so ``MAX_PENDING_OFFERS`` bounds what
  unreleased offers pin.
- A network pull fails (raises) within the pipe's ``timeout`` when the
  peer dies or stalls; its pair is torn down (an NCCL communicator is
  aborted, and made so that a failure aborts it rather than the
  process), and the next pull makes a new one.

IPC availability is probed once, in throwaway subprocesses (an offerer
and a puller, the real topology), because opening a bad IPC handle can
abort a process; ``TPU_STACK_KV_DEVICE_PIPE=0|1`` overrides the probe.
The network transport needs no probe. When the pipe is unavailable, or
a pull fails, callers fall back to the TKV2 HTTP relay.
"""

from __future__ import annotations

import base64
import hmac
import itertools
import json
import os
import secrets
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from typing import Any, Dict, List, Optional

import torch

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "int8": torch.int8,
           "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _b64(raw: Optional[bytes]) -> Optional[str]:
    return None if raw is None else base64.b64encode(raw).decode()


def _unb64(text: Optional[str]) -> Optional[bytes]:
    return None if text is None else base64.b64decode(text)


def share(t: torch.Tensor) -> dict:
    """A JSON description of ``t`` (contiguous) that a process of this
    host opens with :func:`open_shared`: a CUDA IPC handle for a card
    tensor, a shared-memory file for a CPU one (its storage moves into
    shared memory). The caller keeps ``t`` alive while it is open."""
    from torch.multiprocessing.reductions import reduce_tensor

    desc = {"shape": list(t.shape), "stride": list(t.stride()),
            "offset": t.storage_offset(), "dtype": _NAMES[t.dtype]}
    if t.is_cuda:
        _rebuild, args = reduce_tensor(t)
        (_cls, _size, _stride, _off, _scls, _dt, device, handle,
         storage_bytes, storage_offset_bytes, _grad, ref_handle,
         ref_offset, event_handle, event_sync) = args
        desc.update(kind="cuda", device=int(device), handle=_b64(handle),
                    storage_bytes=int(storage_bytes),
                    storage_offset_bytes=int(storage_offset_bytes),
                    ref_counter_handle=_b64(ref_handle),
                    ref_counter_offset=int(ref_offset),
                    event_handle=_b64(event_handle),
                    event_sync_required=bool(event_sync))
        return desc
    storage = t.untyped_storage()
    manager, handle, size = storage._share_filename_cpu_()
    storage._shared_incref()  # the handle's reference, dropped at open
    desc.update(kind="cpu", manager=_b64(manager), handle=_b64(handle),
                storage_bytes=int(size))
    return desc


def open_shared(desc: dict) -> torch.Tensor:
    """The tensor :func:`share` described, opened in this process (a view
    of the sender's memory: copy it before the sender lets it go)."""
    from torch.multiprocessing.reductions import (
        rebuild_cuda_tensor,
        rebuild_storage_filename,
    )

    dtype = _DTYPES[desc["dtype"]]
    if desc["kind"] == "cuda":
        with torch.cuda.device(desc["device"]):
            return rebuild_cuda_tensor(
                torch.Tensor, tuple(desc["shape"]), tuple(desc["stride"]),
                desc["offset"], torch.TypedStorage, dtype, desc["device"],
                _unb64(desc["handle"]), desc["storage_bytes"],
                desc["storage_offset_bytes"], False,
                _unb64(desc["ref_counter_handle"]),
                desc["ref_counter_offset"], _unb64(desc["event_handle"]),
                desc["event_sync_required"])
    storage = rebuild_storage_filename(
        torch.UntypedStorage, _unb64(desc["manager"]),
        _unb64(desc["handle"]), desc["storage_bytes"])
    return torch.empty(0, dtype=dtype).set_(
        storage, desc["offset"], tuple(desc["shape"]), tuple(desc["stride"]))


def host_key() -> str:
    """This host's name and boot: two processes share memory only when
    their keys are equal."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}-{boot}"


# The probe runs the real topology: an offerer and a puller, each a
# process of its own (a loopback open in one process would take the
# sharing cache's shortcut and prove nothing).
_PROBE_OFFER = r"""
import json, sys, time
import torch
from production_stack_tpu_torch.kv.device_pipe import share
dev = "cuda:0" if sys.argv[1] == "cuda" else "cpu"
x = torch.arange(4096, dtype=torch.float32, device=dev).to(
    torch.bfloat16).reshape(4, 32, 32)
if x.is_cuda:
    torch.cuda.synchronize()
desc = share(x)
with open(sys.argv[2] + ".tmp", "w") as f:
    json.dump(desc, f)
import os
os.rename(sys.argv[2] + ".tmp", sys.argv[2])
time.sleep(120)
"""

_PROBE_PULL = r"""
import json, sys
import torch
from production_stack_tpu_torch.kv.device_pipe import open_shared
with open(sys.argv[1]) as f:
    desc = json.load(f)
got = open_shared(desc).clone()
want = torch.arange(4096, dtype=torch.float32, device=got.device).to(
    torch.bfloat16).reshape(4, 32, 32)
assert torch.equal(got, want)
print("DEVICE_PIPE_OK", flush=True)
"""

_probe_result: Optional[bool] = None
_probe_lock = threading.Lock()


def device_pipe_available(timeout: float = 120.0) -> bool:
    """True when a tensor shared by one process opens, whole and right,
    in another on this host: CUDA IPC where a card is present, shared
    memory otherwise. Probed once in subprocesses (a failing open can
    abort the process, not only raise) and cached;
    ``TPU_STACK_KV_DEVICE_PIPE=0|1`` overrides it (1 skips the probe)."""
    global _probe_result
    override = os.environ.get("TPU_STACK_KV_DEVICE_PIPE")
    if override is not None:
        return override not in ("0", "false", "off")
    with _probe_lock:
        if _probe_result is None:
            _probe_result = _probe(timeout)
            logger.info("KV device pipe %s",
                        "available" if _probe_result else
                        "unavailable (falling back to the HTTP relay)")
        return _probe_result


def _probe(timeout: float) -> bool:
    import tempfile

    platform = "cuda" if torch.cuda.is_available() else "cpu"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    offerer = None
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "offer.json")
            offerer = subprocess.Popen(
                [sys.executable, "-c", _PROBE_OFFER, platform, path],
                env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            deadline = time.monotonic() + timeout / 2
            while not os.path.exists(path):
                if (offerer.poll() is not None
                        or time.monotonic() > deadline):
                    return False
                time.sleep(0.05)
            proc = subprocess.run(
                [sys.executable, "-c", _PROBE_PULL, path], env=env,
                capture_output=True, timeout=timeout)
            return b"DEVICE_PIPE_OK" in proc.stdout
    except Exception:  # noqa: BLE001 - any failure: unavailable
        return False
    finally:
        if offerer is not None and offerer.poll() is None:
            offerer.kill()
            offerer.wait()


def leaf_specs(tensors: List[torch.Tensor]) -> List[dict]:
    """The shape and dtype of each tensor: what a network puller
    allocates and what the offerer checks a pull against."""
    return [{"shape": list(t.shape), "dtype": _NAMES[t.dtype]}
            for t in tensors]


# A store wait that should outlive any pull (the offerer's waits for the
# next pair and the next request); the pipe's close ends them.
_FOREVER = timedelta(days=3650)

# NCCL's environment is read when a communicator is made: one at a time.
_NCCL_ENV_LOCK = threading.Lock()
# A pair's communicator: a failed or timed-out transfer aborts it and
# fails its work (2, CleanUpOnly; NCCL's default ends the process), and
# no debug dump follows (the dump's wait held every thread of an engine
# for 60 s a failed transfer on the card).
_NCCL_PAIR_ENV = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "2",
                  "TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
                  "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}


def _device(device: Any) -> torch.device:
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _group(backend: str, store, rank: int, timeout: float):
    """A two-rank process group of its own over ``store``."""
    import torch.distributed as dist

    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, 2, timedelta(
            seconds=timeout))
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timedelta(seconds=timeout)
    with _NCCL_ENV_LOCK:
        old = {key: os.environ.get(key) for key in _NCCL_PAIR_ENV}
        os.environ.update(_NCCL_PAIR_ENV)
        try:
            return dist.ProcessGroupNCCL(store, rank, 2, opts)
        finally:
            for key, value in old.items():
                if value is None:
                    del os.environ[key]
                else:
                    os.environ[key] = value


def _abort(group) -> None:
    abort = getattr(group, "abort", None)
    if abort is None:
        logger.warning("KV device pipe: %s has no abort", type(group))
        return
    t0 = time.perf_counter()
    try:
        abort()
    except Exception as e:  # noqa: BLE001 - already broken
        logger.warning("KV device pipe: abort failed: %s", e)
    logger.info("KV device pipe: a pair aborted in %.3f s",
                time.perf_counter() - t0)


def _settle(works, deadline: float, gloo: bool, alive=None) -> None:
    """Wait for every work of a transfer until ``deadline`` (monotonic),
    then raise its error, if any. On a card the host polls: ``wait()``
    alone only orders the current stream behind NCCL's, and a transfer
    whose peer died would hang the first later synchronize; ``alive``,
    called every 0.2 s of the wait, raises once the peer is gone (over
    NVLink NCCL itself never sees it). Gloo's point-to-point work
    completes only in its own ``wait``, which takes the time left."""
    for work in works:
        if gloo:
            if work.wait(_remaining(deadline)) is False:
                raise TimeoutError("KV device pipe: the transfer did not "
                                   "finish in time")
            continue
        asked = time.monotonic()
        while not work.is_completed():
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError("KV device pipe: the transfer did not "
                                   "finish in time")
            if alive is not None and now - asked > 0.2:
                alive()
                asked = now
            time.sleep(0.0002)
        work.wait()


def _claim(ctl, hello: dict) -> int:
    """Claim the lowest free pair number on a pipe's store with ``hello``
    (one atomic set): the offerer serves pair numbers in order, so no
    claim may leave a gap below it."""
    text = json.dumps(dict(hello, nonce=secrets.token_hex(8)))
    k = int(ctl.add("pairs", 0))
    while True:
        k += 1
        if ctl.compare_set(f"hello/{k}", "", text).decode() == text:
            ctl.add("pairs", 1)
            return k


def _remaining(deadline: float) -> timedelta:
    return timedelta(seconds=max(deadline - time.monotonic(), 0.001))


class _Pair:
    """One end of a two-rank communicator between this pipe and a peer's:
    its control store, its group, and the sequence number of its next
    transfer."""

    def __init__(self, k: int, ctl, group, backend: str,
                 device: torch.device):
        self.k, self.ctl, self.group, self.backend = k, ctl, group, backend
        self.device = device
        self.rendezvous_seconds = 0.0  # the puller's, until a pull reports it
        self.seq = 0
        self.lock = threading.Lock()

    def exchange_probe(self, rank: int, deadline: float) -> None:
        """One element from rank 0 to rank 1: makes NCCL's communicator
        (lazily created at the first transfer), so the rendezvous is paid
        here and not by the first pull's pages."""
        t = torch.ones(1, device=self.device)
        work = (self.group.send([t], 1, 0) if rank == 0
                else self.group.recv([t], 0, 0))
        _settle([work], deadline, self.backend == "gloo")


class KVDevicePipe:
    """One per engine process: offers gathered KV pages for a peer's pull
    and pulls the pages a peer offers."""

    # Offers not released within this window leave the table (the
    # puller falls back to the HTTP relay on a miss); see the module
    # docstring for what that does not reclaim.
    OFFER_TTL_SEC = 120.0

    # Offers handed out and not released. At the disaggregated shapes an
    # offer is tens of MB, so 8 bound the parked memory to a few hundred.
    MAX_PENDING_OFFERS = 8

    def __init__(self, device: Any = None, listen: str = "0.0.0.0:0",
                 timeout: float = 60.0):
        """``device``: where this engine's pages live (a network pair's
        backend follows it); ``listen``: the network transport's bind
        address (port 0: any free one); ``timeout``: seconds a network
        rendezvous or pull may take before it fails."""
        import torch.distributed as dist

        self.device = _device(device)
        self.timeout = timeout
        self._uuid = itertools.count(int(time.time() * 1000) % (1 << 30))
        # uuid -> (tensors, handles or None, token, deadline): keeps the
        # parked pages alive.
        self._pending: Dict[int, tuple] = {}
        # uuids handed out and not released: unlike _pending this never
        # decays with the TTL, so a bogus release cannot undercount.
        self._registered: set = set()
        self._lock = threading.Lock()
        self.host = host_key()
        # The network transport: bound before any peer can join.
        host, port = listen.rsplit(":", 1)
        self._master = dist.TCPStore(host, int(port), is_master=True,
                                     wait_for_workers=False,
                                     timeout=_FOREVER)
        self.transfer_port = int(self._master.port)
        self._closed = False
        self._pairs: Dict[str, _Pair] = {}  # puller side, by address
        self._served: List[_Pair] = []  # offerer side
        self._connect_lock = threading.Lock()
        self._threads = [threading.Thread(target=self._accept, daemon=True,
                                          name="kv-pipe-accept")]
        self._threads[0].start()

    def address(self) -> str:
        """Where this pipe's IPC offers open: this host and process."""
        return f"{self.host}/{os.getpid()}"

    def offer(self, tensors: List[torch.Tensor],
              ipc: bool = True) -> Optional[int]:
        """Park ``tensors`` for a peer's pull: the pull's uuid (its token
        is :meth:`token`, its IPC handles :meth:`handles`, made only when
        ``ipc``), or None when ``MAX_PENDING_OFFERS`` offers are
        outstanding (the caller falls back to the HTTP relay). The work
        that made the tensors is waited for before any handle is made."""
        now = time.monotonic()
        with self._lock:
            self._pending = {u: e for u, e in self._pending.items()
                             if e[3] > now}
            if len(self._registered) >= self.MAX_PENDING_OFFERS:
                logger.warning(
                    "KV device pipe: %d offers outstanding, refusing a new "
                    "one (HTTP relay fallback)", len(self._registered))
                return None
            uuid = next(self._uuid)
            self._registered.add(uuid)
        try:
            parked = [t.contiguous() for t in tensors]
            for dev in {t.device for t in parked if t.is_cuda}:
                torch.cuda.current_stream(dev).synchronize()
            handles = [share(t) for t in parked] if ipc else None
        except Exception:
            with self._lock:
                self._registered.discard(uuid)
            raise
        with self._lock:
            self._pending[uuid] = (parked, handles, secrets.token_hex(16),
                                   now + self.OFFER_TTL_SEC)
        return uuid

    def handles(self, uuid: int) -> Optional[List[dict]]:
        """The IPC handles of offer ``uuid`` (what a puller of this host
        opens), or None once it is released or expired, or when it was
        made without them."""
        with self._lock:
            entry = self._pending.get(uuid)
        return None if entry is None else entry[1]

    def token(self, uuid: int) -> Optional[str]:
        """The secret a network pull of offer ``uuid`` must name."""
        with self._lock:
            entry = self._pending.get(uuid)
        return None if entry is None else entry[2]

    def release(self, uuid: int) -> None:
        """The peer pulled the offer (or gave it up): its tensors go and
        its slot frees."""
        with self._lock:
            self._pending.pop(uuid, None)
            self._registered.discard(uuid)

    def pending(self) -> int:
        with self._lock:
            return len(self._registered)

    def close(self) -> None:
        """Stop serving: the offerer's threads read a closing word and
        end, every pair's group is aborted, and the store closes."""
        import torch.distributed as dist

        with self._lock:
            if self._closed:
                return
            self._closed = True
            pairs = list(self._pairs.values())
            served, self._pairs, self._served = self._served, {}, []
        ctl = self._client("127.0.0.1", self.transfer_port,
                           timedelta(seconds=10))
        _claim(ctl, {"close": True})
        for pair in served:
            dist.PrefixStore(f"pair/{pair.k}", ctl).set(
                f"req/{pair.seq}", json.dumps({"close": True}))
        for th in self._threads:
            th.join(timeout=10)
        for pair in pairs + served:
            _abort(pair.group)
        self._master = None

    def pull(self, address: str, uuid: int, specs: List[dict],
             device: Any = None, stats: Optional[dict] = None,
             token: Optional[str] = None) -> List[torch.Tensor]:
        """The tensors of a peer's offer ``uuid``, in this process's memory
        (on ``device``). ``address`` picks the transport: an IPC offer's
        ``<host key>/<pid>`` (:meth:`address`; ``specs`` are its handles,
        and by default each opens on the index its handle names; raises
        when the host is not this one), or a network offer's
        ``<host>:<transfer port>`` (``specs`` are its leaves'
        :func:`leaf_specs`, ``token`` its secret; by default on this
        pipe's device). ``stats``, a dict, takes what the pull cost:
        ``transport``; over IPC opening the handles (``open_seconds``,
        host) and copying the pages out (``copy_ms``: device time on a
        card, host time otherwise); over the network the ``backend``, the
        pair's rendezvous (``rendezvous_seconds``, host, 0 once the pair
        is cached), the offerer's sends (``transfer_ms``: device time on
        a card, host time otherwise) and the whole transfer on this side
        (``pull_seconds``, host)."""
        host, sep, _pid = address.rpartition("/")
        if not sep:
            return self._pull_net(address, uuid, specs, token,
                                  _device(device if device is not None
                                          else self.device), stats)
        if host != self.host:
            raise RuntimeError(f"KV device pipe: offer {uuid} is on another "
                               f"host ({address}) and names no transfer "
                               f"address")
        t0 = time.perf_counter()
        shared = [open_shared(desc) for desc in specs]
        t1 = time.perf_counter()
        cuda = any(t.is_cuda for t in shared)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = [t.to(device if device is not None else t.device, copy=True)
               for t in shared]
        if cuda:
            end.record()
        for dev in {t.device for t in out if t.is_cuda}:
            # The copies have read the peer's memory before it is released.
            torch.cuda.current_stream(dev).synchronize()
        t2 = time.perf_counter()
        del shared
        if stats is not None:
            stats.update(transport="ipc", open_seconds=t1 - t0,
                         copy_ms=(start.elapsed_time(end) if cuda
                                  else (t2 - t1) * 1e3))
        return out

    # -- the network transport: the puller's side --------------------------
    def _client(self, host: str, port: int, timeout: timedelta):
        import torch.distributed as dist

        return dist.TCPStore(host, port, is_master=False, timeout=timeout)

    def _connect(self, address: str, device: torch.device) -> _Pair:
        """The cached pair with the pipe at ``address``, made (the
        rendezvous) at the first pull."""
        import torch.distributed as dist

        with self._connect_lock:
            with self._lock:
                pair = self._pairs.get(address)
            if pair is not None:
                return pair
            t0 = time.perf_counter()
            deadline = time.monotonic() + self.timeout
            host, port = address.rsplit(":", 1)
            host = host.strip("[]")
            ctl = self._client(host, int(port), _remaining(deadline))
            # Claim the lowest free pair number: the offerer serves pairs
            # in order, so a claim must leave no gap below it.
            k = _claim(ctl, {"device": device.type})
            p = dist.PrefixStore(f"pair/{k}", ctl)
            p.wait(["accept"], _remaining(deadline))
            accept = json.loads(p.get("accept"))
            if "error" in accept:
                raise RuntimeError(f"KV device pipe: {address} refused the "
                                   f"pair: {accept['error']}")
            group = _group(accept["backend"], dist.PrefixStore(
                f"pair/{k}/group", self._client(host, int(port),
                                                 _remaining(deadline))),
                1, self.timeout)
            pair = _Pair(k, p, group, accept["backend"], device)
            try:
                pair.exchange_probe(1, deadline)
            except Exception:
                _abort(group)
                raise
            pair.rendezvous_seconds = time.perf_counter() - t0
            with self._lock:
                if self._closed:
                    _abort(group)
                    raise RuntimeError("KV device pipe: closed")
                self._pairs[address] = pair
            return pair

    def _drop(self, address: str, pair: _Pair) -> None:
        with self._lock:
            if self._pairs.get(address) is pair:
                del self._pairs[address]
        _abort(pair.group)

    def _pull_net(self, address, uuid, specs, token, device, stats):
        pair = self._connect(address, device)
        if pair.device != device:  # its backend follows its device
            raise RuntimeError(f"KV device pipe: the pair with {address} "
                               f"receives on {pair.device}, not {device}")
        with pair.lock:
            seq = pair.seq
            pair.seq += 1
            rendezvous, pair.rendezvous_seconds = pair.rendezvous_seconds, 0.0
            t0 = time.perf_counter()
            deadline = time.monotonic() + self.timeout
            p = pair.ctl
            try:
                p.set(f"req/{seq}", json.dumps({
                    "uuid": int(uuid), "token": token or "",
                    "leaves": [{"shape": list(s["shape"]),
                                "dtype": s["dtype"]} for s in specs]}))
                p.wait([f"ack/{seq}"], _remaining(deadline))
                ack = json.loads(p.get(f"ack/{seq}"))
                p.delete_key(f"ack/{seq}")
            except Exception:
                self._drop(address, pair)
                raise
            if "error" in ack:  # the pair stays good: nothing was posted
                raise RuntimeError(f"KV device pipe: offer {uuid}: "
                                   f"{ack['error']}")
            try:
                out = [torch.empty(s["shape"], dtype=_DTYPES[s["dtype"]],
                                   device=device) for s in specs]
                works = [pair.group.recv([t], 0, 0) for t in out]
                p.set(f"go/{seq}", "1")
                # The offerer hosts the store: a failed check is its death.
                _settle(works, deadline, pair.backend == "gloo",
                        alive=lambda: p.check([f"go/{seq}"]))
                p.wait([f"done/{seq}"], _remaining(deadline))
                done = json.loads(p.get(f"done/{seq}"))
                p.delete_key(f"done/{seq}")
            except Exception:
                self._drop(address, pair)
                raise
        if stats is not None:
            stats.update(transport="network", backend=pair.backend,
                         rendezvous_seconds=rendezvous,
                         transfer_ms=done["ms"],
                         pull_seconds=time.perf_counter() - t0)
        return out

    # -- the network transport: the offerer's side -------------------------
    def _accept(self) -> None:
        """Serve each pair a puller claims, in order, on a thread of its
        own; ends when the pipe closes (its store with it)."""
        try:
            ctl = self._client("127.0.0.1", self.transfer_port, _FOREVER)
            k = 1
            while True:
                ctl.wait([f"hello/{k}"])
                hello = json.loads(ctl.get(f"hello/{k}"))
                if hello.get("close"):
                    return
                th = threading.Thread(target=self._serve, args=(k, hello),
                                      daemon=True, name=f"kv-pipe-pair-{k}")
                with self._lock:
                    self._threads.append(th)
                th.start()
                k += 1
        except Exception as e:  # noqa: BLE001 - the store closed
            if not self._closed:
                logger.warning("KV device pipe: stopped accepting: %s", e)

    def _lookup(self, req: dict):
        """(tensors, None) of the offer ``req`` names, or (None, why)."""
        with self._lock:
            entry = self._pending.get(int(req["uuid"]))
        if entry is None or entry[3] <= time.monotonic():
            return None, "no such offer (released or expired)"
        if not hmac.compare_digest(entry[2], str(req.get("token", ""))):
            return None, "wrong token"
        if req["leaves"] != leaf_specs(entry[0]):
            return None, "the pull's leaves are not the offer's"
        return entry[0], None

    def _serve(self, k: int, hello: dict) -> None:
        import torch.distributed as dist

        pair = None
        try:
            p = dist.PrefixStore(f"pair/{k}", self._client(
                "127.0.0.1", self.transfer_port, _FOREVER))
            backend = {"cuda": "nccl", "cpu": "gloo"}.get(self.device.type)
            if hello.get("device") != self.device.type:
                p.set("accept", json.dumps({"error": (
                    f"the offers are on {self.device.type}, the puller's "
                    f"pages on {hello.get('device')}")}))
                return
            p.set("accept", json.dumps({"backend": backend}))
            group = _group(backend, dist.PrefixStore(
                f"pair/{k}/group", self._client(
                    "127.0.0.1", self.transfer_port, _FOREVER)),
                0, self.timeout)
            pair = _Pair(k, p, group, backend, self.device)
            with self._lock:
                if self._closed:
                    _abort(group)
                    return
                self._served.append(pair)
            pair.exchange_probe(0, time.monotonic() + self.timeout)
            stream = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
            while True:
                seq = pair.seq
                p.wait([f"req/{seq}"])
                req = json.loads(p.get(f"req/{seq}"))
                if req.get("close"):
                    return
                p.delete_key(f"req/{seq}")
                tensors, error = self._lookup(req)
                p.set(f"ack/{seq}", json.dumps(
                    {"error": error} if error else {"ok": True}))
                if tensors is not None:
                    deadline = time.monotonic() + self.timeout
                    p.wait([f"go/{seq}"], _remaining(deadline))
                    p.delete_key(f"go/{seq}")
                    ms = self._send(pair, tensors, stream, deadline)
                    p.set(f"done/{seq}", json.dumps({"ms": ms}))
                pair.seq += 1
        except Exception as e:  # noqa: BLE001 - the pair ends, not the pipe
            if not self._closed:
                logger.warning("KV device pipe: pair %d ended: %s", k, e)
        finally:
            if pair is not None:
                with self._lock:
                    if pair in self._served:
                        self._served.remove(pair)
                _abort(pair.group)

    @staticmethod
    def _send(pair: _Pair, tensors, stream, deadline: float) -> float:
        """Every leaf to rank 1 in order: the sends' time in ms (device
        time on a card: events on a stream of the pair's own, so no
        engine launch sits between them)."""
        if stream is None:
            t0 = time.perf_counter()
            _settle([pair.group.send([t], 1, 0) for t in tensors], deadline,
                    True)
            return (time.perf_counter() - t0) * 1e3
        with torch.cuda.stream(stream):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            _settle([pair.group.send([t], 1, 0) for t in tensors], deadline,
                    False)
            end.record(stream)
        end.synchronize()
        return start.elapsed_time(end)
