"""Device-to-device KV pipe between engine processes of one host, on CUDA
IPC.

The port's counterpart of ``production_stack_tpu/kv/device_pipe.py``,
which parks gathered pages as device arrays behind a
``jax.experimental.transfer`` server for a peer to pull. Here the
sending engine parks the gathered pages on its card and hands out their
CUDA IPC handles (``torch.multiprocessing.reductions``: ``reduce_tensor``
on the sender, ``rebuild_cuda_tensor`` on the puller); the pulling
engine opens the handles in its own process, copies the pages into its
own memory, and installs them in its pool. No host staging, no HTTP
body: the handles travel in ``/kv/prepare_pull``'s JSON answer. CPU
tensors are shared the same way through shared memory (the reductions'
``file_system`` storages), so the two-process protocol runs on a CPU
host too.

- The sender synchronizes the gather's stream before it hands out a
  handle, so a puller never reads half-gathered pages.
- An offer's tensors stay referenced until ``/kv/release`` or the
  offer's TTL: a pull never frees the sender's memory under the
  puller. As in the JAX pipe, the TTL does not reclaim device memory a
  handle was issued for (CUDA keeps a shared block until the puller's
  reference is gone), so ``MAX_PENDING_OFFERS`` bounds what unreleased
  offers pin.
- The puller opens a handle on the device index it names, then copies
  to its own device.

Availability is probed once, in throwaway subprocesses (an offerer and a
puller, the real topology), because opening a bad IPC handle can abort
a process; ``TPU_STACK_KV_DEVICE_PIPE=0|1`` overrides the probe. When
the pipe is unavailable, callers fall back to the TKV2 HTTP relay.
"""

from __future__ import annotations

import base64
import itertools
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

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

    def __init__(self):
        self._uuid = itertools.count(int(time.time() * 1000) % (1 << 30))
        # uuid -> (tensors, handles, deadline): keeps the parked pages
        # alive.
        self._pending: Dict[int, Tuple[List[torch.Tensor], List[dict],
                                       float]] = {}
        # uuids handed out and not released: unlike _pending this never
        # decays with the TTL, so a bogus release cannot undercount.
        self._registered: set = set()
        self._lock = threading.Lock()
        self.host = host_key()

    def address(self) -> str:
        """Where this pipe's offers open: this host and process."""
        return f"{self.host}/{os.getpid()}"

    def offer(self, tensors: List[torch.Tensor]) -> Optional[int]:
        """Park ``tensors`` for a peer's pull: the pull's uuid (its handles
        are :meth:`handles`), or None when ``MAX_PENDING_OFFERS`` offers
        are outstanding (the caller falls back to the HTTP relay). The
        work that made the tensors is waited for before any handle is
        made."""
        now = time.monotonic()
        with self._lock:
            self._pending = {u: e for u, e in self._pending.items()
                             if e[2] > now}
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
            handles = [share(t) for t in parked]
        except Exception:
            with self._lock:
                self._registered.discard(uuid)
            raise
        with self._lock:
            self._pending[uuid] = (parked, handles,
                                   now + self.OFFER_TTL_SEC)
        return uuid

    def handles(self, uuid: int) -> Optional[List[dict]]:
        """The handles of offer ``uuid`` (what a puller opens), or None
        once it is released or expired."""
        with self._lock:
            entry = self._pending.get(uuid)
        return None if entry is None else entry[1]

    def release(self, uuid: int) -> None:
        """The peer pulled the offer (or gave it up): its tensors go and
        its slot frees."""
        with self._lock:
            self._pending.pop(uuid, None)
            self._registered.discard(uuid)

    def pending(self) -> int:
        with self._lock:
            return len(self._registered)

    def pull(self, address: str, uuid: int, specs: List[dict],
             device: Any = None,
             stats: Optional[dict] = None) -> List[torch.Tensor]:
        """The tensors of a peer's offer ``uuid``, each copied out of the
        peer's memory into this process's (on ``device``; by default the
        index the handle names). ``specs`` are the offer's handles. Raises
        when ``address`` is not on this host. ``stats``, a dict, takes what
        the pull cost: opening the handles (``open_seconds``, host) and
        copying the pages out (``copy_ms``: device time on a card, host
        time otherwise)."""
        if address.rsplit("/", 1)[0] != self.host:
            raise RuntimeError(f"KV device pipe: offer {uuid} is on another "
                               f"host ({address})")
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
            stats.update(open_seconds=t1 - t0,
                         copy_ms=(start.elapsed_time(end) if cuda
                                  else (t2 - t1) * 1e3))
        return out
