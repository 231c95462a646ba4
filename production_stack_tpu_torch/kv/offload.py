"""KV offload tiers and wire formats: device pages -> host RAM -> a
remote block store (the L3 cache server).

The port's copy of ``production_stack_tpu/kv/offload.py`` over torch CPU
tensors. The engine's allocator calls ``on_evict`` just before it
recycles a cached page; the engine gathers the evicted pages and copies
them here, keyed by their prefix chain hash, and ``allocate_prompt``
consults :meth:`HostKVStore.contains` so an evicted prefix comes back to
the card with a copy instead of a recompute.

Two wire formats, byte for byte the JAX package's:

- a block (``pack_block``): one ``.npz`` payload of raw bytes, shape and
  dtype name per array (the cache server's ``PUT/GET /v1/blocks/{hash}``);
- a transfer (``pack_transfer``, "TKV2"): ``b"TKV2"``, a little-endian
  u32 header length, a JSON header (hashes, token count, each array's
  dtype name and shape) and the arrays' raw bytes in the header's key
  order (``/kv/extract``, ``/kv/inject``, ``/kv/pull``).

bf16 travels as its raw bytes under the dtype name ``"bfloat16"`` and is
rebuilt with ``torch.frombuffer``; int8 pages travel as ``(data,
scales)`` pairs, the scales ``[..., bs*KVH]`` float32.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import warnings
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np
import torch

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "int8": torch.int8,
           "uint8": torch.uint8, "int32": torch.int32, "int64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(t: torch.Tensor) -> str:
    """The wire name of a tensor's dtype (numpy's, ``"bfloat16"`` for
    bf16)."""
    return _NAMES[t.dtype]


def _raw(t: torch.Tensor) -> memoryview:
    """A tensor's bytes, without a copy when it is contiguous on the
    host."""
    t = t.detach().contiguous()
    return memoryview(t.view(torch.uint8).reshape(-1).numpy())


def _frombuffer(buf, dtype: torch.dtype, shape, offset: int = 0):
    """A tensor over ``buf`` (no copy). A read-only buffer (``bytes``)
    gives a tensor that must not be written: every reader here only
    copies from it."""
    count = int(np.prod(shape)) if len(shape) else 1
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # non-writable buffer
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    return t.reshape(shape)


def _pack_arrays(**arrays: torch.Tensor) -> bytes:
    buf = io.BytesIO()
    fields = {}
    for key, t in arrays.items():
        fields[key] = np.frombuffer(_raw(t), np.uint8)
        fields[f"{key}_shape"] = np.asarray(tuple(t.shape), np.int64)
        fields[f"{key}_dtype"] = np.frombuffer(dtype_name(t).encode(),
                                               np.uint8)
    np.savez(buf, **fields)
    return buf.getvalue()


def _unpack_arrays(data: bytes, keys) -> dict:
    out = {}
    with np.load(io.BytesIO(data)) as z:
        for key in keys:
            shape = tuple(int(x) for x in z[f"{key}_shape"])
            dtype = _DTYPES[bytes(z[f"{key}_dtype"]).decode()]
            out[key] = _frombuffer(bytearray(z[key].tobytes()), dtype, shape)
    return out


def pack_block(k, v) -> bytes:
    """One block's pages ([L, bs, KVH, D] each) as bytes; int8 blocks
    arrive as ``(data, scales)`` and ship under ``k_scale``/``v_scale``
    as well."""
    if isinstance(k, (tuple, list)):
        return _pack_arrays(k=k[0], k_scale=k[1], v=v[0], v_scale=v[1])
    return _pack_arrays(k=k, v=v)


def unpack_block(data: bytes):
    """Inverse of :func:`pack_block`: (k, v) tensors, or ((k, k_scale),
    (v, v_scale)) for an int8 payload."""
    with np.load(io.BytesIO(data)) as z:
        quantized = "k_scale_shape" in z.files
    if quantized:
        out = _unpack_arrays(data, ("k", "k_scale", "v", "v_scale"))
        return ((out["k"], out["k_scale"]), (out["v"], out["v_scale"]))
    out = _unpack_arrays(data, ("k", "v"))
    return out["k"], out["v"]


_TRANSFER_MAGIC = b"TKV2"


def pack_transfer_buffers(hashes, num_tokens: int, k, v) -> list:
    """``[header, *array views]`` to write one after another (no
    payload-sized join). Int8 payloads (``(data, scales)`` pairs) follow
    the header in the order k, k_scale, v, v_scale."""
    fields = {}
    if isinstance(k, (tuple, list)):
        fields["k"], fields["k_scale"] = k[0], k[1]
        fields["v"], fields["v_scale"] = v[0], v[1]
    else:
        fields["k"], fields["v"] = k, v
    header = json.dumps({
        "hashes": [int(h) for h in hashes],
        "num_tokens": int(num_tokens),
        **{key: {"dtype": dtype_name(t), "shape": list(t.shape)}
           for key, t in fields.items()},
    }).encode()
    head = _TRANSFER_MAGIC + struct.pack("<I", len(header)) + header
    return [head] + [_raw(t) for t in fields.values()]


def pack_transfer(hashes, num_tokens: int, k, v) -> bytes:
    """One-shot packing for callers that need a single payload."""
    return b"".join(bytes(b) for b in pack_transfer_buffers(
        hashes, num_tokens, k, v))


def unpack_transfer(data) -> dict:
    """Inverse of :func:`pack_transfer`: tensors over ``data`` at their
    offsets (no copies); int8 payloads come back as (data, scales) pairs
    under "k" and "v". Raises ValueError on a payload that is not TKV2 or
    is cut short."""
    if bytes(data[:4]) != _TRANSFER_MAGIC:
        raise ValueError("not a TKV2 payload")
    (hlen,) = struct.unpack_from("<I", data, 4)
    header = json.loads(bytes(data[8:8 + hlen]).decode())
    offset = 8 + hlen
    quantized = "k_scale" in header
    keys = ("k", "k_scale", "v", "v_scale") if quantized else ("k", "v")
    out = {}
    for key in keys:
        dtype = _DTYPES[header[key]["dtype"]]
        shape = tuple(int(x) for x in header[key]["shape"])
        nbytes = ((int(np.prod(shape)) if shape else 1)
                  * torch.empty((), dtype=dtype).element_size())
        if offset + nbytes > len(data):
            raise ValueError("TKV2 payload cut short")
        out[key] = _frombuffer(data, dtype, shape, offset)
        offset += nbytes
    k, v = out["k"], out["v"]
    if quantized:
        k, v = (k, out["k_scale"]), (v, out["v_scale"])
    return {"hashes": [int(h) for h in header["hashes"]],
            "num_tokens": int(header["num_tokens"]), "k": k, "v": v}


class RemoteKVClient:
    """Blocking HTTP client of the cache server's block API
    (``PUT/GET/HEAD /v1/blocks/{hash}``). Failures read as misses: the
    caller recomputes."""

    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def put(self, prefix_hash: int, data: bytes) -> bool:
        req = urllib.request.Request(
            f"{self.base_url}/v1/blocks/{prefix_hash}", data=data,
            method="PUT",
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                return True
        except (urllib.error.URLError, OSError) as e:
            logger.debug("remote KV put failed: %s", e)
            return False

    def get(self, prefix_hash: int) -> Optional[bytes]:
        try:
            with urllib.request.urlopen(
                    f"{self.base_url}/v1/blocks/{prefix_hash}",
                    timeout=self.timeout) as resp:
                return resp.read()
        except (urllib.error.URLError, OSError):
            return None

    def contains(self, prefix_hash: int) -> bool:
        # Probes run on the engine thread during prompt allocation: keep
        # the worst case short.
        req = urllib.request.Request(
            f"{self.base_url}/v1/blocks/{prefix_hash}", method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=min(1.0, self.timeout)):
                return True
        except (urllib.error.URLError, OSError):
            return False


def _nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(e) for e in x)
    return x.numel() * x.element_size()


class HostKVStore:
    """LRU, byte-capped host-RAM block store with an optional remote
    tier. Entries are ``(k, v)`` CPU tensors (or int8 ``(data, scales)``
    pairs). Thread-safe.

    ``put(..., ready=fn)`` takes a block whose bytes are still in flight
    (an asynchronous copy from the card): nothing here reads them before
    ``fn()`` returns, and a reader on the card orders itself after the
    copy. Uploads to the remote tier run on a writer thread, so a slow
    cache server never stalls the engine; past 256 queued uploads the
    oldest is dropped (a cache, not a guarantee)."""

    _REMOTE_QUEUE_MAX = 256

    def __init__(self, capacity_bytes: int, remote_url: Optional[str] = None):
        self.capacity_bytes = capacity_bytes
        self._store: "OrderedDict[int, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.remote = RemoteKVClient(remote_url) if remote_url else None
        self.hits = 0
        self.misses = 0
        self.stored = 0
        self.evicted = 0
        # The remote (L3) tier's traffic, for the tpu:l3_* series.
        self.remote_put_blocks = 0
        self.remote_put_bytes = 0
        self.remote_get_blocks = 0
        self.remote_get_bytes = 0
        self._remote_queue: "deque[tuple]" = deque()
        self._remote_inflight = 0
        self._remote_cv = threading.Condition()
        self._closed = False
        self._writer: Optional[threading.Thread] = None
        if self.remote is not None:
            self._writer = threading.Thread(
                target=self._remote_writer, daemon=True, name="kv-offload-tx")
            self._writer.start()

    def _enqueue_remote(self, prefix_hash: int, k, v,
                        ready: Optional[Callable[[], None]]) -> None:
        with self._remote_cv:
            if len(self._remote_queue) >= self._REMOTE_QUEUE_MAX:
                self._remote_queue.popleft()  # drop the oldest upload
            self._remote_queue.append((prefix_hash, k, v, ready))
            self._remote_cv.notify_all()

    def _remote_writer(self) -> None:
        while True:
            with self._remote_cv:
                while not self._remote_queue and not self._closed:
                    self._remote_cv.wait()
                if self._closed:
                    return
                prefix_hash, k, v, ready = self._remote_queue.popleft()
                self._remote_inflight += 1
            try:
                if ready is not None:
                    ready()
                data = pack_block(k, v)
                if self.remote.put(prefix_hash, data):
                    with self._lock:
                        self.remote_put_blocks += 1
                        self.remote_put_bytes += len(data)
            except Exception:  # noqa: BLE001 - the writer must keep going
                logger.exception("remote KV upload of %d failed", prefix_hash)
            finally:
                with self._remote_cv:
                    self._remote_inflight -= 1
                    self._remote_cv.notify_all()

    def flush_remote(self, timeout: float = 10.0) -> bool:
        """Wait until queued and in-flight uploads have landed (the
        writer pops before it uploads). True when they did in time."""
        deadline = time.monotonic() + timeout
        with self._remote_cv:
            while self._remote_queue or self._remote_inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._remote_cv.wait(left)
        return True

    def close(self) -> None:
        """Stop the writer thread; uploads still queued are dropped."""
        with self._remote_cv:
            self._closed = True
            self._remote_cv.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=10)

    def put(self, prefix_hash: int, k, v,
            ready: Optional[Callable[[], None]] = None) -> None:
        size = _nbytes(k) + _nbytes(v)
        spill = []
        with self._lock:
            if prefix_hash in self._store:
                return
            # Evict LRU entries to fit; they spill to the remote tier.
            while self._bytes + size > self.capacity_bytes and self._store:
                old_hash, (ok, ov, oready) = self._store.popitem(last=False)
                self._bytes -= _nbytes(ok) + _nbytes(ov)
                self.evicted += 1
                spill.append((old_hash, ok, ov, oready))
            if self._bytes + size <= self.capacity_bytes:
                self._store[prefix_hash] = (k, v, ready)
                self._bytes += size
                self.stored += 1
            elif self.remote is not None:
                # Does not fit here (a remote-only tier, or a block larger
                # than the host budget): straight to the remote tier.
                spill.append((prefix_hash, k, v, ready))
                self.stored += 1
        if self.remote is not None:
            for h, sk, sv, sready in spill:
                self._enqueue_remote(h, sk, sv, sready)

    def get(self, prefix_hash: int):
        """``(k, v)`` of a block, from host RAM or the remote tier, or
        None (a miss)."""
        with self._lock:
            entry = self._store.get(prefix_hash)
            if entry is not None:
                self._store.move_to_end(prefix_hash)
                self.hits += 1
                return entry[0], entry[1]
        if self.remote is not None:
            data = self.remote.get(prefix_hash)
            if data is not None:
                try:
                    k, v = unpack_block(data)
                except Exception as e:  # noqa: BLE001 - a corrupt block
                    logger.warning("corrupt remote KV block %d: %s",
                                   prefix_hash, e)
                else:
                    with self._lock:
                        self.hits += 1
                        self.remote_get_blocks += 1
                        self.remote_get_bytes += len(data)
                    return k, v
        with self._lock:
            self.misses += 1
        return None

    def contains(self, prefix_hash: int) -> bool:
        with self._lock:
            if prefix_hash in self._store:
                return True
        return self.remote is not None and self.remote.contains(prefix_hash)

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": len(self._store),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "stored": self.stored,
                "evicted": self.evicted,
                "remote": self.remote is not None,
                "remote_put_blocks": self.remote_put_blocks,
                "remote_put_bytes": self.remote_put_bytes,
                "remote_get_blocks": self.remote_get_blocks,
                "remote_get_bytes": self.remote_get_bytes,
            }
