"""XXH64 in the standard library (``struct`` and Python ints).

The prefix-cache chain hashes (``engine/kvcache.py``), the KV
controller's text-chunk hashes and its path keys (``kv/controller.py``)
are XXH64 digests, bit for bit those of the ``xxhash`` package that the
JAX engine and the router use, so the port's pages, offloaded blocks and
admission reports interchange with theirs. One code path on every host:
the ``xxhash`` package is not used even where it is installed.

    xxh64_intdigest(b"abc")          # one shot; str is hashed as UTF-8
    h = xxh64(); h.update(b"a"); h.update(b"bc"); h.intdigest()
"""

from __future__ import annotations

import struct

_M = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5

_STRIPE = struct.Struct("<4Q")


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & _M
    acc = ((acc << 31) | (acc >> 33)) & _M
    return (acc * P1) & _M


def _merge(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * P1 + P4) & _M


def xxh64_intdigest(data, seed: int = 0) -> int:
    """The XXH64 digest of ``data`` (bytes-like, or str as UTF-8) under
    ``seed``, as an unsigned 64-bit int."""
    if isinstance(data, str):
        data = data.encode()
    data = bytes(data)
    n = len(data)
    seed &= _M
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & _M
        v2 = (seed + P2) & _M
        v3 = seed
        v4 = (seed - P1) & _M
        end = n - 32
        unpack = _STRIPE.unpack_from
        while i <= end:
            a, b, c, d = unpack(data, i)
            # The lane rounds inline: one call per 32 bytes, not four.
            v1 = (v1 + a * P2) & _M
            v1 = ((((v1 << 31) | (v1 >> 33)) & _M) * P1) & _M
            v2 = (v2 + b * P2) & _M
            v2 = ((((v2 << 31) | (v2 >> 33)) & _M) * P1) & _M
            v3 = (v3 + c * P2) & _M
            v3 = ((((v3 << 31) | (v3 >> 33)) & _M) * P1) & _M
            v4 = (v4 + d * P2) & _M
            v4 = ((((v4 << 31) | (v4 >> 33)) & _M) * P1) & _M
            i += 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + P5) & _M
    h = (h + n) & _M
    while i + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, i)
        h ^= _round(0, k)
        h = ((((h << 27) | (h >> 37)) & _M) * P1 + P4) & _M
        i += 8
    if i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h ^= (k * P1) & _M
        h = ((((h << 23) | (h >> 41)) & _M) * P2 + P3) & _M
        i += 4
    while i < n:
        h ^= (data[i] * P5) & _M
        h = ((((h << 11) | (h >> 53)) & _M) * P1) & _M
        i += 1
    h ^= h >> 33
    h = (h * P2) & _M
    h ^= h >> 29
    h = (h * P3) & _M
    h ^= h >> 32
    return h


class xxh64:  # noqa: N801 - the xxhash package's name for it
    """Incremental form: ``update`` buffers, ``intdigest`` hashes the
    whole input (the hashed inputs here are a few hundred bytes)."""

    def __init__(self, data=b"", seed: int = 0):
        self._buf = bytearray()
        self._seed = seed
        if data:
            self.update(data)

    def update(self, data) -> None:
        self._buf += data.encode() if isinstance(data, str) else data

    def intdigest(self) -> int:
        return xxh64_intdigest(self._buf, self._seed)
