"""What an engine needs of the KV controller: the text-chunk hashes it
reports admissions under, and the path keys and digest of its
anti-entropy resync. The port's copy of those parts of
``production_stack_tpu/kv/controller.py``; the controller itself runs in
the router, which computes the same hashes (XXH64, ``utils/xxh64.py``).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from production_stack_tpu_torch.utils.xxh64 import xxh64_intdigest

CHUNK_SIZE = 128  # characters a hash chunk; the router's prefix trie's

# The shared L3 cache server's reserved instance id: the controller
# re-attributes a claim reported as spilled to it.
L3_INSTANCE = "__l3__"


def chunk_hashes(text: str, chunk_size: int = CHUNK_SIZE,
                 salt: Optional[str] = None) -> List[int]:
    """XXH64 of each ``chunk_size``-character chunk of ``text`` (UTF-8).
    A ``salt`` (a LoRA adapter's name) prefixes every chunk with
    ``salt + "\\x00"``, so adapters never share a claim with the base
    model; no salt gives the unsalted hashes."""
    prefix = f"{salt}\x00" if salt else ""
    return [xxh64_intdigest(prefix + text[i:i + chunk_size])
            for i in range(0, len(text), chunk_size)]


def path_key(parent_key: int, chunk_hash: int) -> int:
    """The key of one trie node: the hash of the root-anchored chunk-hash
    path down to it."""
    return xxh64_intdigest(f"{parent_key}:{chunk_hash}")


def path_keys(hashes: List[int], root_key: int = 0) -> List[int]:
    """Node keys of every prefix of a root-anchored chunk-hash path."""
    keys = []
    k = root_key
    for h in hashes:
        k = path_key(k, h)
        keys.append(k)
    return keys


def claim_digest(keys: "Set[int]") -> Tuple[int, int]:
    """(count, xor of keys) of a claim set: order-free; a mismatch in
    either field makes the engine resend its whole state."""
    x = 0
    for k in keys:
        x ^= k
    return len(keys), x
