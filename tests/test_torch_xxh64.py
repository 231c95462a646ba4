"""The port's standard-library XXH64 against the ``xxhash`` package, and
the hashes built on it against the JAX package's: the prefix-cache chain
hash (``engine/kvcache.py``) and the KV controller's text-chunk hashes,
path keys and claim digest (``kv/controller.py``)."""

import random

import pytest
import xxhash

from production_stack_tpu.engine.kvcache import BlockAllocator as JaxAllocator
from production_stack_tpu.kv import controller as jax_controller
from production_stack_tpu_torch.engine.kvcache import BlockAllocator
from production_stack_tpu_torch.kv import controller
from production_stack_tpu_torch.utils.xxh64 import xxh64, xxh64_intdigest


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B1, 2 ** 32 + 7, 2 ** 64 - 1])
def test_digest_equals_xxhash_at_every_length(seed):
    rng = random.Random(seed % 1000)
    for n in range(301):
        data = bytes(rng.getrandbits(8) for _ in range(n))
        assert xxh64_intdigest(data, seed) == xxhash.xxh64_intdigest(
            data, seed=seed), n


def test_str_hashes_as_utf8():
    text = "prefix pages é中\U0001f600 " * 9
    assert xxh64_intdigest(text) == xxhash.xxh64_intdigest(text)
    assert xxh64_intdigest(text) == xxh64_intdigest(text.encode())


def test_incremental_equals_one_shot():
    rng = random.Random(5)
    data = bytes(rng.getrandbits(8) for _ in range(300))
    for cut in (0, 1, 31, 32, 33, 150, 300):
        h = xxh64(seed=3)
        h.update(data[:cut])
        h.update(data[cut:])
        assert h.intdigest() == xxh64_intdigest(data, 3)
        assert h.intdigest() == xxhash.xxh64_intdigest(data, seed=3)


@pytest.mark.parametrize("parent", [None, 0xDEADBEEF12345678, 17,
                                    "meta-llama/Llama-3-8B|", "ns|adapter"])
@pytest.mark.parametrize("n_tokens", [1, 4, 64])
def test_chain_hash_equals_jax(parent, n_tokens):
    tokens = tuple(range(1000, 1000 + n_tokens))
    assert (BlockAllocator.chain_hash(parent, tokens)
            == JaxAllocator.chain_hash(parent, tokens))


def test_chain_hash_chains_like_jax():
    h = j = "tiny-llama|"
    for i in range(8):
        block = tuple(range(64 * i, 64 * i + 64))
        h, j = (BlockAllocator.chain_hash(h, block),
                JaxAllocator.chain_hash(j, block))
        assert h == j


@pytest.mark.parametrize("salt", [None, "", "adapter-a"])
def test_chunk_hashes_equal_jax(salt):
    text = "the pages of every layer stay resident on the card é " * 11
    got = controller.chunk_hashes(text, salt=salt)
    assert got == jax_controller.chunk_hashes(text, salt=salt)
    assert len(got) == -(-len(text) // controller.CHUNK_SIZE)


def test_path_keys_and_digest_equal_jax():
    hashes = controller.chunk_hashes("x" * 1000)
    keys = controller.path_keys(hashes)
    assert keys == jax_controller.path_keys(hashes)
    assert (controller.claim_digest(set(keys))
            == jax_controller.claim_digest(set(keys)))
    assert controller.L3_INSTANCE == jax_controller.L3_INSTANCE
