"""The port's KV wire formats and offload store (``kv/offload.py``)
against the JAX package's:

- a TKV2 transfer payload packs to the JAX package's bytes, bf16 (built
  with ``ml_dtypes`` here) and int8 ``(data, scales)`` alike, and each
  package unpacks the other's; blocks (``.npz``) likewise;
- ``HostKVStore``: LRU by bytes, hits and misses;
- the remote tier against the JAX cache server (aiohttp) served in this
  process: spills land there, a second store fetches them back bit for
  bit, and a block still in flight is uploaded only once it is ready."""

import asyncio
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.kv import offload as jax_offload
from production_stack_tpu.kv.cache_server import CacheServer
from production_stack_tpu_torch.kv import offload

torch.set_num_threads(1)

L, BS, KVH, D, N = 2, 4, 2, 8, 3


class AioThread:
    """An aiohttp app (built by ``make_app()`` on the thread's own event
    loop) served on 127.0.0.1 at a free port; ``url`` is its base."""

    def __init__(self, make_app):
        from aiohttp import web

        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        async def start():
            runner = web.AppRunner(make_app())
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            return runner, site._server.sockets[0].getsockname()[1]

        def serve():
            asyncio.set_event_loop(self.loop)
            self.runner, port = self.loop.run_until_complete(start())
            self.url = f"http://127.0.0.1:{port}"
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()
        assert ready.wait(60)

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


def _pages(rng, encoding, lead=(N, L)):
    """(k, v) as (numpy for JAX, torch for the port), bit-equal:
    [*lead, BS, KVH, D] bf16, or int8 data with [*lead, BS*KVH] f32
    scales."""
    def one():
        if encoding == "bf16":
            bits = rng.integers(0, 2 ** 16, size=lead + (BS, KVH, D),
                                dtype=np.uint16)
            bits &= 0x7F7F  # finite values only
            return (bits.view(ml_dtypes.bfloat16),
                    torch.from_numpy(bits.copy()).view(torch.bfloat16))
        data = rng.integers(-127, 128, size=lead + (BS, KVH, D),
                            dtype=np.int8)
        scales = rng.random(lead + (BS * KVH,), dtype=np.float32)
        return ((data, scales),
                (torch.from_numpy(data.copy()), torch.from_numpy(scales)))

    (jk, tk), (jv, tv) = one(), one()
    return (jk, jv), (tk, tv)


def _bits(x):
    if isinstance(x, (tuple, list)):
        return [b for e in x for b in _bits(e)]
    if isinstance(x, torch.Tensor):
        return [x.contiguous().view(torch.uint8).numpy().tobytes()]
    return [np.ascontiguousarray(x).view(np.uint8).tobytes()]


@pytest.mark.parametrize("encoding", ["bf16", "int8"])
def test_transfer_payload_bytes_equal_jax(encoding):
    (jk, jv), (tk, tv) = _pages(np.random.default_rng(0), encoding)
    hashes = [11, 2 ** 63 + 5, 7]
    want = jax_offload.pack_transfer(hashes, N * BS, jk, jv)
    assert offload.pack_transfer(hashes, N * BS, tk, tv) == want
    got = b"".join(bytes(b) for b in offload.pack_transfer_buffers(
        hashes, N * BS, tk, tv))
    assert got == want


@pytest.mark.parametrize("encoding", ["bf16", "int8"])
def test_each_package_unpacks_the_others_transfer(encoding):
    (jk, jv), (tk, tv) = _pages(np.random.default_rng(1), encoding)
    hashes = [3, 4, 5]
    port = offload.unpack_transfer(jax_offload.pack_transfer(
        hashes, N * BS, jk, jv))
    assert port["hashes"] == hashes and port["num_tokens"] == N * BS
    assert _bits(port["k"]) == _bits(jk) and _bits(port["v"]) == _bits(jv)
    if encoding == "bf16":
        assert port["k"].dtype == torch.bfloat16
    jax = jax_offload.unpack_transfer(offload.pack_transfer(
        hashes, N * BS, tk, tv))
    assert jax["hashes"] == hashes
    assert _bits(jax["k"]) == _bits(tk) and _bits(jax["v"]) == _bits(tv)


@pytest.mark.parametrize("encoding", ["bf16", "int8"])
def test_each_package_unpacks_the_others_block(encoding):
    (jk, jv), (tk, tv) = _pages(np.random.default_rng(2), encoding,
                                lead=(L,))
    k, v = offload.unpack_block(jax_offload.pack_block(jk, jv))
    assert _bits(k) == _bits(jk) and _bits(v) == _bits(jv)
    assert isinstance(k, tuple) == (encoding == "int8")
    k, v = jax_offload.unpack_block(offload.pack_block(tk, tv))
    assert _bits(k) == _bits(tk) and _bits(v) == _bits(tv)


def test_unpack_transfer_refuses_a_short_or_foreign_payload():
    (_, _), (tk, tv) = _pages(np.random.default_rng(3), "bf16")
    payload = offload.pack_transfer([1, 2, 3], N * BS, tk, tv)
    with pytest.raises(ValueError):
        offload.unpack_transfer(payload[:-1])
    with pytest.raises(ValueError):
        offload.unpack_transfer(b"PK\x03\x04" + payload[4:])


def _block(value: float):
    return (torch.full((L, BS, KVH, D), value),
            torch.full((L, BS, KVH, D), -value))


def test_host_store_is_lru_by_bytes():
    k, v = _block(1.0)
    size = 2 * k.numel() * k.element_size()
    store = offload.HostKVStore(2 * size)
    store.put(1, *_block(1.0))
    store.put(2, *_block(2.0))
    assert store.get(1)[0][0, 0, 0, 0] == 1.0  # 1 is now the newest
    store.put(3, *_block(3.0))  # evicts 2, the least recent
    assert not store.contains(2)
    assert store.contains(1) and store.contains(3)
    assert store.get(2) is None
    s = store.stats()
    assert (s["blocks"], s["bytes"], s["hits"], s["misses"], s["stored"],
            s["evicted"]) == (2, 2 * size, 1, 1, 3, 1)
    store.put(3, *_block(9.0))  # already stored: kept as it was
    assert store.get(3)[0][0, 0, 0, 0] == 3.0
    store.close()


@pytest.fixture
def cache_server():
    srv = AioThread(lambda: CacheServer(64 << 20).make_app())
    yield srv
    srv.stop()


@pytest.mark.parametrize("encoding", ["bf16", "int8"])
def test_remote_spill_and_fetch_against_the_jax_cache_server(
        cache_server, encoding):
    rng = np.random.default_rng(4)
    blocks = {}
    for h in (101, 102, 103):
        _, (tk, tv) = _pages(rng, encoding, lead=(L,))
        blocks[h] = (tk, tv)
    one = sum(len(b) for b in _bits(blocks[101]))
    released = threading.Event()
    uploads_before_ready = []

    def ready():
        uploads_before_ready.append(released.is_set())
        released.wait(10)

    spiller = offload.HostKVStore(one, cache_server.url)
    spiller.put(101, *blocks[101], ready=ready)
    spiller.put(102, *blocks[102])  # evicts 101 to the remote tier
    spiller.put(103, *blocks[103])  # evicts 102
    assert not spiller.flush_remote(timeout=0.3)  # 101 is not ready yet
    released.set()
    assert spiller.flush_remote(timeout=10)
    assert uploads_before_ready == [False]
    s = spiller.stats()
    assert s["remote_put_blocks"] == 2 and s["blocks"] == 1
    # The JAX client reads what the port uploaded.
    raw = jax_offload.RemoteKVClient(cache_server.url).get(102)
    assert _bits(jax_offload.unpack_block(raw)) == _bits(blocks[102])

    fetcher = offload.HostKVStore(0, cache_server.url)
    assert fetcher.contains(101) and not fetcher.contains(103)
    for h in (101, 102):
        assert _bits(fetcher.get(h)) == _bits(blocks[h])
    assert fetcher.get(103) is None
    s = fetcher.stats()
    assert (s["hits"], s["misses"], s["remote_get_blocks"]) == (2, 1, 2)
    assert s["remote_get_bytes"] > 0
    # A remote-only store ships a block straight up.
    fetcher.put(104, *blocks[103])
    assert fetcher.flush_remote(timeout=10)
    assert fetcher.stats()["remote_put_blocks"] == 1
    spiller.close()
    fetcher.close()
