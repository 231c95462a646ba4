"""LoRA hot-swap in the torch port against the JAX engine and server.

- ``prng.normal`` against ``jax.random.normal`` (float32): the uniform
  draw is bit-equal and ``erf_inv`` is XLA's polynomial, so the two agree
  to a few ulps (XLA's CPU ``log`` is one ulp off the correctly rounded
  one for some inputs);
- a name-only adapter (``load_lora_adapter(name)``, what the server's
  ``/v1/load_lora_adapter`` does) writes the JAX engine's slot: its A
  matrices from ``crc32(name)``, zero B, scaling ``alpha / rank``; its
  greedy and seeded streams equal the JAX engine's (and, B being zero,
  the base model's);
- explicit weights change the stream as the JAX engine's do, unloading
  restores the base stream, a full set of slots refuses the next
  adapter, and an adapter's prefix-cache root stays apart from the base
  model's;
- over HTTP against the JAX server on the same weights: ``model=<adapter>``,
  ``/v1/lora_adapters``, ``/v1/models``, ``tpu:lora_requests_total`` and
  the 404 of an unknown model."""

import json
import queue
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.sampling import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu_torch.engine import prng
from production_stack_tpu_torch.engine.sampling import SamplingParams

from test_torch_engine import Pair
from test_torch_n_sampling import ServerPair

torch.set_num_threads(1)

# float32 ulps between prng.normal and jax.random.normal.
NORMAL_ULPS = 3


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("name,shape", [
    ("my-adapter", (2, 128, 16)), ("sql-lora", (4, 64, 8)),
    ("x", (3, 1000)), ("", (7,))])
def test_normal_matches_jax_random_normal(name, shape):
    seed = zlib.crc32(name.encode()) % (2 ** 31)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.float32))
    got = prng.normal(prng.key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    ulps = _ulps(got.numpy(), want)
    assert ulps.max() <= NORMAL_ULPS
    assert (ulps > 0).mean() < 0.02  # nearly all bit-equal


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv(x)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    # At +-1 XLA returns x times the largest float32, and so does the port.
    assert (got[:2].abs() == torch.finfo(torch.float32).max).all()
    assert _ulps(got.numpy(), want).max() <= NORMAL_ULPS


_ids = iter(range(10 ** 9))


def _run(engine, reqs, timeout=240):
    """Streams of ``[(prompt, sampling, adapter name)]``, all added in
    one critical section."""
    queues = []
    with engine._lock:
        for prompt, sp, adapter in reqs:
            q: "queue.Queue" = queue.Queue()
            engine.add_request(f"lr{next(_ids)}", prompt, sp,
                               lambda t, f, q=q: q.put((t, f)),
                               adapter_name=adapter)
            queues.append(q)
    out = []
    deadline = time.time() + timeout
    for q in queues:
        tokens = []
        while True:
            t, f = q.get(timeout=max(deadline - time.time(), 1))
            if t is not None:
                tokens.append(t if isinstance(t, int) else t[0])
            if f is not None:
                out.append((tokens, f))
                break
    return out


def _both(pair, reqs):
    """Streams of both engines; ``reqs`` hold SamplingParams kwargs."""
    return (_run(pair.jax, [(p, JaxSamplingParams(**s), a)
                            for p, s, a in reqs]),
            _run(pair.torch, [(p, SamplingParams(**s), a)
                              for p, s, a in reqs]))


GREEDY = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
SEEDED = dict(temperature=0.8, top_p=0.9, seed=77, max_tokens=12,
              ignore_eos=True)


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.stop()


def _slot(tree, slot):
    return {k: np.asarray(v)[:, slot] if k != "scaling" else
            np.asarray(v)[slot] for k, v in tree.items()}


def test_name_only_adapter_is_the_jax_engines(pair):
    assert pair.jax.load_lora_adapter("my-adapter", rank=8)
    assert pair.torch.load_lora_adapter("my-adapter", rank=8)
    slot = pair.torch.lora_slots["my-adapter"]
    assert slot == pair.jax.lora_slots["my-adapter"] == 1
    want = _slot(pair.jax.params["lora"], slot)
    got = _slot({k: v.numpy() for k, v in pair.torch.params["lora"].items()},
                slot)
    for key in ("wq_a", "wv_a"):
        assert np.abs(got[key]).max() > 0
        assert _ulps(got[key], want[key]).max() <= NORMAL_ULPS
    for key in ("wq_b", "wv_b"):
        assert not got[key].any() and not want[key].any()
    assert got["scaling"] == want["scaling"] == np.float32(16.0 / 8)
    prompt = list(range(40, 58))
    want, got = _both(pair, [(prompt, GREEDY, "my-adapter"),
                             (prompt, SEEDED, "my-adapter"),
                             (prompt, GREEDY, None)])
    assert got == want
    # Zero B: the adapter's delta is zero, as in the JAX engine.
    assert got[0] == got[2]
    assert pair.jax.unload_lora_adapter("my-adapter")
    assert pair.torch.unload_lora_adapter("my-adapter")
    assert not pair.torch.unload_lora_adapter("my-adapter")


def test_explicit_weights_change_the_stream_and_unload_restores(pair):
    lora = pair.torch.params["lora"]
    rng = np.random.default_rng(3)
    weights = {k: (0.3 * rng.normal(size=(v.shape[0],) + tuple(v.shape[2:]))
                   ).astype(np.float32)
               for k, v in lora.items() if k != "scaling"}
    prompt = list(range(70, 90))
    base_want, base_got = _both(pair, [(prompt, GREEDY, None)])
    assert pair.jax.load_lora_adapter("explicit", weights=weights)
    assert pair.torch.load_lora_adapter("explicit", weights=weights)
    slot = pair.torch.lora_slots["explicit"]
    np.testing.assert_array_equal(lora["wq_b"][:, slot].numpy(),
                                  weights["wq_b"])
    want, got = _both(pair, [(prompt, GREEDY, "explicit"),
                             (prompt, SEEDED, "explicit")])
    assert got == want
    assert got[0] != base_got[0]
    assert pair.torch.unload_lora_adapter("explicit")
    assert pair.jax.unload_lora_adapter("explicit")
    assert float(lora["scaling"][slot]) == 0.0
    want, got = _both(pair, [(prompt, GREEDY, None)])
    assert got == want == base_want


def test_full_slots_refuse_the_next_adapter(pair):
    names = [f"full-{i}" for i in range(3)]  # max_loras 4: slots 1-3
    for eng in (pair.jax, pair.torch):
        for name in names:
            assert eng.load_lora_adapter(name)
        assert eng.load_lora_adapter(names[0])  # already loaded
        assert not eng.load_lora_adapter("one-too-many")
    assert pair.torch.lora_slots == pair.jax.lora_slots
    for eng in (pair.jax, pair.torch):
        for name in names:
            assert eng.unload_lora_adapter(name)
    assert pair.torch.lora_slots == {}


def test_adapter_prefix_cache_root_is_apart(pair):
    """A prompt served by the base model, then under an adapter: the
    adapter's chain hashes start from its own root, so nothing of the
    base model's pages is a hit for it (in both engines)."""
    for eng in (pair.jax, pair.torch):
        assert eng.load_lora_adapter("apart")
    prompt = list(range(120, 152))  # eight full 4-token pages
    c0 = (pair.jax.cached_tokens_total, pair.torch.cached_tokens_total)
    want, got = _both(pair, [(prompt, GREEDY, None)])
    assert got == want
    want, got = _both(pair, [(prompt, GREEDY, "apart")])
    assert got == want
    assert (pair.jax.cached_tokens_total, pair.torch.cached_tokens_total) \
        == c0
    want, got = _both(pair, [(prompt + [5], GREEDY, "apart")])
    assert got == want
    assert pair.torch.cached_tokens_total - c0[1] == 32
    assert pair.jax.cached_tokens_total - c0[0] == 32
    for eng in (pair.jax, pair.torch):
        assert eng.unload_lora_adapter("apart")


def test_no_slots_without_max_loras():
    p = Pair(max_loras=0)
    try:
        assert "lora" not in p.torch.params
        assert not p.torch.load_lora_adapter("x")
        assert not p.jax.load_lora_adapter("x")
    finally:
        p.stop()


# -- over HTTP, against the JAX server --------------------------------------

def _call(base, path, body=None):
    """(status, JSON body); GET without a body."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw, status = e.read().decode(), e.code
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw


@pytest.fixture(scope="module")
def servers():
    p = ServerPair(max_loras=4)
    yield p
    p.stop()


def _both_http(servers, path, body=None):
    return _call(servers.port, path, body), _call(servers.ref, path, body)


def _lora_lines(metrics):
    return sorted(line for line in metrics.splitlines()
                  if "lora_requests" in line)


def test_http_adapter_surface_equals_the_jax_server(servers):
    got, want = _both_http(servers, "/v1/load_lora_adapter",
                           {"lora_name": "web-adapter"})
    assert got == want == (200, {"status": "ok", "lora_name": "web-adapter"})
    got, want = _both_http(servers, "/v1/load_lora_adapter", {})
    assert got == want and got[0] == 400
    got, want = _both_http(servers, "/v1/lora_adapters")
    assert got == want
    assert got[1]["adapters"] == [{"lora_name": "web-adapter", "slot": 1}]
    assert (got[1]["max_loras"], got[1]["capacity"]) == (4, 3)
    got, want = _both_http(servers, "/v1/models")

    def ids(out):
        return [(m["id"], m.get("parent")) for m in out[1]["data"]]

    assert ids(got) == ids(want) == [("tiny-llama", None),
                                     ("web-adapter", "tiny-llama")]
    body = {"model": "web-adapter", "prompt": "hello adapter",
            "max_tokens": 8, "temperature": 0}
    got, want = _both_http(servers, "/v1/completions", body)
    assert got[0] == want[0] == 200
    assert got[1]["choices"] == want[1]["choices"]
    assert got[1]["model"] == want[1]["model"] == "web-adapter"
    got, want = _both_http(servers, "/v1/chat/completions", {
        "model": "web-adapter", "max_tokens": 4, "temperature": 0,
        "messages": [{"role": "user", "content": "hi"}]})
    assert got[1]["choices"] == want[1]["choices"]
    mine = urllib.request.urlopen(servers.port + "/metrics").read().decode()
    ref = urllib.request.urlopen(servers.ref + "/metrics").read().decode()
    assert _lora_lines(mine) == _lora_lines(ref) == [
        '# TYPE tpu:lora_requests counter',
        'tpu:lora_requests_total{model_name="tiny-llama",'
        'adapter="web-adapter"} 2']
    got, want = _both_http(servers, "/v1/completions",
                           dict(body, model="no-such-model"))
    assert got == want
    assert got[0] == 404 and got[1]["error"]["type"] == "NotFoundError"
    got, want = _both_http(servers, "/v1/unload_lora_adapter",
                           {"lora_name": "web-adapter"})
    assert got == want == (200, {"status": "ok",
                                 "lora_name": "web-adapter"})
    got, want = _both_http(servers, "/v1/unload_lora_adapter",
                           {"lora_name": "web-adapter"})
    assert got == want and got[0] == 400
    got, want = _both_http(servers, "/v1/completions", body)
    assert got == want and got[0] == 404
