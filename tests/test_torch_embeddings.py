"""Pooled embeddings in the torch port against the JAX engine and server:
``EngineCore.embed`` (the mean-pooled, L2-normalised final hidden state
of one prefill on a throwaway one-page pool) equals the JAX engine's at
1e-5 in float32 for tiny-llama, tiny-opt and tiny-mixtral on the same
weights, and leaves the serving pool untouched; the bodies of
``/v1/embeddings`` (strings, one id list, id lists), ``/v1/score``
(``text_1`` broadcast or paired) and ``/v1/rerank`` equal the JAX
server's within that tolerance, errors included."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_engine import Pair
from test_torch_n_sampling import ServerPair

torch.set_num_threads(1)

TOL = 1e-5
ARCHS = ["tiny-llama", "tiny-opt", "tiny-mixtral"]


@pytest.mark.parametrize("model", ARCHS)
def test_embed_matches_jax(model):
    pair = Pair(model=model)
    try:
        pool = [p.clone() for p in pair.torch.kv]
        for ids in ([5, 6, 7], list(range(40, 77)), [600, 3, 9999],
                    list(range(1, 200))):
            got = np.asarray(pair.torch.embed(ids))
            want = np.asarray(pair.jax.embed(ids))
            assert got.shape == (pair.torch.model_config.hidden_size,)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            assert abs(np.linalg.norm(got) - 1.0) < 1e-5
        # Embeddings never write the serving pool.
        for before, after in zip(pool, pair.torch.kv):
            assert torch.equal(before, after)
    finally:
        pair.stop()


def _call(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _close(got, want):
    """Equal JSON, floats within TOL; ids and timestamps aside."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            if k not in ("id", "created"):
                _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (got, want)
    else:
        assert got == want


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-opt"])
def servers(request):
    p = ServerPair(model=request.param)
    yield p
    p.stop()


@pytest.mark.parametrize("path,body", [
    ("/v1/embeddings", {"input": "hello pooled world"}),
    ("/v1/embeddings", {"input": ["one text", "another", "one text"],
                        "model": "whatever"}),
    ("/v1/embeddings", {"input": [3, 4, 5, 6, 7]}),
    ("/v1/embeddings", {"input": [[3, 4, 5], [9, 9]]}),
    ("/v1/score", {"text_1": "the query", "text_2": ["a doc", "the query",
                                                     "b doc"]}),
    ("/v1/score", {"text_1": ["x one", "y two"], "text_2": ["x one", "z"]}),
    ("/score", {"text_1": "q", "text_2": "q"}),
    ("/v1/score", {"text_1": ["a", "b"], "text_2": ["a", "b", "c"]}),
    ("/v1/score", {"text_1": 3, "text_2": "x"}),
    ("/v1/rerank", {"query": "alpha beta", "documents": [
        "gamma", {"text": "alpha beta"}, "alpha"], "top_n": 2}),
    ("/rerank", {"query": "q", "documents": ["q", "r"]}),
    ("/v1/rerank", {"query": "q", "documents": []}),
    ("/v1/rerank", {"query": "q", "documents": ["q"], "top_n": "two"}),
])
def test_bodies_equal_the_jax_server(servers, path, body):
    got = _call(servers.port, path, body)
    want = _call(servers.ref, path, body)
    assert got[0] == want[0]
    _close(got[1], want[1])
    if got[0] == 200 and "score" in path:
        for d in got[1]["data"]:
            assert -1.0 - TOL <= d["score"] <= 1.0 + TOL
