"""The port's standalone GPipe schedule and ring attention against the JAX
package's, over rank processes (the ``Ranks`` harness of
``tests/test_torch_tp.py``: groups of 2 and 4 gloo ranks, spawned once a
module). The JAX side runs here, on the conftest's 8-device CPU mesh.

- ``pipeline_forward`` at pp 2 and 4 equals JAX ``pipeline_forward`` and
  ``reference_forward`` (the MLP and transformer-like layers of
  ``tests/test_pipeline.py``), float32 within 1e-5, on every rank;
- ``make_ring_attention`` at sp 2 and 4 equals JAX
  ``make_ring_attention`` (the MHA, GQA and MQA cases of
  ``tests/test_ring_attention.py``) within 1e-5, is causal across
  chunks, and holds bf16 inputs near the float32 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from production_stack_tpu.parallel import pipeline as jpipeline
from production_stack_tpu.parallel.ring_attention import (
    make_ring_attention as jax_ring,
)
from production_stack_tpu.parallel.ring_attention import (
    reference_causal_attention as jax_reference_attention,
)
from production_stack_tpu_torch.parallel.pipeline import (
    reference_forward,
)
from production_stack_tpu_torch.parallel.ring_attention import (
    reference_causal_attention,
)
from test_torch_tp import Ranks

torch.set_num_threads(1)

TOL = 1e-5

# The layers of tests/test_pipeline.py, in both packages.
_LAYERS = r"""
def mlp_layer(x, p):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def transformer_layer(x, p):  # x: [T, d]
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    a = torch.softmax(q @ k.T / (x.shape[-1] ** 0.5), dim=-1)
    return x + a @ v


LAYERS = {"mlp": mlp_layer, "transformer": transformer_layer}
"""

_WORKER = r"""
import base64, pickle, sys, traceback
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from production_stack_tpu_torch.parallel import multihost
from production_stack_tpu_torch.parallel.pp import PPGroup
from production_stack_tpu_torch.parallel.pipeline import (
    pipeline_forward, stage_params)
from production_stack_tpu_torch.parallel.ring_attention import (
    make_ring_attention)

env = multihost.initialize_from_env()
rank, size = env["process_id"], env["num_processes"]
""" + _LAYERS + r"""


def pipeline_job(job):
    group = PPGroup.create(list(range(size)), torch.device("cpu"))
    params = {k: torch.from_numpy(v) for k, v in job["params"].items()}
    local = stage_params(params, group.stage, size)
    run = pipeline_forward(LAYERS[job["layer"]], group)
    out = run(local, torch.from_numpy(job["x"]))
    return {"out": out.numpy(), "counters": group.counters(),
            "layers": next(iter(local.values())).shape[0]}


def ring_job(job):
    group = PPGroup.create(list(range(size)), torch.device("cpu"))
    run = make_ring_attention(group, job["scale"])
    q, k, v = (torch.from_numpy(job[n]) for n in "qkv")
    if job.get("bf16"):
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = run(q, k, v).float().numpy()
    return {"out": out, "counters": group.counters()}


RUN = {"pipeline": pipeline_job, "ring": ring_job}
for line in sys.stdin:
    job = pickle.loads(base64.b64decode(line))
    if job is None:
        break
    try:
        out = {"ok": RUN[job["kind"]](job)}
    except BaseException:
        out = {"error": traceback.format_exc()}
    sys.stdout.write("RESULT " + base64.b64encode(pickle.dumps(out)).decode()
                     + "\n")
    sys.stdout.flush()
multihost.shutdown(None)
"""

_ns: dict = {"torch": torch}
exec(_LAYERS, _ns)  # the same layer functions on this side


@pytest.fixture(scope="module")
def ranks():
    groups = {2: Ranks(2, _WORKER), 4: Ranks(4, _WORKER)}
    yield groups
    for g in groups.values():
        g.close()


def _mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _jax_mlp(x, p):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def _jax_transformer(x, p):
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    a = jax.nn.softmax(q @ k.T / jnp.sqrt(x.shape[-1]), axis=-1)
    return x + a @ v


def _mlp_params(L, d, hidden, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((L, d, hidden)) * 0.2).astype(np.float32),
        "b1": rng.standard_normal((L, hidden)).astype(np.float32),
        "w2": (rng.standard_normal((L, hidden, d)) * 0.2).astype(np.float32),
    }


def _transformer_params(L, d, seed=2):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((L, d, d)) * 0.2).astype(np.float32)
            for k in ("wq", "wk", "wv")}


@pytest.mark.parametrize("layer,pp,L,M", [
    ("mlp", 2, 4, 3),  # 2 stages, uneven microbatches
    ("mlp", 4, 8, 8),
    ("mlp", 4, 4, 5),  # one layer a stage
    ("transformer", 2, 8, 4),
    ("transformer", 4, 8, 4)])
def test_pipeline_matches_jax_and_sequential(ranks, layer, pp, L, M):
    if layer == "mlp":
        params, x = _mlp_params(L, 16, 32), (6, 16)
    else:
        params, x = _transformer_params(L, 16), (8, 16)
    x = np.random.default_rng(1).standard_normal((M,) + x).astype(
        np.float32)
    jfn = _jax_mlp if layer == "mlp" else _jax_transformer
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jax_out = np.asarray(jpipeline.pipeline_forward(jfn, _mesh(pp, "pp"))(
        jparams, jnp.asarray(x)))
    jax_ref = np.asarray(jpipeline.reference_forward(jfn)(
        jparams, jnp.asarray(x)))
    res = ranks[pp].run({"kind": "pipeline", "layer": layer,
                         "params": params, "x": x})
    ref = reference_forward(_ns["LAYERS"][layer])(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ref, jax_ref, rtol=TOL, atol=TOL)
    for stage, r in enumerate(res):
        assert r["layers"] == L // pp
        np.testing.assert_array_equal(r["out"], res[0]["out"])
        np.testing.assert_allclose(r["out"], jax_out, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["out"], ref, rtol=TOL, atol=TOL)
        c = r["counters"]
        assert c["sends_total"] == (0 if stage == pp - 1 else M)
        assert c["recvs_total"] == (0 if stage == 0 else M)
        assert c["shares_total"] == 1


def _qkv(B, T, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KVH, D)).astype(np.float32),
            rng.standard_normal((B, T, KVH, D)).astype(np.float32))


@pytest.mark.parametrize("sp,T,H,KVH,D", [
    (4, 64, 4, 4, 16),  # MHA
    (4, 64, 8, 2, 16),  # GQA 4:1
    (2, 32, 4, 1, 8),   # MQA
])
def test_ring_matches_jax(ranks, sp, T, H, KVH, D):
    q, k, v = _qkv(2, T, H, KVH, D, seed=0)
    scale = 1.0 / D ** 0.5
    jax_out = np.asarray(jax_ring(_mesh(sp, "sp"), "sp", scale=scale)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    res = ranks[sp].run({"kind": "ring", "q": q, "k": k, "v": v,
                         "scale": scale})
    ref = reference_causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=scale).numpy()
    jref = np.asarray(jax_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale))
    np.testing.assert_allclose(ref, jref, rtol=TOL, atol=TOL)
    for r in res:
        np.testing.assert_array_equal(r["out"], res[0]["out"])
        np.testing.assert_allclose(r["out"], jax_out, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["out"], ref, rtol=TOL, atol=TOL)
        # sp - 1 rotations of K and V each.
        assert r["counters"]["sends_total"] == 2 * (sp - 1)


def test_ring_causality(ranks):
    """Changing future tokens does not change earlier outputs."""
    q, k, v = _qkv(1, 32, 2, 2, 8, seed=1)
    out1 = ranks[4].run({"kind": "ring", "q": q, "k": k, "v": v,
                         "scale": 0.35})[0]["out"]
    k2, v2 = k.copy(), v.copy()
    k2[:, 16:] = 0.0
    v2[:, 16:] = 0.0
    out2 = ranks[4].run({"kind": "ring", "q": q, "k": k2, "v": v2,
                         "scale": 0.35})[0]["out"]
    np.testing.assert_allclose(out1[:, :16], out2[:, :16], rtol=TOL,
                               atol=TOL)
    assert not np.allclose(out1[:, 16:], out2[:, 16:])


def test_ring_bf16_stable(ranks):
    q, k, v = _qkv(1, 64, 4, 4, 32, seed=2)
    scale = 1.0 / 32 ** 0.5
    out = ranks[2].run({"kind": "ring", "q": q, "k": k, "v": v,
                        "scale": scale, "bf16": True})[0]["out"]
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jax_out = np.asarray(jax_ring(_mesh(2, "sp"), "sp", scale=scale)(
        *bf).astype(jnp.float32))
    ref = reference_causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=scale).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(out, jax_out, rtol=5e-2, atol=5e-2)
