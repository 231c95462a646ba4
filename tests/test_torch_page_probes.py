"""The port's page probes (``production_stack_tpu_torch/probes/``) against
the JAX package's Pallas probes in ``benchmarks/``, on the CPU, from the
same numpy inputs.

The JAX scripts keep their shapes in module constants; each test loads
them by path, patches the constants to a small size and runs the Pallas
kernels in interpret mode. Tolerances, of the largest |value| of the JAX
result: ``dma_only`` and ``reads`` 1e-6 (the same float32 sums of
exactly representable page values, in another order); ``dots`` 1e-5
(float32 products of 128 and then 16-64 terms, summed in another order).

The CUDA kernels cannot run here (no nvcc, no card);
tests/test_torch_kernels_cuda.py and chip_smoke.py hold them against
these same plain versions on an H100."""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from production_stack_tpu_torch.probes import kernel_dma_only as tdma
from production_stack_tpu_torch.probes import kernel_probe_strided as tstr

torch.set_num_threads(1)

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
SMALL = dict(B=2, MAXB=8, NB=20, L=2, bs=8, KVH=8, D=128)
GATHER_TOL = 1e-6
DOTS_TOL = 1e-5
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    return _load("kernel_dma_only"), _load("kernel_probe_strided")


def _patch(monkeypatch, mods, shape):
    for mod in mods:
        for key, value in shape.items():
            monkeypatch.setattr(mod, key, value)


def _values(rng, shape, dtype):
    """Page values exactly representable in ``dtype``, as float32."""
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.float32)
    x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if dtype == "bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _inputs(shape, ctx, dtype, seed):
    """Pages, tables (with repeats, as the JAX scripts draw them) and
    context lengths, as numpy."""
    rng = np.random.default_rng(seed)
    s = shape
    pool = (s["L"], s["NB"], s["bs"], s["KVH"], s["D"])
    k = _values(rng, pool, dtype)
    v = _values(rng, pool, dtype)
    bt = rng.integers(0, s["NB"], (s["B"], s["MAXB"])).astype(np.int32)
    q = _values(rng, (s["B"], s["KVH"] * 8, s["D"]), "bf16")
    return q, k, v, bt, np.asarray(ctx, np.int32)


def _jax(q, k, v, bt, cl, dtype):
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, JNP[dtype]),
            jnp.asarray(v, JNP[dtype]), jnp.asarray(bt), jnp.asarray(cl))


def _torch(q, k, v, bt, cl, dtype):
    return (torch.from_numpy(q).bfloat16(), torch.from_numpy(k).to(
        TORCH[dtype]), torch.from_numpy(v).to(TORCH[dtype]),
        torch.from_numpy(bt), torch.from_numpy(cl))


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    bar = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= bar, (err, bar)


def _dma(jax_probes, monkeypatch, shape, ctx, dtype, P, seed):
    jdma, jstr = jax_probes
    _patch(monkeypatch, (jdma, jstr), shape)
    q, k, v, bt, cl = _inputs(shape, ctx, dtype, seed)
    _, jk, jv, jbt, jcl = _jax(q, k, v, bt, cl, dtype)
    _, tk, tv, tbt, tcl = _torch(q, k, v, bt, cl, dtype)
    before = getattr(tdma.dma_only, f"launches_{dtype}")
    for layer in range(shape["L"]):
        with pltpu.force_tpu_interpret_mode():
            want = jdma.dma_only(jk, jv, jbt, jcl, layer, pages_per_block=P)
        got = tdma.dma_only(tk, tv, tbt, tcl, layer, pages_per_block=P)
        assert got.shape == (8, shape["D"]) and got.dtype == torch.float32
        _close(got, want, GATHER_TOL)
    # A CPU tensor takes the plain version and counts no launch.
    assert getattr(tdma.dma_only, f"launches_{dtype}") == before


def _strided(jax_probes, monkeypatch, shape, ctx, mode, P, seed):
    jdma, jstr = jax_probes
    _patch(monkeypatch, (jdma, jstr), shape)
    q, k, v, bt, cl = _inputs(shape, ctx, "bf16", seed)
    with pltpu.force_tpu_interpret_mode():
        want = jstr.build(mode, P)(*_jax(q, k, v, bt, cl, "bf16"))
    before = getattr(tstr.probe_strided, f"launches_{mode}_bf16")
    got = tstr.build(mode, P)(*_torch(q, k, v, bt, cl, "bf16"))
    assert got.shape == (1, 8) and got.dtype == torch.float32
    _close(got, want, GATHER_TOL if mode == "reads" else DOTS_TOL)
    assert getattr(tstr.probe_strided, f"launches_{mode}_bf16") == before


def _jax_layer_output(jstr, mode, P, shape, q, k, v, bt, cl, layer):
    """One layer's full ``o [B, KVH*G, D]`` of the JAX probe: its own
    ``_kernel`` under the ``pallas_call`` of its ``build``, which keeps
    only ``o[0, 0, :8]``."""
    B, D, KVH = shape["B"], shape["D"], shape["KVH"]
    R = KVH * jstr.G
    nc = shape["MAXB"] // P
    return pl.pallas_call(
        functools.partial(jstr._kernel, pages_per_block=P, mode=mode),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(B, nc),
            in_specs=[
                pl.BlockSpec((1, R, D), lambda b, c, bt, cl, lr: (b, 0, 0)),
                pl.BlockSpec(memory_space=pl.ANY),
                pl.BlockSpec(memory_space=pl.ANY),
            ],
            out_specs=pl.BlockSpec((1, R, D),
                                   lambda b, c, bt, cl, lr: (b, 0, 0)),
            scratch_shapes=[
                pltpu.VMEM((jstr.RING, P, shape["bs"], KVH, D),
                           jnp.bfloat16),
                pltpu.VMEM((jstr.RING, P, shape["bs"], KVH, D),
                           jnp.bfloat16),
                pltpu.SemaphoreType.DMA((jstr.RING, 2, P)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((B, R, D), jnp.float32),
    )(bt, cl, jnp.asarray(layer, jnp.int32).reshape(1), q, k, v)


@pytest.mark.parametrize("mode", ["reads", "dots"])
@pytest.mark.parametrize("P,ctx", [(2, [1, 16, 23, 0]), (2, [0, 1, 16, 23]),
                                   (4, [50, 37]), (8, [37, 50])],
                         ids=["P2-1-16-23-0", "P2-0-1-16-23", "P4-50-37",
                              "P8-37-50"])
def test_probe_strided_layer_output_matches_pallas(jax_probes, monkeypatch,
                                                   mode, P, ctx):
    """Every row of one layer's output, every sequence and kv head, so
    the plain version's h*G row mapping is held against the TPU kernel,
    not only the checksum's o[0, 0, :8]."""
    jdma, jstr = jax_probes
    shape = dict(SMALL, B=len(ctx))
    _patch(monkeypatch, (jdma, jstr), shape)
    q, k, v, bt, cl = _inputs(shape, ctx, "bf16", seed=30 + P)
    layer = shape["L"] - 1
    with pltpu.force_tpu_interpret_mode():
        want = _jax_layer_output(jstr, mode, P, shape,
                                 *_jax(q, k, v, bt, cl, "bf16"), layer)
    got = tstr.probe_strided_reference(*_torch(q, k, v, bt, cl, "bf16"),
                                       layer, mode=mode, pages_per_block=P)
    assert got.shape == want.shape == (shape["B"], shape["KVH"] * 8,
                                       shape["D"])
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got, want, GATHER_TOL if mode == "reads" else DOTS_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_dma_only_matches_pallas(jax_probes, monkeypatch, P, dtype):
    _dma(jax_probes, monkeypatch, SMALL, [37, 50], dtype, P, seed=P)


@pytest.mark.parametrize("mode", ["reads", "dots"])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_probe_strided_matches_pallas(jax_probes, monkeypatch, P, mode):
    _strided(jax_probes, monkeypatch, SMALL, [50, 37], mode, P, seed=10 + P)


# With P = 2 and 8-token pages a chunk is 16 tokens: 1 token, a chunk
# boundary, mid-chunk, and an empty sequence, each in turn at the row the
# checksum reads (the last for dma_only, the first for the strided probe).
RAGGED = [[1, 16, 23, 0], [16, 23, 0, 1], [23, 0, 1, 16], [0, 1, 16, 23]]


@pytest.mark.parametrize("probe", ["dma_only", "reads", "dots"])
@pytest.mark.parametrize("ctx", RAGGED, ids=["-".join(map(str, c))
                                            for c in RAGGED])
def test_ragged_contexts_match_pallas(jax_probes, monkeypatch, probe, ctx):
    shape = dict(SMALL, B=4)
    if probe == "dma_only":
        _dma(jax_probes, monkeypatch, shape, ctx, "bf16", 2, seed=20)
    else:
        _strided(jax_probes, monkeypatch, shape, ctx, probe, 2, seed=21)


def _bad(case):
    rng = np.random.default_rng(0)
    k = torch.from_numpy(_values(rng, (2, 20, 8, 2, 32), "f32"))
    v = k.clone()
    bt = torch.zeros((2, 8), dtype=torch.int32)
    P = 2
    if case == "table width":
        P = 3
    elif case == "mixed dtypes":
        v = v.bfloat16()
    else:
        k = k[0]
    return k, v, bt, P


@pytest.mark.parametrize("case,error,match", [
    ("table width", ValueError, "does not divide"),
    ("mixed dtypes", TypeError, "v pages"),
    ("not 5-D", ValueError, r"\[L, NB, bs, KVH, D\]"),
])
def test_bad_operands_raise(case, error, match):
    k, v, bt, P = _bad(case)
    cl = torch.tensor([9, 16], dtype=torch.int32)
    q = torch.zeros((2, 16, 32))
    with pytest.raises(error, match=match):
        tdma.dma_only(k, v, bt, cl, 0, pages_per_block=P)
    for mode in tstr.MODES:
        with pytest.raises(error, match=match):
            tstr.probe_strided(q, k, v, bt, cl, 0, mode=mode,
                               pages_per_block=P)


CPU_MAIN = dict(B=2, MAXB=8, NB=20, CTX=37, L=2, bs=8, KVH=2, D=32)


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("probe", ["kernel_dma_only", "kernel_probe_strided"])
def test_main_rows_on_the_cpu(capsys, monkeypatch, probe):
    """Each main prints the JAX script's rows (its shapes patched small
    here, as the JAX modules' are); on the CPU it times nothing."""
    if probe == "kernel_dma_only":
        _patch(monkeypatch, (tdma,), dict(CPU_MAIN, P_SWEEP=(2, 8)))
        assert tdma.main(["--device", "cpu"]) == 0
        rows = _rows(capsys)
        assert len(rows) == 3
        assert rows[0]["contiguous_sum_s"] is None
        assert rows[0]["pool_gb"] == 2 * 20 * 8 * 2 * 32 * 2 / 1e9
        # ceil(37 / (P * 8)) * P pages a sequence, K and V, both layers.
        for row, pages in zip(rows[1:], (6, 8)):
            assert row["dtype"] == "bf16"
            assert row["dma_only_all_L_s"] is None
            assert row["effective_gbs"] is None
            assert row["bytes_gb"] == 2 * pages * 8 * 2 * 32 * 2 * 2 * 2 / 1e9
            assert row["floor_s"] == row["bytes_gb"] * 1e9 / 3.35e12
    else:
        _patch(monkeypatch, (tstr,), dict(CPU_MAIN, PAGES_PER_BLOCK=2))
        assert tstr.main(["--device", "cpu"]) == 0
        rows = _rows(capsys)
        assert [r["mode"] for r in rows] == ["reads", "dots"]
        for row in rows:
            assert row["all_L_s"] is None and row["dtype"] == "bf16"
            assert row["P"] == 2
        assert rows[0]["gflop"] == 0
        # 6 pages of 8 tokens a sequence: 4 * (2 * 8) * 32 flops a token.
        assert rows[1]["gflop"] == 4 * 16 * 32 * 2 * 6 * 8 * 2 / 1e9


def test_device_timer_refuses_the_cpu():
    """A probe's times are CUDA-event device times; with no card the
    timer raises rather than report a host clock."""
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_time_ms(lambda: None)
