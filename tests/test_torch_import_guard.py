"""The torch port stands alone: it imports neither JAX nor anything of the
JAX package (so it runs on a host without JAX), and neither does
``chip_smoke.py``.

The import check runs in a subprocess because this test process already
imported JAX (tests/conftest.py)."""

import json
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = "production_stack_tpu_torch"

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import production_stack_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(
    pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
import production_stack_tpu_torch.engine.server  # noqa: F401
loaded = sorted(sys.modules)
print(json.dumps({
    "names": names,
    "jax_package": [m for m in loaded
                    if m.split(".")[0] == "production_stack_tpu"],
    "jax": [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib")
            and sys.modules[m] is not None],
}))
"""


def test_every_port_module_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # The walk really covered the package, server included.
    for mod in ("engine.core", "engine.server", "engine.scheduler",
                "engine.prng", "engine.draft", "engine.tools", "obs.steps",
                "structured", "structured.api", "structured.corpus",
                "structured.regex_dfa", "structured.schema",
                "structured.tokenfsm", "kv", "kv.offload", "kv.controller",
                "kv.device_pipe", "parallel.kv_blocks",
                "utils.xxh64", "utils.auth", "obs.trace", "models.weights",
                "models.llama", "models.opt", "models.mixtral",
                "models.registry", "models.convert", "models.whisper",
                "engine.asr_server", "ops.attention",
                "ops.paged_attention", "ops.prefill_attention", "ops._build",
                "parallel", "parallel.sharding", "parallel.mesh",
                "parallel.multihost", "parallel.tp", "parallel.pp",
                "parallel.pp_serving", "parallel.pipeline",
                "parallel.ring_attention"):
        assert f"{PKG}.{mod}" in out["names"], mod
    # First dotted component exactly "production_stack_tpu": the port's
    # own "production_stack_tpu_torch" shares that prefix and is fine.
    assert out["jax_package"] == []
    assert out["jax"] == []


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+production_stack_tpu\b(?!_)"
    r"|from\s+production_stack_tpu(\.|\s)(?!_))", re.M)


def test_port_sources_name_no_jax_import():
    # The git-ignored kernel build directory holds no sources.
    files = sorted(p for p in (REPO / PKG).rglob("*.py")
                   if "_build" not in p.parts) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(p.relative_to(REPO)) for p in files
                 if _FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_forbidden_pattern_catches_jax_imports():
    """The source scan's pattern is not vacuous."""
    assert _FORBIDDEN.search("import jax.numpy as jnp\n")
    assert _FORBIDDEN.search("from production_stack_tpu.ops import x\n")
    assert _FORBIDDEN.search("import production_stack_tpu\n")
    assert not _FORBIDDEN.search(
        "from production_stack_tpu_torch.ops import x\n")


_IMPORT_WITHOUT_LIBS = r"""
import importlib, pkgutil, sys
# The KV modules stand on the standard library, torch and numpy alone.
for name in ("xxhash", "ml_dtypes", "aiohttp", "jax"):
    sys.modules[name] = None  # any import of them now raises ImportError
import production_stack_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
print("ok")
"""


def test_port_imports_without_xxhash_ml_dtypes_or_aiohttp():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_WITHOUT_LIBS], cwd=REPO,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
