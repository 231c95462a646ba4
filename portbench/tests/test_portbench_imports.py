"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference loads nothing of the port either."""

import os
import subprocess
import sys

from portbench import harness
from portbench.tests.tinybench import REPO

PROBE = """
import sys
sys.path.insert(0, {repo!r})
{imports}
print(sorted({{n.split('.', 1)[0] for n in sys.modules}}))
"""


def loaded(imports):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=REPO, imports=imports)],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, USE_FLAX="0", USE_JAX="0"))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    names = loaded("from portbench import run, harness, sweep, calibrate\n"
                   "from production_stack_tpu_torch.engine import server\n"
                   "from production_stack_tpu_torch.engine import core")
    assert "production_stack_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    names = loaded("from portbench.reference import check, model")
    assert "torch" in names
    assert not names & (set(harness.FORBIDDEN)
                        | {"production_stack_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "production_stack_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "production_stack_tpu.models", sys)
    assert harness.forbidden_modules() == ["production_stack_tpu.models"]
