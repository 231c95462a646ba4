"""portbench's CPU tests of its imports
(``portbench/tests/test_portbench_imports.py``) in the tier-1 run: a case here
passes when the same case passed in a child process that loads no JAX
(``bench_child.py``)."""

import pytest

from bench_child import case_ids, check, run_module
from portbench.tests import test_portbench_imports as module


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return run_module(module, str(tmp_path_factory.mktemp("bench_imports")))


@pytest.mark.parametrize("case", case_ids(module))
def test_in_a_process_without_jax(outcomes, case):
    check(outcomes, case)
