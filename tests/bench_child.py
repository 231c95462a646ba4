"""Runs one of portbench's CPU test modules in a child pytest process
for the tier-1 run, and reads back each case's outcome.

``conftest.py`` here loads JAX into every test process, and portbench's
whole-run and import tests check that the benchmark's process loads
none: they pass only in a process the benchmark would run in. The child
runs the module as ``python -m pytest portbench/tests`` runs it (no
conftest of this folder), and each of its cases becomes one case here.
"""

from __future__ import annotations

import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def case_ids(module) -> List[str]:
    """The names pytest gives the module's cases, in its order: a
    function's name, or one ``name[a-b]`` for each parameter set of its
    one ``parametrize``."""
    ids = []
    for name, fn in vars(module).items():
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            ids.append(name)
            continue
        (mark,) = marks
        for values in mark.args[1]:
            vals = values if isinstance(values, (tuple, list)) else (values,)
            ids.append(f"{name}[{'-'.join(str(v) for v in vals)}]")
    return ids


def run_module(module, tmp: str) -> Tuple[Dict[str, tuple], str]:
    """({case: (outcome, message)}, the child's output's tail) of one run
    of ``module``'s file in a child pytest process. Fails unless the
    child ran exactly the cases :func:`case_ids` names, so that no case
    of the child passes or fails without a case here to report it."""
    xml = os.path.join(tmp, "junit.xml")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--junitxml={xml}", module.__file__],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    tail = (proc.stdout + proc.stderr)[-4000:]
    outcomes = {}
    if os.path.exists(xml):
        for case in ET.parse(xml).iter("testcase"):
            outcome, message = "passed", ""
            for tag in ("skipped", "failure", "error"):
                el = case.find(tag)
                if el is not None:
                    outcome = "skipped" if tag == "skipped" else "failed"
                    message = el.get("message") or el.text or ""
                    break
            outcomes[case.get("name")] = (outcome, message)
    expected = set(case_ids(module))
    if set(outcomes) != expected:
        pytest.fail(f"the child ran {sorted(set(outcomes) - expected)} "
                    f"besides the cases named here and not "
                    f"{sorted(expected - set(outcomes))}:\n{tail}")
    return outcomes, tail


def check(outcomes, case: str) -> None:
    """Pass, skip or fail as the case did in the child."""
    found, tail = outcomes
    outcome, message = found[case]
    if outcome == "skipped":
        pytest.skip(message)
    if outcome != "passed":
        pytest.fail(f"{case} failed in the child: {message}\n{tail}")
