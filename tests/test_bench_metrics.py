"""portbench's CPU tests of its metric readers, collected into the
tier-1 run."""

from portbench.tests.test_portbench_metrics import *  # noqa: F401,F403
