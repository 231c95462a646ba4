"""portbench's CPU tests of its operation and byte counts, collected into the
tier-1 run."""

from portbench.tests.test_portbench_flops import *  # noqa: F401,F403
