"""portbench's CPU tests of its plain reference and output check, collected into the
tier-1 run."""

from portbench.tests.test_portbench_reference import *  # noqa: F401,F403
