"""portbench's CPU tests of its traffic generator, collected into the
tier-1 run."""

from portbench.tests.test_portbench_traffic import *  # noqa: F401,F403
