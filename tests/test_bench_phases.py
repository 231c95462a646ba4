"""portbench's CPU tests of the step phases and their readers, collected
into the tier-1 run."""

from portbench.tests.test_portbench_phases import *  # noqa: F401,F403
