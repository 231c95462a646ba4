"""portbench's CPU tests of its layout (new files found by name), collected into the
tier-1 run."""

from portbench.tests.test_portbench_layout import *  # noqa: F401,F403
