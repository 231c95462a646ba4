"""Device: the share of the traced window's device idle time that falls
inside decode bursts' ``launch`` phases, in % (the device trace against
the step records' phases, one clock; ``phases.idle_in_launch_pct``)."""

from portbench import phases


def read(run):
    return phases.idle_in_launch_pct(run)
