"""Engine step: the share of the engine thread's wall time in decode
bursts, every phase but the readback wait, that it spent off the CPU,
in % (the phases' thread CPU clock; ``phases.offcpu_pct``)."""

from portbench import phases


def read(run):
    return phases.offcpu_pct(run)
