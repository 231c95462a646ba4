"""Engine step: the wall time of the decode bursts' ``launch`` phases
(the host's launches of a burst's forwards) over their forwards, in ms
(step records' phases, host clock; ``phases.launch_ms_per_forward``)."""

from portbench import phases


def read(run):
    return phases.launch_ms_per_forward(run)
