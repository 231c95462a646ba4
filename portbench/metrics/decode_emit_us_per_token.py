"""Engine step: the wall time of the decode bursts' ``emit`` phases
(tokens handed to their requests' streams) over their tokens, in us
(step records' phases, host clock; ``phases.emit_us_per_token``)."""

from portbench import phases


def read(run):
    return phases.emit_us_per_token(run)
