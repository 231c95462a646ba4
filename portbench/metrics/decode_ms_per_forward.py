"""Engine step: host wall time of the decode steps begun in the window
over their forwards (step records), in ms."""


def read(run):
    steps = run.window_steps(("decode_burst", "fused"))
    forwards = sum(s["forwards"] for s in steps)
    if forwards <= 0:
        return None
    return 1000.0 * sum(s["wall_s"] for s in steps) / forwards
