"""Set-up: process start to the window's opening, less the ramp (weights
drawn, engine built and warmed up, server bound, client started)."""


def read(run):
    return run.setup_s
