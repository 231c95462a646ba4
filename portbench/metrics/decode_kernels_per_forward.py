"""Model: device activities that start inside decode-burst steps over
those steps' forwards, in kernels (the device trace against the step
records' phases; ``phases.kernels_per_forward``)."""

from portbench import phases


def read(run):
    return phases.kernels_per_forward(run)
