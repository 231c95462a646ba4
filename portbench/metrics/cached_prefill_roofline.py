"""Kernels: the cached-prefill kernel's operation bound over its device
time in the traced window (``layer.cached_prefill_roofline``), in %."""

from portbench import layer


def read(run):
    return layer.cached_prefill_roofline(run)
