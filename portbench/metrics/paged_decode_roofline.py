"""Kernels: the paged decode kernel's byte bound over its device time in
the traced window (``layer.paged_decode_roofline``), in %."""

from portbench import layer


def read(run):
    return layer.paged_decode_roofline(run)
