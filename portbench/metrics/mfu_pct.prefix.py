"""Device: model operations of the tokens computed in the window over
the window's seconds at the card's bf16 peak (``layer.mfu_pct``), in %."""

from portbench import layer


def read(run):
    return layer.mfu_pct(run)
