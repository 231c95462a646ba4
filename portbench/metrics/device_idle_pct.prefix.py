"""Device: share of the traced window with nothing running on the card
(union of every device activity's interval), in %."""

from portbench import layer


def read(run):
    return layer.device_idle_pct(run)
