"""90th percentile (nearest rank) of time to first token over every
window request, failed ones as missing (``harness.ttft_values``)."""

from portbench import harness


def read(run):
    values = harness.ttft_values(run)
    return harness.percentile(values, 90) if values else None
