"""90th percentile (nearest rank) over the requests that finished in the
window of (last - first token) / (tokens - 1), in ms."""

from portbench import harness


def read(run):
    values = harness.tpot_values(run)
    return 1000.0 * harness.percentile(values, 90) if values else None
