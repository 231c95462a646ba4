"""Scheduling: 90th percentile (nearest rank) over window requests of
the engine's queue span (``prefill_start - arrival``), in ms."""

from portbench import harness


def read(run):
    waits = [1000.0 * (r["prefill_start"] - r["arrival"])
             for r in run.window_requests()
             if r["prefill_start"] is not None and r["arrival"] is not None]
    return harness.percentile(waits, 90) if waits else None
