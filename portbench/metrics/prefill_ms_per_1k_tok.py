"""Engine step: host wall time of the prefill steps begun in the window
per 1,000 tokens they scheduled (step records), in ms."""


def read(run):
    steps = run.window_steps(("prefill", "prefill_chunk"))
    tokens = sum(s["tokens"] for s in steps)
    if tokens <= 0:
        return None
    return 1e6 * sum(s["wall_s"] for s in steps) / tokens
