"""Scheduling: prompt tokens served from the prefix cache over prompt
tokens admitted in the window (``EngineCore.stats()`` deltas), in %."""


def read(run):
    prompt = run.delta("prompt_tokens_total")
    if prompt <= 0:
        return None
    return 100.0 * run.delta("cached_tokens_total") / prompt
