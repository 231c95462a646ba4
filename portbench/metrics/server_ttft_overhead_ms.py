"""HTTP surface: median over window requests of the client's time to
first token from sending, less the engine's (``StageClock``:
``first_token - arrival``, read from the request's trace), in ms."""

from portbench import harness


def read(run):
    gaps = [1000.0 * ((r["first"] - r["send"]) - r["engine_ttft"])
            for r in run.window_requests()
            if r["first"] is not None and r["engine_ttft"] is not None]
    return harness.median(gaps)
