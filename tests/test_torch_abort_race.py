"""An abort from another thread between a decode burst's planning and
its build (the window in which the burst reads each row's block table
outside the engine's lock) ends only the aborted request: the others
finish with ``length`` and stream what an undisturbed run streams."""

import queue
import time

import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.obs.steps import PhaseClock

torch.set_num_threads(1)

ENGINE = dict(model="tiny-llama", max_model_len=128, max_num_seqs=4,
              block_size=4, num_blocks=96, min_prefill_bucket=16,
              max_loras=0, dtype="float32", device="cpu")
PROMPTS = {"a": [1, 2, 3, 4, 5], "b": [6, 7, 8, 9], "victim": [10, 11, 12]}


def serve(abort_at_build=None):
    """Every prompt, greedy, 32 tokens each: {rid: (tokens, finish)}.
    With ``abort_at_build``, the first "build" mark after that request
    has streamed 8 tokens aborts it (from the engine's own thread,
    between the burst's plan and its build, with the lock free)."""
    eng = EngineCore(EngineConfig(**ENGINE))
    out = {rid: [[], None] for rid in PROMPTS}
    done: "queue.Queue" = queue.Queue()

    def sink(rid):
        def cb(token, finish):
            if token is not None:
                out[rid][0].append(int(token))
            if finish is not None:
                out[rid][1] = finish
                done.put(rid)
        return cb

    mark = PhaseClock.mark
    fired = []

    def hooked(self, name):
        if (name == "build" and not fired and abort_at_build
                and len(out[abort_at_build][0]) >= 8):
            fired.append(eng.abort_request(abort_at_build))
        return mark(self, name)

    PhaseClock.mark = hooked
    try:
        with eng._lock:  # every request in before the first step
            for rid, ids in PROMPTS.items():
                eng.add_request(rid, ids, SamplingParams(
                    temperature=0.0, max_tokens=32, ignore_eos=True),
                    sink(rid))
        eng.start()
        deadline = time.time() + 120
        for _ in PROMPTS:
            done.get(timeout=max(deadline - time.time(), 1))
    finally:
        PhaseClock.mark = mark
        eng.stop()
    if abort_at_build:
        assert fired == [True]
    return {rid: (tuple(toks), fin) for rid, (toks, fin) in out.items()}


def test_an_abort_between_plan_and_build_ends_only_that_request():
    calm = serve()
    assert all(fin == "length" and len(t) == 32 for t, fin in calm.values())
    hit = serve(abort_at_build="victim")
    assert hit["victim"][1] == "abort"
    assert 8 <= len(hit["victim"][0]) < 32
    for rid in ("a", "b"):
        assert hit[rid] == calm[rid]
