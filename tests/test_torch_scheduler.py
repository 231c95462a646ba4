"""The port's copies of the scheduler and the KV block manager make the
same decisions as the JAX package's: one request trace drives both and
must give the same actions, block tables, prefix hits and preemptions."""

import dataclasses

import pytest
import torch

from production_stack_tpu.engine import kvcache as jax_kvcache
from production_stack_tpu.engine import sampling as jax_sampling
from production_stack_tpu.engine import scheduler as jax_scheduler
from production_stack_tpu_torch.engine import kvcache as t_kvcache
from production_stack_tpu_torch.engine import sampling as t_sampling
from production_stack_tpu_torch.engine import scheduler as t_scheduler

torch.set_num_threads(1)


def _build(kv_mod, sched_mod, num_blocks=6, block_size=4, max_num_seqs=2):
    mgr = kv_mod.KVCacheManager(num_blocks, block_size, True,
                                namespace="tiny-llama")
    return mgr, sched_mod.Scheduler(mgr, max_num_seqs, max_model_len=64)


def _trace(kv_mod, sched_mod, samp_mod):
    """Admit prompts (one sharing a prefix), grow sequences token by
    token until the pool preempts, finish one; record every decision."""
    mgr, sched = _build(kv_mod, sched_mod)
    log = []
    events = []

    def req(rid, prompt):
        return sched_mod.EngineRequest(
            request_id=rid, prompt_token_ids=prompt,
            sampling=samp_mod.SamplingParams(max_tokens=8),
            on_token=lambda t, f, rid=rid: events.append((rid, t, f)))

    prompts = {"a": list(range(1, 10)), "b": list(range(1, 9)) + [77, 78],
               "c": [5] * 70}
    for rid, prompt in prompts.items():
        sched.add(req(rid, prompt))
    for step in range(12):
        action, r = sched.next_action()
        entry = [step, action]
        if action == "prefill":
            ids, cached, _ = mgr.allocate_prompt(r.request_id,
                                                 r.all_token_ids)
            slot = sched._free_slot()
            sched.start_running(r, slot)
            entry += [r.request_id, list(ids), cached]
        elif action == "decode":
            for seq in list(sched.running()):
                if sched.slots[seq.slot] is not seq:
                    continue
                seq.req.output_token_ids.append(1)
                while not mgr.append_token(seq.req.request_id, 1):
                    victim = sched.preempt_victim()
                    entry.append(("preempt", victim.req.request_id))
                    if victim.req is seq.req:
                        break
            if step == 8:
                seq = sched.running()[0]
                sched.finish(seq, "length")
                entry.append(("finish", seq.req.request_id))
            entry.append(sorted((s.req.request_id,
                                 list(mgr.block_table(s.req.request_id)))
                                for s in sched.running()))
        log.append(entry)
    alloc = mgr.allocator
    return log, events, (alloc.prefix_hits, alloc.prefix_queries,
                         sched.num_preempted_total, mgr.usage())


def test_same_trace_same_decisions():
    want = _trace(jax_kvcache, jax_scheduler, jax_sampling)
    got = _trace(t_kvcache, t_scheduler, t_sampling)
    assert got == want
    log, events, (hits, queries, preempted, _) = got
    assert any(e[1] == "prefill" and e[-1] > 0 for e in log), "no prefix hit"
    assert preempted > 0
    assert ("c", None, "length") in events  # over max_model_len: rejected


def test_chain_hash_is_stable_and_not_xxhash():
    """The name predates the port's XXH64: the port's chain hash is now
    the JAX engine's, bit for bit."""
    h1 = t_kvcache.BlockAllocator.chain_hash(None, (1, 2, 3, 4))
    assert h1 == t_kvcache.BlockAllocator.chain_hash(None, (1, 2, 3, 4))
    assert h1 != t_kvcache.BlockAllocator.chain_hash(None, (1, 2, 3, 5))
    assert h1 != t_kvcache.BlockAllocator.chain_hash("m|", (1, 2, 3, 4))
    assert 0 <= h1 < 2 ** 64
    assert h1 == jax_kvcache.BlockAllocator.chain_hash(None, (1, 2, 3, 4))


@pytest.mark.parametrize("body", [
    {"max_tokens": 5, "temperature": 0.5, "top_p": 0.9, "top_k": 3,
     "stop": "x", "seed": 4, "logit_bias": {"7": 2.5}, "min_tokens": 2,
     "stop_token_ids": [3, 9], "presence_penalty": 0.1, "logprobs": 2},
    {"max_completion_tokens": 9, "logprobs": True, "top_logprobs": 4,
     "frequency_penalty": 0.3, "echo": True},
])
def test_sampling_params_parse_the_same(body):
    got = t_sampling.SamplingParams.from_request(body)
    want = jax_sampling.SamplingParams.from_request(body)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("body", [
    {"max_tokens": "7"}, {"logit_bias": {"1": "a"}}, {"logit_bias": [1]},
    {"max_tokens": True}])
def test_sampling_params_reject_the_same(body):
    with pytest.raises(ValueError):
        jax_sampling.SamplingParams.from_request(body)
    with pytest.raises(ValueError):
        t_sampling.SamplingParams.from_request(body)


def test_structured_specs_are_refused_by_the_port():
    """Since structured output was ported, the port parses these bodies
    into the StructuredSpec JAX parses (the name is kept from when it
    refused them), and refuses what JAX refuses."""
    for body in ({"guided_regex": "[0-9]+"},
                 {"guided_json": {"type": "object"}},
                 {"guided_json": '{"type": "integer"}'},
                 {"response_format": {"type": "json_object"}},
                 {"response_format": {"type": "json_schema", "json_schema": {
                     "name": "n", "schema": {"type": "integer"}}}},
                 {"response_format": {"type": "text"}},
                 {"guided_choice": ["a", "b"]},  # neither package reads it
                 {"guided_grammar": "root ::= x"}):
        got = t_sampling.SamplingParams.from_request(body).structured
        want = jax_sampling.SamplingParams.from_request(body).structured
        assert (None if got is None else (got.kind, got.spec)) == (
            None if want is None else (want.kind, want.spec))
    for body in ({"guided_regex": "[0-9]+", "min_tokens": 2},
                 {"guided_regex": ""}, {"response_format": {"type": "yaml"}}):
        with pytest.raises(ValueError) as want:
            jax_sampling.SamplingParams.from_request(body)
        with pytest.raises(ValueError) as got:
            t_sampling.SamplingParams.from_request(body)
        assert str(got.value) == str(want.value)
