"""The port's A/B harnesses (``production_stack_tpu_torch/testing/``)
against the JAX package's (``production_stack_tpu/testing/``), on the CPU
at small sizes, tiny-llama float32 with the JAX engine's weights carried
over (``models/convert.py``).

- ``spec_draft_ab``: all five legs (prompt lookup and draft model on
  non-repetitive text; structured alone, drafter alone and structured +
  drafter on the JSON grammar): generated, proposed and accepted tokens,
  target forwards, tokens per forward, drafter forwards, latched
  requests and failed requests equal the JAX harness's counts.
- ``structured_ab``: the overhead legs emit the same tokens masked and
  unmasked, equal to the JAX harness's, with equal mask-state and
  violation counters; the conformance leg passes all 30 corpus cases on
  both surfaces of the port's server and refuses an uncompilable schema
  with 400; one case also goes through the JAX router in front of the
  port's server.

Cost on one core: ~60 s (the JAX harness builds five engines)."""

import asyncio
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxEngineConfig
from production_stack_tpu.engine.core import EngineCore as JaxEngineCore
from production_stack_tpu.testing import spec_draft_ab as jax_spec_ab
from production_stack_tpu.testing import structured_ab as jax_structured_ab
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.models.convert import (
    draft_params_from_numpy,
    params_from_numpy,
)
from production_stack_tpu_torch.structured.api import compile_char_dfa
from production_stack_tpu_torch.structured.corpus import (
    case_request_fields,
    case_spec,
    load_corpus,
)
from production_stack_tpu_torch.testing import spec_draft_ab, structured_ab
from test_torch_engine import cfg_model

torch.set_num_threads(1)

SPEC_SHAPE = dict(model="tiny-llama", dtype="float32", max_model_len=256,
                  max_num_seqs=4, block_size=8, num_blocks=128,
                  min_prefill_bucket=16, max_loras=0)
MAX_TOKENS = 8
COUNTS = ("requests", "failed_requests", "generated_tokens",
          "decode_forwards", "tokens_per_forward", "spec_proposed_by_source",
          "spec_accepted_by_source", "spec_draft_forward_steps",
          "spec_disabled_requests")


def _jax_weights(**over):
    """The JAX engine's target (and drafter) trees at the harness's
    shape, as the port's parameter dicts."""
    kwargs = dict(SPEC_SHAPE, **over)
    jeng = JaxEngineCore(JaxEngineConfig(**kwargs), devices=jax.devices()[:1])
    cfg = EngineConfig(device="cpu", **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                               cfg_model(cfg), "cpu")
    draft = None
    if jeng._draft is not None:
        draft = draft_params_from_numpy(
            jax.tree.map(np.asarray, jeng._draft.params), cfg, "cpu")
    jeng.stop()
    return params, draft


def test_spec_draft_ab_counts_equal_the_jax_harness(monkeypatch):
    make = jax_spec_ab._make_engine
    monkeypatch.setattr(jax_spec_ab, "_make_engine",
                        lambda **over: make(dtype="float32", **over))
    want = jax_spec_ab.run_spec_draft_ab(max_tokens=MAX_TOKENS)
    params, draft = _jax_weights(speculative_num_tokens=4,
                                 speculative_draft_model="tiny-llama")
    got = spec_draft_ab.run_spec_draft_ab(
        max_tokens=MAX_TOKENS, device="cpu", model="tiny-llama",
        dtype="float32", params=params, draft_params=draft)
    assert got["metric"] == want["metric"] == "spec_draft_ab"
    legs = {"nonrepetitive": ("prompt_lookup", "draft_model"),
            "structured_json": ("structured_alone", "drafter_alone",
                                "structured_drafter")}
    for block, names in legs.items():
        for name in names:
            for key in COUNTS:
                assert got[block][name][key] == want[block][name][key], (
                    block, name, key)
    for key in ("value", "failed_requests"):
        assert got[key] == want[key], key
    for key in ("structured_violations", "beats_structured_alone",
                "beats_drafter_alone"):
        assert got["structured_json"][key] == want["structured_json"][key]
    assert got["nonrepetitive"]["tokens_per_forward_ratio"] == \
        want["nonrepetitive"]["tokens_per_forward_ratio"]


def _recording_collect_all(streams):
    """The JAX harness's ``_collect_all``, keeping each request's
    tokens."""
    import queue

    def collect(eng, requests, timeout_s=300.0):
        done = queue.Queue()

        def make_cb(rid):
            def on_token(token, finish):
                if token is not None:
                    streams.setdefault(rid, []).append(int(token))
                if finish is not None:
                    done.put(rid)
            return on_token

        t0 = time.perf_counter()
        for rid, prompt_ids, sampling in requests:
            streams[rid] = []  # the warm pass reuses the first rids
            eng.add_request(rid, prompt_ids, sampling, make_cb(rid))
        for _ in requests:
            done.get(timeout=timeout_s)
        return (sum(len(streams.get(r, [])) for r, _, _ in requests),
                time.perf_counter() - t0)
    return collect


def test_structured_overhead_legs_equal_the_jax_harness(monkeypatch):
    import production_stack_tpu.engine.config as jax_config

    jax_streams = {}
    monkeypatch.setattr(jax_config, "EngineConfig",
                        lambda **kw: JaxEngineConfig(**dict(
                            kw, dtype="float32")))
    monkeypatch.setattr(jax_structured_ab, "_collect_all",
                        _recording_collect_all(jax_streams))
    want = jax_structured_ab.run_engine_overhead(
        n_requests=2, max_tokens=MAX_TOKENS, repeats=1)
    monkeypatch.undo()
    shape = dict(model="tiny-llama", dtype="float32", max_model_len=128,
                 max_num_seqs=8, block_size=4, num_blocks=256,
                 min_prefill_bucket=16, max_loras=0, decode_steps=1)
    jeng = JaxEngineCore(JaxEngineConfig(**shape), devices=jax.devices()[:1])
    cfg = EngineConfig(device="cpu", **shape)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                               cfg_model(cfg), "cpu")
    jeng.stop()
    got = structured_ab.run_engine_overhead(
        n_requests=2, max_tokens=MAX_TOKENS, repeats=1, device="cpu",
        model="tiny-llama", dtype="float32", params=params)
    masked, unmasked = got["streams"]["masked"], got["streams"]["unmasked"]
    assert masked == unmasked and all(len(s) == MAX_TOKENS for s in masked)
    for label, prefix in (("unmasked", "u"), ("masked", "m")):
        assert got["streams"][label] == [jax_streams[f"{prefix}0-{i}"]
                                         for i in range(2)], label
    for key in ("structured_requests_total", "structured_mask_states_total",
                "structured_violations_total"):
        assert got["structured_stats"][key] == \
            want["structured_stats"][key], key
    assert got["decode_steps"] == want["decode_steps"] == 1


@pytest.fixture(scope="module")
def conformance():
    httpd, core, base, bias = structured_ab.conformance_server("cpu")
    yield core, base, bias
    httpd.shutdown()
    httpd.server_close()
    core.stop()


@pytest.mark.parametrize("surface", ["guided", "response_format"])
def test_corpus_conformance_on_the_ports_server(conformance, surface):
    core, base, bias = conformance
    before = core.stats()["structured_requests_total"]
    out = structured_ab.run_corpus_conformance(surface, base, bias)
    assert out["cases"] == len(load_corpus()) == 30
    assert out["conformance"] == 1.0, out["failed"]
    assert out["rejects_uncompilable"]
    assert core.stats()["structured_requests_total"] - before >= 30


def test_mixed_traffic_serves_plain_and_structured_rows(conformance):
    """The stall monitor's load: plain and structured requests at once,
    every one answered, the structured ones through the mask path."""
    core, base, _ = conformance
    before = core.stats()["structured_requests_total"]
    out = structured_ab.run_mixed_traffic(base, n_requests=2, max_tokens=4)
    assert (out["ok"], out["failed"]) == (4, 0)
    assert out["plain_requests"] == out["structured_requests"] == 2
    assert core.stats()["structured_requests_total"] - before == 2


def test_a_case_through_the_jax_router(conformance):
    import aiohttp
    from aiohttp import web

    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.parser import build_parser
    from production_stack_tpu.testing.qos_ab import _reset_router_singletons

    _, base, bias = conformance
    case = next(c for c in load_corpus()
                if c["name"] == "schema-object-two-required")

    async def scenario():
        _reset_router_singletons()
        args = build_parser().parse_args([])
        args.static_backends = base
        args.static_models = structured_ab.MODEL
        args.routing_logic = "roundrobin"
        args.engine_stats_interval = 60
        runner = web.AppRunner(build_app(args))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        body = {"model": structured_ab.MODEL, "max_tokens": 64,
                "temperature": 0, "logit_bias": bias,
                "messages": [{"role": "user", "content": "emit the value"}],
                **case_request_fields(case, surface="response_format")}
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(url + "/v1/chat/completions",
                                  json=body) as resp:
                    assert resp.status == 200, await resp.text()
                    content = (await resp.json())["choices"][0][
                        "message"]["content"]
                bad = dict(body, response_format=None,
                           guided_json={"allOf": [{"type": "string"}]})
                async with s.post(url + "/v1/chat/completions",
                                  json=bad) as resp:
                    bad_status = resp.status
        finally:
            await runner.cleanup()
            _reset_router_singletons()
        return content, bad_status

    content, bad_status = asyncio.run(scenario())
    assert compile_char_dfa(case_spec(case)).fullmatch(content)
    assert set(json.loads(content)) == {"name", "age"}
    assert bad_status == 400


def test_threads_of_the_harness_servers_end():
    """The conformance server a run starts itself is gone afterwards."""
    before = threading.active_count()
    out = structured_ab.run_corpus_conformance("guided", device="cpu")
    assert out["conformance"] == 1.0, out["failed"]
    assert out["engine_structured_requests"] >= 30
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before
