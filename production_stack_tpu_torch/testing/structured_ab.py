"""Structured-output conformance and mask-overhead harness.

The port's counterpart of ``production_stack_tpu/testing/structured_ab.py``.

- **Corpus conformance** (:func:`run_corpus_conformance`): every case of
  the 30-case corpus (``structured/corpus.json``, the port's copy) goes
  to the port's own server, over the vLLM guided surface
  (``guided_json`` / ``guided_regex``) and over the OpenAI
  ``response_format`` surface, with a standard-library client; each
  answer must fullmatch the case's compiled automaton (and pass
  :func:`validate_instance` for schema cases), and an uncompilable schema
  must come back 400. The JAX leg routed the corpus to fake engines that
  answer each constraint with an example of its language; the port may
  import neither that router nor the fake, so this leg serves through
  the real server: the request parse, the compile, the 400, the token
  FSM's mask rows and the masked greedy sample. Its model is tiny-llama
  with an all-zero output head, so that every token scores the same and
  the mask alone, plus a +100 bias on the end of text and the structural
  closers (``"``, ``]``, ``}``, ``@``), chooses each token: a model with
  random weights rambles inside a free string until ``max_tokens``,
  which says nothing about conformance. Greedy ties go to the lowest
  allowed token id.
- **Mask overhead** (:func:`run_engine_overhead`): the port's engine
  decodes the same greedy traffic twice, unconstrained, then under a
  NON-BINDING regex (``(.|\\s)*``, which allows every token), so both legs
  emit the same tokens and the difference is the structured path's cost
  (mask rows built and shipped, the automaton advanced on the host). Both
  legs run ``decode_steps=1``, because a structured row takes one step a
  burst.

  python -m production_stack_tpu_torch.testing.structured_ab
  python -m production_stack_tpu_torch.testing.structured_ab --device cpu \\
      --model tiny-llama --dtype float32 --requests 2 --max-tokens 8

Prints ONE JSON line (``"metric": "structured_output_ab"``).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

from production_stack_tpu_torch.structured.api import compile_char_dfa
from production_stack_tpu_torch.structured.corpus import (
    case_request_fields,
    case_spec,
    load_corpus,
)
from production_stack_tpu_torch.structured.schema import validate_instance

MODEL = "structured-model"

# Allows every token (``.`` = any non-newline byte, ``\s`` the rest):
# masking stays ON, rows computed, shipped and advanced, but the
# constraint never changes what greedy decoding picks.
NON_BINDING_REGEX = r"(.|\s)*"

# The conformance model's bias: the end of text and the characters that
# close a structure win wherever the mask allows them.
CLOSERS = ('"', "]", "}", "@")


def _chat(base: str, fields: dict, timeout_s: float = 120.0):
    """POST one non-streamed chat completion: (status, content)."""
    body = {"model": MODEL, "max_tokens": 64, "stream": False,
            "temperature": 0,
            "messages": [{"role": "user", "content": "emit the value"}]}
    body.update(fields)
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            payload = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None
    return 200, payload["choices"][0]["message"]["content"]


def conformance_server(device="cpu", extra_args=()):
    """The port's server on tiny-llama (float32) with an all-zero output
    head, serving as ``MODEL`` (``extra_args`` added to its flags):
    (httpd, core, base url, logit bias)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.server import build_server

    core = EngineCore(EngineConfig(
        model="tiny-llama", device=str(device), dtype="float32",
        max_model_len=512, max_num_seqs=4, block_size=8, num_blocks=512,
        max_loras=0))
    core.params["lm_head"].zero_()
    httpd, core = build_server(
        ["tiny-llama", "--host", "127.0.0.1", "--port", "0",
         "--served-model-name", MODEL, "--no-warmup", *extra_args],
        core=core)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    bias = {str(core._eos_id): 100}
    for ch in CLOSERS:
        bias[str(core.tokenizer.encode(ch)[-1])] = 100
    return httpd, core, f"http://127.0.0.1:{httpd.server_address[1]}", bias


def run_corpus_conformance(surface: str = "guided",
                           base: Optional[str] = None,
                           bias: Optional[dict] = None,
                           device="cpu") -> dict:
    """The corpus through the port's server at ``base`` (one of
    :func:`conformance_server`'s, started here when None) on one
    surface; each answer checked against its case's automaton."""
    own = None
    if base is None:
        own = conformance_server(device)
        base, bias = own[2], own[3]
    passed: List[str] = []
    failed: List[dict] = []
    try:
        for case in load_corpus():
            fields = case_request_fields(case, surface=surface)
            if bias:
                fields["logit_bias"] = bias
            status, content = _chat(base, fields)
            ok = status == 200 and content is not None
            if ok:
                ok = compile_char_dfa(case_spec(case)).fullmatch(content)
                if ok and case["kind"] == "json_schema":
                    ok = validate_instance(case["spec"], json.loads(content))
            (passed if ok else failed).append(
                case["name"] if ok else
                {"case": case["name"], "status": status,
                 "content": content})
        # The 400 path: an uncompilable schema is refused.
        bad_status, _ = _chat(base, {"guided_json": {
            "allOf": [{"type": "string"}]}})
        structured = None
        if own is not None:
            structured = own[1].stats()["structured_requests_total"]
    finally:
        if own is not None:
            own[0].shutdown()
            own[0].server_close()
            own[1].stop()
    return {
        "surface": surface,
        "cases": len(passed) + len(failed),
        "passed": len(passed),
        "failed": failed,
        "conformance": round(
            len(passed) / max(len(passed) + len(failed), 1), 4),
        "rejects_uncompilable": bad_status == 400,
        "engine_structured_requests": structured,
    }


def run_mixed_traffic(base: str, n_requests: int = 8,
                      max_tokens: int = 64) -> dict:
    """The overhead legs' traffic at once, over HTTP: ``n_requests``
    plain and ``n_requests`` structured greedy chat requests (the
    non-binding regex), all concurrent, to the port's server at ``base``
    serving as ``MODEL``. It is the load of the stall monitor's served
    run. Returns the counts and the wall seconds; a request that fails
    is counted, not raised."""
    results = {}

    def one(i: int, structured: bool) -> None:
        fields = {"max_tokens": max_tokens, "ignore_eos": True,
                  "messages": [{"role": "user",
                                "content": f"bench prompt {i}"}]}
        if structured:
            fields["guided_regex"] = NON_BINDING_REGEX
        results[(i, structured)] = _chat(base, fields, timeout_s=600.0)

    threads = [threading.Thread(target=one, args=(i, structured))
               for i in range(n_requests) for structured in (False, True)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    ok = [key for key, (status, content) in results.items()
          if status == 200 and content is not None]
    return {"plain_requests": n_requests, "structured_requests": n_requests,
            "max_tokens": max_tokens, "ok": len(ok),
            "failed": len(threads) - len(ok), "wall_s": wall}


def _collect_all(eng, requests, timeout_s: float = 300.0):
    """Submit every request and drain until each finishes: (total
    tokens, wall seconds, {rid: tokens})."""
    done: "queue.Queue" = queue.Queue()
    streams = {}

    def make_cb(rid):
        def on_token(token, finish):
            if token is not None:
                streams.setdefault(rid, []).append(int(token))
            if finish is not None:
                done.put(rid)
        return on_token

    t0 = time.perf_counter()
    for rid, prompt_ids, sampling in requests:
        eng.add_request(rid, prompt_ids, sampling, make_cb(rid))
    remaining = len(requests)
    deadline = time.time() + timeout_s
    while remaining > 0 and time.time() < deadline:
        try:
            done.get(timeout=1.0)
            remaining -= 1
        except queue.Empty:
            continue
    wall = time.perf_counter() - t0
    if remaining:
        raise RuntimeError(f"{remaining} bench requests never finished")
    return sum(len(s) for s in streams.values()), wall, streams


def run_engine_overhead(*, n_requests: int = 8, max_tokens: int = 32,
                        repeats: int = 3, device="cuda",
                        model: str = "tiny-llama",
                        dtype: Optional[str] = None, params=None) -> dict:
    """Masked against unmasked greedy tokens/s on the port's engine; the
    legs' token streams of the last repeat ride along (``streams``)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    kwargs = dict(model=model, device=str(device), max_model_len=128,
                  max_num_seqs=8, block_size=4, num_blocks=256,
                  min_prefill_bucket=16, max_loras=0, decode_steps=1)
    if dtype:
        kwargs["dtype"] = dtype
    eng = EngineCore(EngineConfig(**kwargs), params=params)
    eng.start()
    streams = {}
    try:
        def leg(structured: bool) -> float:
            body = {"temperature": 0, "max_tokens": max_tokens}
            if structured:
                body["guided_regex"] = NON_BINDING_REGEX
            best = 0.0
            for r in range(repeats):
                reqs = []
                for i in range(n_requests):
                    sampling = SamplingParams.from_request(dict(body))
                    ids = eng.tokenizer.encode(f"bench prompt {i}")
                    reqs.append((f"{'m' if structured else 'u'}{r}-{i}",
                                 ids, sampling))
                tokens, wall, got = _collect_all(eng, reqs)
                best = max(best, tokens / wall if wall > 0 else 0.0)
                streams["masked" if structured else "unmasked"] = [
                    got.get(rid, []) for rid, _, _ in reqs]
            return best

        # A warm pass (first launches build and load), then the legs.
        leg(False)
        unmasked = leg(False)
        masked = leg(True)
    finally:
        eng.stop()

    overhead_pct = round(100.0 * (1.0 - masked / unmasked), 2) \
        if unmasked > 0 else None
    return {
        "n_requests": n_requests,
        "max_tokens": max_tokens,
        "decode_steps": 1,
        "model": model,
        "unmasked_tokens_per_s": round(unmasked, 2),
        "masked_tokens_per_s": round(masked, 2),
        "overhead_pct": overhead_pct,
        "structured_stats": {
            k: v for k, v in eng.stats().items()
            if k.startswith("structured")},
        "streams": streams,
    }


def run_structured_ab(*, n_requests: int = 8, max_tokens: int = 32,
                      repeats: int = 3, skip_overhead: bool = False,
                      device="cuda", model: str = "tiny-llama",
                      dtype: Optional[str] = None) -> dict:
    """Both conformance surfaces (one server) and the overhead legs."""
    httpd, core, base, bias = conformance_server(device)
    try:
        guided = run_corpus_conformance("guided", base, bias)
        rf = run_corpus_conformance("response_format", base, bias)
        requests = core.stats()["structured_requests_total"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    guided["engine_structured_requests"] = rf[
        "engine_structured_requests"] = requests
    overhead = None if skip_overhead else run_engine_overhead(
        n_requests=n_requests, max_tokens=max_tokens, repeats=repeats,
        device=device, model=model, dtype=dtype)
    return {
        "metric": "structured_output_ab",
        "unit": "mask_overhead_pct",
        "value": overhead["overhead_pct"] if overhead else None,
        "conformance_guided": guided,
        "conformance_response_format": rf,
        "overhead": overhead,
    }


def main(argv=None) -> dict:
    from production_stack_tpu_torch.probes import _profile_common as common

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--model", default="tpu-llama-1b",
                    help="the overhead legs' model")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    device = common.resolve_device(args.device)
    out = run_structured_ab(n_requests=args.requests,
                            max_tokens=args.max_tokens,
                            repeats=args.repeats, device=device,
                            model=args.model, dtype=args.dtype)
    out["overhead"].pop("streams")
    out.update(common.card(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
