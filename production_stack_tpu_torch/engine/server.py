"""OpenAI-compatible HTTP server over the torch ``EngineCore``.

Standard library only (``http.server.ThreadingHTTPServer``; one thread
per connection, server-sent events written by hand for ``stream: true``,
``/metrics`` as plain Prometheus text). Routes:

- ``POST /v1/completions`` and ``POST /v1/chat/completions``, plain and
  streamed (``data: {...}`` events ending with ``data: [DONE]``), with
  structured output (``guided_json``, ``guided_regex``,
  ``response_format``; compiled here, an uncompilable one is a 400),
  ``n > 1`` (``n`` engine requests, choice ``i > 0`` as ``"{id}-c{i}"``
  under seed ``base + i``; streamed chunks carry each choice's
  ``index``, interleaved from a merged queue fed by a thread a choice)
  and, on chat, ``tools`` (a system preamble, and tool calls parsed from
  the whole text: a streamed response with tools is buffered);
- ``GET /v1/models`` and ``GET /health``;
- ``GET /metrics`` with the series the router's scraper parses
  (``vllm:num_requests_running``/``_waiting``,
  ``vllm:gpu_cache_usage_perc``, ``vllm:gpu_prefix_cache_hits_total``/
  ``_queries_total``), their ``tpu:`` twins, ``tpu:hbm_headroom_bytes``,
  ``tpu:kv_cache_bytes_per_token`` labelled with ``kv_cache_dtype`` and,
  the JAX server's ``tpu:spec_*`` series (speculative decoding), its
  ``tpu:structured_*`` series and, with the step recorder on, its
  ``tpu:step_*`` series and ``tpu:model_bandwidth_utilization``;
- ``GET /debug/steps`` (step recorder on): newest-first step records
  under the recorder's summary; filters ``?limit=50`` and
  ``?kind=decode_burst``, 400 on a bad one, as the JAX engine serves it.

A request that fails inside the engine finishes with ``finish_reason:
"error"``.

    python -m production_stack_tpu_torch.engine.server <model> --port N \\
        [--device cuda|cpu] [--kv-cache-dtype int8] [--quantization int8] \\
        [--prefill-batch 4] [--enable-chunked-prefill] \\
        [--max-num-batched-tokens N] [--no-step-recorder] \\
        [--structured-cache-size 32] \\
        [--speculative-num-tokens 4 [--speculative-ngram-size 3] \\
         [--speculative-draft-model M --speculative-draft-probation 64]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core import EngineCore
from production_stack_tpu_torch.engine.sampling import (
    MAX_LOGIT_BIAS,
    SamplingParams,
)
from production_stack_tpu_torch.engine.tokenizer import IncrementalDetokenizer
from production_stack_tpu_torch.engine.tools import (
    parse_tool_calls,
    render_tools_preamble,
    tool_names,
)
from production_stack_tpu_torch.obs.steps import STEP_KINDS
from production_stack_tpu_torch.structured.api import compile_char_dfa
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

MAX_BODY_BYTES = 32 << 20
# How long a handler waits for the engine's next token before giving up.
TOKEN_TIMEOUT_S = 600.0


class BadRequest(Exception):
    def __init__(self, message: str, status: int = 400,
                 kind: str = "BadRequestError"):
        super().__init__(message)
        self.status = status
        self.kind = kind


class EngineServer:
    """The OpenAI surface of one engine: request parsing, the token
    stream from the engine thread, and the response bodies."""

    def __init__(self, core: EngineCore, served_models: List[str]):
        self.core = core
        self.config = core.config
        self.served_models = served_models
        self.start_time = time.time()

    # -- helpers -------------------------------------------------------------
    def check_model(self, model: str) -> None:
        if model not in self.served_models and model != self.config.model:
            raise BadRequest(f"model {model!r} not found", 404,
                             "NotFoundError")

    def parse_sampling(self, body: dict, default_max_tokens: int):
        """The request's SamplingParams; a malformed field or a structured
        constraint that does not compile is a 400 (the automaton is
        compiled here, before admission, and memoized, so the engine's
        own compile is a cache hit)."""
        try:
            sampling = SamplingParams.from_request(
                body, default_max_tokens=default_max_tokens)
            if sampling.structured is not None:
                compile_char_dfa(sampling.structured)
        except ValueError as exc:  # StructuredError is a ValueError
            raise BadRequest(str(exc))
        if sampling.logit_bias and len(sampling.logit_bias) > MAX_LOGIT_BIAS:
            raise BadRequest(
                f"logit_bias supports at most {MAX_LOGIT_BIAS} entries on "
                f"this engine (got {len(sampling.logit_bias)})")
        return sampling

    def check_prompt(self, prompt_ids: List[int]) -> None:
        if len(prompt_ids) >= self.config.max_model_len:
            raise BadRequest(
                f"prompt ({len(prompt_ids)} tokens) exceeds max_model_len "
                f"{self.config.max_model_len}")
        if self.core.kv_never_fits(len(prompt_ids)):
            raise BadRequest(
                f"prompt ({len(prompt_ids)} tokens) exceeds this engine's "
                f"KV cache capacity", 503, "ServiceUnavailable")

    def lp_entry(self, token_id: int, lp: dict) -> dict:
        """One OpenAI chat-logprobs content entry."""
        def entry(tid, logprob):
            text = self.core.tokenizer.decode([tid])
            return {"token": text, "logprob": logprob,
                    "bytes": list(text.encode())}

        return dict(entry(token_id, lp["logprob"]), top_logprobs=[
            entry(tid, tlp) for tid, tlp in lp["top"]])

    @staticmethod
    def completions_logprobs(entries: List[dict]) -> dict:
        """Chat-style entries -> the legacy completions logprobs object."""
        offsets, pos = [], 0
        for e in entries:
            offsets.append(pos)
            pos += len(e["token"])
        return {
            "tokens": [e["token"] for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [{t["token"]: t["logprob"]
                              for t in e["top_logprobs"]} for e in entries],
            "text_offset": offsets,
        }

    @staticmethod
    def apply_stop(text_so_far: str, delta: str, stop):
        """(emit_delta, stopped): stop strings end the output, unemitted."""
        if not stop:
            return delta, False
        combined = text_so_far + delta
        for s in stop:
            idx = combined.find(s)
            if idx >= 0:
                return combined[len(text_so_far):idx], True
        return delta, False

    def generate(self, body: dict, kind: str):
        """Admit a request's ``n`` choices. Returns (request id, model,
        prompt ids, sampling, a token stream of :meth:`_stream` a choice);
        parsing errors raise BadRequest before anything reaches the
        engine. Choice ``i > 0`` runs as ``"{rid}-c{i}"`` under seed
        ``base + i``, ``base`` the request's seed or, unseeded, the seed
        the engine draws choice 0 under."""
        model = body.get("model", self.config.model)
        self.check_model(model)
        tok = self.core.tokenizer
        if kind == "chat":
            messages = body.get("messages", [])
            tools = body.get("tools") or []
            if tools and body.get("tool_choice") != "none":
                # The function schemas and the <tool_call> output contract
                # lead the system context; tool_choice "none" skips both
                # the preamble and the output parsing.
                messages = [{"role": "system",
                             "content": render_tools_preamble(
                                 tools, body.get("tool_choice", "auto"))}
                            ] + list(messages)
            prompt_ids = tok.encode(tok.apply_chat_template(messages))
            sampling = self.parse_sampling(body, default_max_tokens=128)
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list) and prompt and isinstance(prompt[0],
                                                                  list):
                prompt = prompt[0]
            if isinstance(prompt, list) and prompt and all(
                    isinstance(t, int) for t in prompt):
                prompt_ids = [int(t) for t in prompt]
            else:
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
                prompt_ids = tok.encode(str(prompt))
            sampling = self.parse_sampling(body, default_max_tokens=16)
        self.check_prompt(prompt_ids)
        rid = f"{'chatcmpl' if kind == 'chat' else 'cmpl'}-{uuid.uuid4().hex[:16]}"
        streams = [self._admit(rid, prompt_ids, sampling)]
        base_seed = (sampling.seed if sampling.seed is not None
                     else hash(rid) % (2**31))
        for i in range(1, sampling.n):
            streams.append(self._admit(
                f"{rid}-c{i}", prompt_ids,
                dataclasses.replace(sampling, seed=base_seed + i, n=1)))
        return rid, model, prompt_ids, sampling, streams

    def _admit(self, rid: str, prompt_ids: List[int], sampling):
        """Queue one engine request; returns its token stream."""
        tokens: "queue.Queue" = queue.Queue()
        self.core.add_request(rid, prompt_ids, sampling,
                              lambda t, f: tokens.put((t, f)))
        return self._stream(rid, tokens, sampling)

    def _stream(self, rid, tokens: "queue.Queue", sampling):
        """Yields (text_delta, logprob_entry | None, finish | None,
        is_token) until a finish reason arrives."""
        detok = IncrementalDetokenizer(self.core.tokenizer)
        text_so_far = ""
        try:
            while True:
                try:
                    payload, finish = tokens.get(timeout=TOKEN_TIMEOUT_S)
                except queue.Empty:
                    yield "", None, "error", False
                    return
                entry = None
                if payload is None:
                    # Bytes held back as a partial UTF-8 sequence at the
                    # finish are dropped, as the JAX server drops them.
                    delta, is_token = "", False
                    finish = finish or "stop"
                else:
                    token_id, lp = (payload if isinstance(payload, tuple)
                                    else (payload, None))
                    if lp is not None:
                        entry = self.lp_entry(token_id, lp)
                    delta, is_token = detok.push(token_id), True
                emit, stopped = self.apply_stop(text_so_far, delta,
                                                sampling.stop)
                text_so_far += emit
                if stopped:
                    finish = "stop"
                yield emit, entry, finish, is_token
                if finish is not None:
                    return
        finally:
            # Finished, stopped by a stop string, or the client went away:
            # the engine drops the request (a no-op once it has finished).
            self.core.abort_request(rid)

    def metrics_text(self) -> str:
        s = self.core.stats()
        labels = f'model_name="{self.config.model}"'
        headroom = s.get("hbm_headroom_bytes")
        rows = [
            ("vllm:num_requests_running", "gauge", s["num_requests_running"]),
            ("vllm:num_requests_waiting", "gauge", s["num_requests_waiting"]),
            ("vllm:gpu_cache_usage_perc", "gauge", f"{s['kv_usage']:.6f}"),
            ("tpu:hbm_kv_usage_perc", "gauge", f"{s['kv_usage']:.6f}"),
            ("vllm:gpu_prefix_cache_hits_total", "counter",
             s["prefix_cache_hits"]),
            ("vllm:gpu_prefix_cache_queries_total", "counter",
             s["prefix_cache_queries"]),
            ("tpu:prefix_cache_hits_total", "counter", s["prefix_cache_hits"]),
            ("tpu:prefix_cache_queries_total", "counter",
             s["prefix_cache_queries"]),
            ("vllm:prompt_tokens_total", "counter", s["prompt_tokens_total"]),
            ("vllm:generation_tokens_total", "counter",
             s["generation_tokens_total"]),
            ("vllm:request_success_total", "counter",
             s["requests_finished_total"]),
            ("vllm:num_preemptions_total", "counter",
             s["num_preempted_total"]),
            ("tpu:num_kv_blocks", "gauge", s["num_blocks"]),
            ("tpu:hbm_headroom_bytes", "gauge",
             0 if headroom is None else headroom),
            ("tpu:kv_cache_bytes_per_token", "gauge",
             s["kv_cache_bytes_per_token"],
             f',kv_cache_dtype="{s["kv_cache_dtype"]}"'),
            ("tpu:cached_prompt_tokens_total", "counter",
             s["cached_tokens_total"]),
            ("tpu:decode_forward_steps_total", "counter",
             s["decode_forward_steps_total"]),
            # Structured output: grammar constraints compiled to token FSMs
            # whose masks join the logit shaping.
            ("tpu:structured_requests_total", "counter",
             s["structured_requests_total"]),
            ("tpu:structured_compile_seconds_total", "counter",
             f"{s['structured_compile_seconds_total']:.6f}"),
            ("tpu:structured_mask_states_total", "counter",
             s["structured_mask_states_total"]),
            ("tpu:structured_violations_total", "counter",
             s["structured_violations_total"]),
        ]
        lines = []
        for name, kind, value, *extra in rows:
            family = name[:-len("_total")] if kind == "counter" else name
            lines.append(f"# TYPE {family} {kind}")
            lines.append(f"{name}{{{labels}{''.join(extra)}}} {value}")
        # Speculative decoding, as the JAX server exports it: proposed and
        # accepted draft tokens by proposer (both label values always
        # present), the acceptance rate, latched-off requests, verify
        # bursts and the drafter's own forwards (not target forwards).
        proposed = s["spec_proposed_tokens_total"]
        rate = (s["spec_accepted_tokens_total"] / proposed
                if proposed else 0.0)
        for family, key in (("tpu:spec_proposed_tokens",
                             "spec_proposed_by_source"),
                            ("tpu:spec_accepted_tokens",
                             "spec_accepted_by_source")):
            lines.append(f"# TYPE {family} counter")
            for source in ("ngram", "draft_model"):
                lines.append(f'{family}_total{{{labels},source="{source}"}} '
                             f"{s[key].get(source, 0)}")
        lines += ["# TYPE tpu:spec_acceptance_rate gauge",
                  f"tpu:spec_acceptance_rate{{{labels}}} {rate:.6f}"]
        for family, key in (
                ("tpu:spec_disabled_requests",
                 "spec_disabled_requests_total"),
                ("tpu:spec_verify_bursts", "spec_verify_bursts_total"),
                ("tpu:spec_draft_forward_steps",
                 "spec_draft_forward_steps_total")):
            lines += [f"# TYPE {family} counter",
                      f"{family}_total{{{labels}}} {s[key]}"]
        rec = self.core.step_recorder
        if rec is not None:
            # Step flight recorder, as the JAX server exports it: every
            # kind always present, so rate() never sees a series vanish.
            kind_stats = rec.kind_stats()
            lines.append("# TYPE tpu:step_duration_seconds summary")
            for kind in sorted(kind_stats):
                kl, ks = f'{labels},kind="{kind}"', kind_stats[kind]
                lines += [f"tpu:step_duration_seconds_sum{{{kl}}} "
                          f"{ks['wall_s']:.6f}",
                          f"tpu:step_duration_seconds_count{{{kl}}} "
                          f"{ks['count']}"]
            for family, key in (("tpu:step_scheduled_tokens", "tokens"),
                                ("tpu:step_hbm_bytes", "hbm_bytes")):
                lines.append(f"# TYPE {family} counter")
                for kind in sorted(kind_stats):
                    lines.append(f'{family}_total{{{labels},kind="{kind}"}} '
                                 f"{kind_stats[kind][key]}")
            lines += ["# TYPE tpu:model_bandwidth_utilization gauge",
                      f"tpu:model_bandwidth_utilization{{{labels}}} "
                      f"{rec.bandwidth_utilization():.6f}"]
        return "\n".join(lines) + "\n"

    def debug_steps(self, query: dict):
        """(status, body) of ``GET /debug/steps``: the recorder's summary,
        the pool's page occupancy and the newest-first records, filtered
        by ``limit`` and ``kind``; 400 on a bad filter."""
        rec = self.core.step_recorder
        try:
            limit = int(query.get("limit", 100) or 100)
        except ValueError:
            return 400, {"error": "limit must be an integer"}
        if limit < 1:
            return 400, {"error": "limit must be >= 1"}
        kind = query.get("kind") or None
        if kind is not None and kind not in STEP_KINDS:
            return 400, {"error": f"unknown kind {kind!r} "
                                  f"(one of: {', '.join(STEP_KINDS)})"}
        out = rec.summary()
        alloc = self.core.kv_mgr.allocator
        out["kv_page_occupancy"] = {
            "resident": self.core.num_blocks - alloc.num_free, "offload": 0}
        out["steps"] = rec.snapshot(limit=limit, kind=kind)
        return 200, out


class _Handler(BaseHTTPRequestHandler):
    server_version = "production-stack-tpu-torch"
    engine: EngineServer  # set on the subclass built by build_server

    def log_message(self, fmt, *args):  # route access logs to our logger
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, obj, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error(self, exc: BadRequest) -> None:
        self._send_json({"error": {"message": str(exc), "type": exc.kind}},
                        exc.status)

    def do_GET(self):  # noqa: N802 - http.server API
        path, _, qs = self.path.partition("?")
        if path == "/debug/steps" and \
                self.engine.core.step_recorder is not None:
            query = dict(urllib.parse.parse_qsl(qs))
            status, body = self.engine.debug_steps(query)
            self._send_json(body, status)
        elif path == "/health":
            self._send_json({"status": "ok"})
        elif path == "/v1/models":
            now = int(self.engine.start_time)
            self._send_json({"object": "list", "data": [
                {"id": m, "object": "model", "created": now,
                 "owned_by": "production-stack-tpu-torch"}
                for m in self.engine.served_models]})
        elif path == "/metrics":
            data = self.engine.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._send_json({"error": {"message": f"no route {path}",
                                       "type": "NotFoundError"}}, 404)

    def do_POST(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        kinds = {"/v1/completions": "completion",
                 "/v1/chat/completions": "chat"}
        if path not in kinds:
            self._send_json({"error": {"message": f"no route {path}",
                                       "type": "NotFoundError"}}, 404)
            return
        kind = kinds[path]
        try:
            body = self._read_json()
            rid, model, prompt_ids, sampling, streams = self.engine.generate(
                body, kind)
        except BadRequest as exc:
            self._send_error(exc)
            return
        # Tool calls are parsed from a choice's whole text, so a chat with
        # tools buffers its output.
        tools = (body.get("tools") or []) if kind == "chat" else []
        declared = (tool_names(tools)
                    if tools and body.get("tool_choice") != "none" else None)
        args = (kind, rid, model, prompt_ids, sampling, streams, declared)
        if len(streams) > 1:
            self._respond_n(bool(body.get("stream")), *args)
        elif body.get("stream"):
            self._respond_stream(*args)
        else:
            self._respond_full(*args)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            raise BadRequest("request body too large", 413)
        raw = self.rfile.read(length) if length else b"{}"
        try:
            body = json.loads(raw.decode("utf-8"))
        except (ValueError, RecursionError):
            raise BadRequest("request body is not valid JSON")
        if not isinstance(body, dict):
            raise BadRequest("request body must be a JSON object")
        return body

    def _chunk(self, kind, rid, model, created, choice) -> None:
        """Write one server-sent event of a streamed response."""
        obj = "chat.completion.chunk" if kind == "chat" else "text_completion"
        payload = {"id": rid, "object": obj, "created": created,
                   "model": model, "choices": [choice]}
        self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
        self.wfile.flush()

    @staticmethod
    def _tool_message(text: str, declared):
        """(message, tool calls) of a chat choice's whole text: the
        parsed calls and the text around them, or the text alone."""
        if declared is None:
            return {"role": "assistant", "content": text}, []
        content, calls = parse_tool_calls(text, declared)
        if not calls:
            return {"role": "assistant", "content": text}, []
        return ({"role": "assistant", "content": content or None,
                 "tool_calls": calls}, calls)

    @staticmethod
    def _tool_delta(index: int, text: str, declared, entries):
        """The one delta of a buffered (tools) streamed choice, and
        whether it carries calls; all of the choice's logprob entries
        ride it."""
        content, calls = parse_tool_calls(text, declared)
        delta = {"role": "assistant"}
        if calls:
            delta["tool_calls"] = [dict(tc, index=k)
                                   for k, tc in enumerate(calls)]
            if content:
                delta["content"] = content
        else:
            delta["content"] = text
        choice = {"index": index, "delta": delta, "finish_reason": None}
        if entries:
            choice["logprobs"] = {"content": entries}
        return choice, bool(calls)

    def _respond_full(self, kind, rid, model, prompt_ids, sampling, streams,
                      declared):
        pieces, entries, finish = [], [], "stop"
        n_generated = 0
        for delta, entry, reason, is_token in streams[0]:
            pieces.append(delta)
            n_generated += is_token
            if entry is not None:
                entries.append(entry)
            if reason is not None:
                finish = reason
        text = "".join(pieces)
        usage = {"prompt_tokens": len(prompt_ids),
                 "completion_tokens": n_generated,
                 "total_tokens": len(prompt_ids) + n_generated}
        created = int(time.time())
        if kind == "chat":
            message, calls = self._tool_message(text, declared)
            choice = {"index": 0, "message": message,
                      "finish_reason": "tool_calls" if calls else finish}
            if entries:
                choice["logprobs"] = {"content": entries}
            obj = "chat.completion"
        else:
            if sampling.echo:
                text = self.engine.core.tokenizer.decode(prompt_ids) + text
            choice = {"index": 0, "text": text, "finish_reason": finish}
            if entries:
                choice["logprobs"] = self.engine.completions_logprobs(entries)
            obj = "text_completion"
        self._send_json({"id": rid, "object": obj, "created": created,
                         "model": model, "choices": [choice],
                         "usage": usage})

    def _respond_stream(self, kind, rid, model, prompt_ids, sampling,
                        streams, declared):
        stream = streams[0]
        created = int(time.time())
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Request-Id", rid)
        self.end_headers()

        def event(delta: str, finish, first: bool, entries=None) -> None:
            if kind == "chat":
                d = {"role": "assistant"} if first else {}
                if delta:
                    d["content"] = delta
                choice = {"index": 0, "delta": d, "finish_reason": finish}
                if entries:
                    choice["logprobs"] = {"content": entries}
            else:
                choice = {"index": 0, "text": delta, "finish_reason": finish}
                if entries:
                    choice["logprobs"] = self.engine.completions_logprobs(
                        entries)
            self._chunk(kind, rid, model, created, choice)

        try:
            first = True
            if sampling.echo and kind == "completion":
                event(self.engine.core.tokenizer.decode(prompt_ids), None,
                      True)
                first = False
            pending: List[dict] = []
            finish = "stop"
            text = ""
            for delta, entry, reason, _ in stream:
                if entry is not None:
                    pending.append(entry)
                text += delta
                if declared is not None:
                    if reason is not None:
                        finish = reason
                        break
                    continue
                if reason is not None:
                    finish = reason
                    if delta:
                        event(delta, None, first, pending)
                        first, pending = False, []
                    break
                if delta or first:
                    event(delta, None, first, pending)
                    first, pending = False, []
            if declared is not None:
                choice, calls = self._tool_delta(0, text, declared, pending)
                self._chunk(kind, rid, model, created, choice)
                first, pending = False, []
                if calls:
                    finish = "tool_calls"
            event("", finish, first, pending)
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            stream.close()  # aborts the request in the engine

    def _respond_n(self, stream_mode: bool, kind, rid, model, prompt_ids,
                   sampling, streams, declared):
        """``n > 1``: the choices' streams, each drained by a thread of
        its own into one merged queue; a streamed response writes their
        chunks interleaved, tagged with the choice's ``index``, then a
        finish chunk a choice (after the buffered delta of a chat with
        tools), a whole one a choices array. A client that goes away
        aborts every choice."""
        n = len(streams)
        rids = [rid] + [f"{rid}-c{i}" for i in range(1, n)]
        texts, finishes, counts = [""] * n, ["stop"] * n, [0] * n
        lp_all: List[List[dict]] = [[] for _ in range(n)]
        # Entries whose text has not been written yet (held back by the
        # detokenizer, an EOS, a stop-trimmed tail): the finish chunk
        # drains them.
        pendings: List[List[dict]] = [[] for _ in range(n)]
        merged: "queue.Queue" = queue.Queue()

        def pump(i: int) -> None:
            try:
                for delta, entry, reason, is_token in streams[i]:
                    counts[i] += is_token
                    if entry is not None:
                        lp_all[i].append(entry)
                        pendings[i].append(entry)
                    texts[i] += delta
                    if reason is not None:
                        finishes[i] = reason
                    if delta:
                        merged.put((i, delta, pendings[i]))
                        pendings[i] = []
            finally:
                # The merge loop must not wait on a choice that is gone.
                merged.put((i, None, None))

        threads = [threading.Thread(target=pump, args=(i,), daemon=True,
                                    name=f"choice-{i}") for i in range(n)]
        for th in threads:
            th.start()
        created = int(time.time())
        chat = kind == "chat"
        try:
            if stream_mode:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Request-Id", rid)
                self.end_headers()
                if sampling.echo and not chat:
                    prompt_text = self.engine.core.tokenizer.decode(prompt_ids)
                    for i in range(n):
                        self._chunk(kind, rid, model, created, {
                            "index": i, "text": prompt_text,
                            "finish_reason": None})
            first = [True] * n
            live = n
            while live:
                i, emit, entries = merged.get()
                if emit is None:
                    live -= 1
                    continue
                if not stream_mode or declared is not None:
                    continue  # whole response, or parsed per choice below
                if chat:
                    delta = {"content": emit}
                    if first[i]:
                        delta = {"role": "assistant", "content": emit}
                    choice = {"index": i, "delta": delta,
                              "finish_reason": None}
                else:
                    choice = {"index": i, "text": emit,
                              "finish_reason": None}
                first[i] = False
                if entries:
                    choice["logprobs"] = (
                        {"content": entries} if chat
                        else self.engine.completions_logprobs(entries))
                self._chunk(kind, rid, model, created, choice)
            for th in threads:
                th.join()
            if stream_mode:
                for i in range(n):
                    finish = finishes[i]
                    if declared is not None:
                        choice, calls = self._tool_delta(i, texts[i],
                                                         declared, lp_all[i])
                        self._chunk(kind, rid, model, created, choice)
                        pendings[i] = []
                        if calls:
                            finish = "tool_calls"
                    choice = ({"index": i, "delta": {}, "finish_reason": finish}
                              if chat else {"index": i, "text": "",
                                            "finish_reason": finish})
                    if pendings[i]:
                        choice["logprobs"] = (
                            {"content": pendings[i]} if chat
                            else self.engine.completions_logprobs(pendings[i]))
                    self._chunk(kind, rid, model, created, choice)
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                return
        except (BrokenPipeError, ConnectionResetError):
            for r in rids:
                self.engine.core.abort_request(r)
            return
        choices = []
        for i in range(n):
            if chat:
                message, calls = self._tool_message(texts[i], declared)
                choice = {"index": i, "message": message,
                          "finish_reason": ("tool_calls" if calls
                                            else finishes[i])}
                if lp_all[i]:
                    choice["logprobs"] = {"content": lp_all[i]}
            else:
                text = texts[i]
                if sampling.echo:
                    text = self.engine.core.tokenizer.decode(prompt_ids) + text
                choice = {"index": i, "text": text,
                          "finish_reason": finishes[i]}
                if lp_all[i]:
                    choice["logprobs"] = self.engine.completions_logprobs(
                        lp_all[i])
            choices.append(choice)
        total = sum(counts)
        self._send_json({
            "id": rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": model, "choices": choices,
            "usage": {"prompt_tokens": len(prompt_ids),
                      "completion_tokens": total,
                      "total_tokens": len(prompt_ids) + total}})


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="OpenAI engine server on PyTorch (CUDA by default)")
    p.add_argument("model", nargs="?", default=None)
    p.add_argument("--model", dest="model_flag", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' needs a card and raises "
                        "without one")
    p.add_argument("--served-model-name", action="append", default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--quantization", default=None, choices=["int8"],
                   help="weight-only quantization: int8 weights + "
                        "per-channel scales (llama family)")
    p.add_argument("--kv-cache-dtype", default="bf16",
                   choices=["bf16", "int8"],
                   help="KV cache storage dtype: int8 stores quantized "
                        "K/V pages with per-token per-kv-head f32 scales, "
                        "halving KV traffic and roughly doubling KV "
                        "capacity at equal memory")
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--block-size", type=int, default=64)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--hbm-utilization", type=float, default=0.7)
    p.add_argument("--hbm-headroom-reserve", type=float, default=0.0,
                   help="GiB of device memory kept free when auto-sizing "
                        "the KV pool")
    p.add_argument("--enable-prefix-caching", action="store_true",
                   default=True)
    p.add_argument("--no-enable-prefix-caching",
                   dest="enable_prefix_caching", action="store_false")
    p.add_argument("--max-loras", type=int, default=8)
    p.add_argument("--max-lora-rank", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefill-chunk-size", type=int, default=1024)
    p.add_argument("--enable-chunked-prefill", action="store_true",
                   default=False,
                   help="chunked prefill: schedule prompt prefills as "
                        "bucket-snapped chunks interleaved with decode "
                        "steps, bounded per step by "
                        "--max-num-batched-tokens")
    p.add_argument("--max-num-batched-tokens", type=int, default=0,
                   help="per-step prefill token budget of chunked prefill "
                        "(0 with --enable-chunked-prefill: use "
                        "--prefill-chunk-size; > 0 also enables it)")
    p.add_argument("--max-consecutive-prefills", type=int, default=2,
                   help="chunked prefill: force a decode step after this "
                        "many consecutive prefill steps while sequences "
                        "are running")
    p.add_argument("--structured-cache-size", type=int, default=32,
                   help="LRU capacity of the compiled structured-output "
                        "token-FSM cache (one entry per distinct "
                        "schema/regex per tokenizer)")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="batch up to N queued long-prompt prefills into "
                        "one dispatch during an arrival storm (1 "
                        "disables)")
    p.add_argument("--speculative-num-tokens", type=int, default=0,
                   help="speculative decoding: verify up to this many "
                        "tokens per forward pass; 0 disables. Drafts come "
                        "from the draft model when "
                        "--speculative-draft-model is set, otherwise from "
                        "prompt lookup (an n-gram index over each "
                        "request's own prompt+output)")
    p.add_argument("--speculative-ngram-size", type=int, default=3,
                   help="n-gram length matched by the prompt-lookup "
                        "draft index (ignored when a draft model is "
                        "configured)")
    p.add_argument("--speculative-draft-model", default=None,
                   help="zoo model that drafts for the target (same "
                        "vocab; e.g. tpu-llama-1b drafting for "
                        "Llama-3-8B), with its own weights and page pool "
                        "in the model dtype on the same device; replaces "
                        "the prompt-lookup proposer")
    p.add_argument("--speculative-draft-probation", type=int, default=64,
                   help="plain bursts after which a request whose "
                        "draft-model speculation was adaptively latched "
                        "off retries drafting (0 = latch is permanent, "
                        "as prompt-lookup latches always are)")
    p.add_argument("--no-step-recorder", dest="step_recorder",
                   action="store_false", default=True,
                   help="disable the per-step flight recorder "
                        "(/debug/steps + tpu:step_* metrics)")
    p.add_argument("--step-record-capacity", type=int, default=1024,
                   help="step records kept in the flight-recorder ring")
    p.add_argument("--chat-template", default=None,
                   help="custom jinja chat-template file (HF checkpoints)")
    return p


def config_from_args(args) -> EngineConfig:
    return EngineConfig(
        model=args.model_flag or args.model or "tiny-llama",
        device=args.device,
        dtype=args.dtype,
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        max_model_len=args.max_model_len,
        max_num_seqs=args.max_num_seqs,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        hbm_utilization=args.hbm_utilization,
        hbm_headroom_reserve=int(args.hbm_headroom_reserve * (1 << 30)),
        enable_prefix_caching=args.enable_prefix_caching,
        max_loras=args.max_loras,
        max_lora_rank=args.max_lora_rank,
        seed=args.seed,
        prefill_chunk_size=args.prefill_chunk_size,
        prefill_batch=args.prefill_batch,
        enable_chunked_prefill=args.enable_chunked_prefill,
        max_num_batched_tokens=args.max_num_batched_tokens,
        max_consecutive_prefills=args.max_consecutive_prefills,
        structured_cache_size=args.structured_cache_size,
        speculative_num_tokens=args.speculative_num_tokens,
        speculative_ngram_size=args.speculative_ngram_size,
        speculative_draft_model=args.speculative_draft_model,
        speculative_draft_probation=args.speculative_draft_probation,
        step_recorder=args.step_recorder,
        step_record_capacity=args.step_record_capacity,
        chat_template=args.chat_template,
    )


def build_server(argv: Optional[List[str]] = None,
                 core: Optional[EngineCore] = None):
    """Parse ``argv``, build (or take) the engine, start its thread and
    bind the HTTP server. Returns (httpd, core); the caller runs
    ``httpd.serve_forever()`` and, to stop, ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``core.stop()``."""
    args = build_arg_parser().parse_args(argv)
    if core is None:
        core = EngineCore(config_from_args(args))
    core.start()
    served = args.served_model_name or [core.config.model]
    handler = type("Handler", (_Handler,), {
        "engine": EngineServer(core, served)})
    httpd = ThreadingHTTPServer((args.host, args.port), handler)
    httpd.daemon_threads = True
    return httpd, core


def main(argv: Optional[List[str]] = None) -> None:
    httpd, core = build_server(argv)
    host, port = httpd.server_address[:2]
    logger.info("Serving %s on http://%s:%d (device %s)",
                core.config.model, host, port, core.config.device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        core.stop()


if __name__ == "__main__":
    main()
