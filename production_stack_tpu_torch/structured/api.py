"""Request-surface API for structured output.

``parse_structured`` maps the OpenAI-compatible request fields —
``response_format`` (``json_object`` / ``json_schema``) and the vLLM
extensions ``guided_json`` / ``guided_regex`` — to a canonical
:class:`StructuredSpec`. ``compile_char_dfa`` compiles a spec to its
byte-level automaton with a small process-wide memo, cheap enough for
the router to *validate* schemas tokenizer-free (400 on uncompilable)
while the engine builds the token-level FSM on top of the same DFA.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import OrderedDict
from typing import Any, Optional

from production_stack_tpu_torch.structured.regex_dfa import (
    CharDFA, StructuredError, compile_regex)
from production_stack_tpu_torch.structured.schema import (
    json_object_regex, schema_to_regex)


@dataclasses.dataclass(frozen=True)
class StructuredSpec:
    """Canonical structured-output constraint.

    ``kind`` is ``json_schema`` / ``json_object`` / ``regex``; ``spec``
    is the canonical payload (sorted-key compact JSON for schemas, the
    raw pattern for regexes) so equal constraints hash equally across
    requests regardless of key order in the wire form.
    """

    kind: str
    spec: str

    def schema(self) -> Any:
        return json.loads(self.spec) if self.kind == "json_schema" else None


def _canon_schema(schema: Any) -> str:
    return json.dumps(schema, separators=(",", ":"), sort_keys=False,
                      ensure_ascii=False)


def parse_structured(body: dict) -> Optional[StructuredSpec]:
    """Extract the structured constraint from a request body, or None.

    Raises :class:`StructuredError` on malformed fields or conflicting
    constraints (callers map that to 400).
    """
    guided_json = body.get("guided_json")
    guided_regex = body.get("guided_regex")
    rf = body.get("response_format")
    specs = []
    if guided_json is not None:
        if isinstance(guided_json, str):
            try:
                guided_json = json.loads(guided_json)
            except ValueError:
                raise StructuredError("guided_json is not valid JSON")
        if not isinstance(guided_json, (dict, bool)):
            raise StructuredError("guided_json must be a JSON Schema object")
        specs.append(StructuredSpec("json_schema",
                                    _canon_schema(guided_json)))
    if guided_regex is not None:
        if not isinstance(guided_regex, str) or not guided_regex:
            raise StructuredError(
                "guided_regex must be a non-empty string")
        specs.append(StructuredSpec("regex", guided_regex))
    if rf is not None:
        if not isinstance(rf, dict):
            raise StructuredError("response_format must be an object")
        rf_type = rf.get("type")
        if rf_type in (None, "text"):
            pass
        elif rf_type == "json_object":
            specs.append(StructuredSpec("json_object", ""))
        elif rf_type == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict):
                raise StructuredError(
                    "response_format.json_schema must be an object")
            schema = js.get("schema", js if "type" in js else None)
            if schema is None:
                raise StructuredError(
                    "response_format.json_schema.schema is required")
            specs.append(StructuredSpec("json_schema",
                                        _canon_schema(schema)))
        else:
            raise StructuredError(
                f"unsupported response_format type {rf_type!r}")
    if len(specs) > 1:
        raise StructuredError(
            "at most one of guided_json / guided_regex / response_format "
            "may constrain a request")
    return specs[0] if specs else None


# Tokenizer-free CharDFA memo: router-side validation and the fake
# engine compile the same spec repeatedly; the automaton is immutable.
_DFA_MEMO: "OrderedDict[tuple, CharDFA]" = OrderedDict()
_DFA_MEMO_MAX = 128
_DFA_LOCK = threading.Lock()


def spec_regex(spec: StructuredSpec) -> str:
    if spec.kind == "regex":
        return spec.spec
    if spec.kind == "json_object":
        return json_object_regex()
    if spec.kind == "json_schema":
        return schema_to_regex(json.loads(spec.spec))
    raise StructuredError(f"unknown structured kind {spec.kind!r}")


def compile_char_dfa(spec: StructuredSpec) -> CharDFA:
    """Compile (memoized) the byte-level automaton for ``spec``."""
    key = (spec.kind, spec.spec)
    with _DFA_LOCK:
        got = _DFA_MEMO.get(key)
        if got is not None:
            _DFA_MEMO.move_to_end(key)
            return got
    dfa = compile_regex(spec_regex(spec))
    with _DFA_LOCK:
        _DFA_MEMO[key] = dfa
        while len(_DFA_MEMO) > _DFA_MEMO_MAX:
            _DFA_MEMO.popitem(last=False)
    return dfa
