"""JSON Schema -> regex lowering for the structured-output compiler.

A supported-subset JSON Schema is lowered to a regex over *compact* JSON
(no insignificant whitespace, object properties in declared order), which
then compiles through ``regex_dfa`` into the byte-level automaton the
token FSM is built on. The subset covers what agent/pipeline traffic
actually sends:

- ``type``: string / number / integer / boolean / null / object / array
- ``enum`` / ``const`` (any JSON scalar, plus exact objects/arrays)
- ``properties`` + ``required`` (optional properties may only be omitted
  right-to-left — a regex can't express free-order omission without an
  exponential alternation; declared order is the generation order)
- ``items`` with ``minItems`` / ``maxItems`` (unbounded tail allowed)
- ``anyOf`` / ``oneOf`` -> alternation
- string ``minLength`` / ``maxLength`` and integer ``minDigits`` via
  bounded repetition

``response_format={"type": "json_object"}`` lowers to a generic JSON
*object* grammar bounded to :data:`JSON_OBJECT_DEPTH` nesting levels
(a DFA cannot count unbounded brackets; three levels covers the
free-form "just give me JSON" traffic this mode exists for).

Unsupported keywords raise :class:`StructuredError` so the API layer
returns 400 instead of serving an unconstrained stream that claims to be
schema-bound.
"""

from __future__ import annotations

import json
import math
from typing import Any

from production_stack_tpu_torch.structured.regex_dfa import StructuredError

JSON_OBJECT_DEPTH = 3

# Regex fragments over compact JSON -----------------------------------------

# One JSON string: permissive bytewise body (any byte >= 0x20 except the
# quote/backslash, i.e. UTF-8 continuation bytes pass) plus standard
# escapes. Generation-side strictness comes from the model; the automaton
# guarantees the *shape* parses.
_STR_CHAR = r'[^"\\\x00-\x1f]'
_STR_ESC = r'\\["\\/bfnrt]|\\u[0-9a-fA-F]{4}'
STRING_RX = r'"(' + _STR_CHAR + r'|' + _STR_ESC + r')*"'
INTEGER_RX = r'-?(0|[1-9][0-9]*)'
NUMBER_RX = INTEGER_RX + r'(\.[0-9]+)?([eE][+-]?[0-9]+)?'
BOOL_RX = r'(true|false)'
NULL_RX = r'null'

_RX_META = set("\\.^$*+?()[]{}|")


def rx_escape(text: str) -> str:
    out = []
    for ch in text:
        if ch in _RX_META:
            out.append("\\" + ch)
        elif ord(ch) < 0x20:
            out.append("\\x%02x" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


def _const_rx(value: Any) -> str:
    """Regex matching exactly the compact-JSON rendering of ``value``."""
    return rx_escape(json.dumps(value, separators=(",", ":"),
                                ensure_ascii=False))


def _string_rx(schema: dict) -> str:
    lo = schema.get("minLength")
    hi = schema.get("maxLength")
    if lo is None and hi is None:
        return STRING_RX
    lo = int(lo or 0)
    body = "(" + _STR_CHAR + "|" + _STR_ESC + ")"
    if hi is None:
        return '"' + body + "{%d,}" % lo + '"'
    return '"' + body + "{%d,%d}" % (lo, int(hi)) + '"'


def _array_rx(schema: dict, depth: int) -> str:
    item = schema.get("items")
    item_rx = (schema_to_regex(item, depth + 1) if isinstance(item, dict)
               else _value_rx(JSON_OBJECT_DEPTH - 1))
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if hi is not None:
        hi = int(hi)
        if hi < lo:
            raise StructuredError("maxItems < minItems")
        if hi == 0:
            return r"\[\]"
    head = "(" + item_rx + ")"
    tail = "(," + item_rx + ")"
    if lo == 0:
        if hi is None:
            rest = tail + "*"
        else:
            rest = tail + "{0,%d}" % (hi - 1)
        return r"\[\]|\[" + head + rest + r"\]"
    if hi is None:
        rest = tail + "{%d,}" % (lo - 1)
    else:
        rest = tail + "{%d,%d}" % (lo - 1, hi - 1)
    return r"\[" + head + rest + r"\]"


def _object_rx(schema: dict, depth: int) -> str:
    props = schema.get("properties") or {}
    if not isinstance(props, dict):
        raise StructuredError("'properties' must be an object")
    required = set(schema.get("required") or [])
    unknown_req = required - set(props)
    if unknown_req:
        raise StructuredError(
            f"required properties missing from 'properties': "
            f"{sorted(unknown_req)}")
    if not props:
        if schema.get("additionalProperties", True) is False:
            return r"\{\}"
        return _generic_object_rx(JSON_OBJECT_DEPTH)
    names = list(props)
    # Optional properties must form a suffix of the declared order: JSON
    # commas make free-order omission non-regular without exponential
    # enumeration. Reject interleaved optionality loudly.
    opt_started = False
    for name in names:
        if name in required:
            if opt_started:
                raise StructuredError(
                    "optional properties must come after all required "
                    "ones in declared order (regex lowering is "
                    "suffix-optional)")
        else:
            opt_started = True
    pieces = []
    n_required = sum(1 for n in names if n in required)
    for idx, name in enumerate(names):
        val = schema_to_regex(props[name], depth + 1)
        member = rx_escape(json.dumps(name, ensure_ascii=False)) + ":" \
            + "(" + val + ")"
        if name in required:
            pieces.append(("," if idx else "") + member)
        else:
            lead = "," if idx else ""
            pieces.append("(" + lead + member)
    # Optional members nest right-to-left: each later optional is only
    # reachable when the earlier ones are present (the suffix rule).
    rx = "".join(pieces) + ")?" * (len(names) - n_required)
    return r"\{" + rx + r"\}"


def _value_rx(depth: int) -> str:
    """Generic JSON value, ``depth`` more nesting levels allowed."""
    scalars = "|".join((STRING_RX, NUMBER_RX, BOOL_RX, NULL_RX))
    if depth <= 0:
        return "(" + scalars + ")"
    inner = _value_rx(depth - 1)
    obj = _generic_object_rx_from(inner)
    arr = r"(\[\]|\[(" + inner + r")(,(" + inner + r"))*\])"
    return "(" + scalars + "|" + obj + "|" + arr + ")"


def _generic_object_rx_from(inner: str) -> str:
    member = "(" + STRING_RX + "):(" + inner + ")"
    return r"(\{\}|\{" + member + "(," + member + r")*\})"


def _generic_object_rx(depth: int) -> str:
    return _generic_object_rx_from(_value_rx(depth - 1))


def json_object_regex(depth: int = JSON_OBJECT_DEPTH) -> str:
    """``response_format={"type": "json_object"}``: any JSON object,
    bounded nesting."""
    return _generic_object_rx(depth)


def schema_to_regex(schema: Any, depth: int = 0) -> str:
    """Lower a JSON Schema (supported subset) to a compact-JSON regex."""
    if depth > 32:
        raise StructuredError("schema nesting too deep")
    if schema is True or schema == {}:
        return _value_rx(JSON_OBJECT_DEPTH - 1)
    if not isinstance(schema, dict):
        raise StructuredError("schema must be an object")
    if "const" in schema:
        return _const_rx(schema["const"])
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise StructuredError("'enum' must be a non-empty array")
        return "(" + "|".join(_const_rx(v) for v in vals) + ")"
    for comb in ("anyOf", "oneOf"):
        if comb in schema:
            alts = schema[comb]
            if not isinstance(alts, list) or not alts:
                raise StructuredError(f"'{comb}' must be a non-empty array")
            return "(" + "|".join(
                schema_to_regex(a, depth + 1) for a in alts) + ")"
    for unsupported in ("allOf", "not", "patternProperties", "$ref",
                        "if", "then", "else", "dependentSchemas"):
        if unsupported in schema:
            raise StructuredError(
                f"unsupported JSON Schema keyword {unsupported!r}")
    typ = schema.get("type")
    if isinstance(typ, list):
        return "(" + "|".join(
            schema_to_regex({**schema, "type": t}, depth + 1)
            for t in typ) + ")"
    if typ == "string":
        return _string_rx(schema)
    if typ == "integer":
        return INTEGER_RX
    if typ == "number":
        return NUMBER_RX
    if typ == "boolean":
        return BOOL_RX
    if typ == "null":
        return NULL_RX
    if typ == "array":
        return _array_rx(schema, depth)
    if typ == "object":
        return _object_rx(schema, depth)
    if typ is None:
        if "properties" in schema:
            return _object_rx(schema, depth)
        if "items" in schema:
            return _array_rx(schema, depth)
        return _value_rx(JSON_OBJECT_DEPTH - 1)
    raise StructuredError(f"unsupported schema type {typ!r}")


# Instance validation --------------------------------------------------------


def validate_instance(schema: Any, instance: Any) -> bool:
    """Validate ``instance`` against the supported schema subset — used
    by the corpus lint and conformance harness as a second, independent
    check next to the automaton fullmatch."""
    if schema is True or schema == {}:
        return True
    if not isinstance(schema, dict):
        return False
    if "const" in schema:
        return instance == schema["const"]
    if "enum" in schema:
        return instance in schema["enum"]
    if "anyOf" in schema:
        return any(validate_instance(a, instance) for a in schema["anyOf"])
    if "oneOf" in schema:
        return sum(bool(validate_instance(a, instance))
                   for a in schema["oneOf"]) >= 1
    typ = schema.get("type")
    if isinstance(typ, list):
        return any(validate_instance({**schema, "type": t}, instance)
                   for t in typ)
    if typ == "string":
        if not isinstance(instance, str):
            return False
        if len(instance) < int(schema.get("minLength", 0)):
            return False
        if "maxLength" in schema and \
                len(instance) > int(schema["maxLength"]):
            return False
        return True
    if typ == "integer":
        return isinstance(instance, int) and not isinstance(instance, bool)
    if typ == "number":
        return (isinstance(instance, (int, float))
                and not isinstance(instance, bool)
                and math.isfinite(instance))
    if typ == "boolean":
        return isinstance(instance, bool)
    if typ == "null":
        return instance is None
    if typ == "array" or (typ is None and "items" in schema):
        if not isinstance(instance, list):
            return False
        if len(instance) < int(schema.get("minItems", 0)):
            return False
        if "maxItems" in schema and len(instance) > int(schema["maxItems"]):
            return False
        item = schema.get("items")
        if isinstance(item, dict):
            return all(validate_instance(item, v) for v in instance)
        return True
    if typ == "object" or (typ is None and "properties" in schema):
        if not isinstance(instance, dict):
            return False
        props = schema.get("properties") or {}
        for name in schema.get("required") or []:
            if name not in instance:
                return False
        for name, value in instance.items():
            if name in props:
                if not validate_instance(props[name], value):
                    return False
            elif schema.get("additionalProperties", True) is False:
                return False
        return True
    return True
