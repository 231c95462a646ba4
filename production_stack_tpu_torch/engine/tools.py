"""OpenAI tool-calling support for the engine's chat surface.

The reference stack gets tool calls from vLLM's parser plugins
(``--enable-auto-tool-choice``; reference
``tutorials/13-tool-enabled-installation.md``, ``docs/source/use_cases``).
This module is the TPU engine's native equivalent:

- :func:`render_tools_preamble` — folds the request's ``tools`` schema
  into the prompt (hermes-style: a system preamble listing the function
  signatures and the ``<tool_call>`` output contract — the format most
  tool-tuned open models emit).
- :func:`parse_tool_calls` — extracts tool calls from generated text:
  ``<tool_call>{...}</tool_call>`` blocks, or a bare leading JSON object
  with ``name`` + ``arguments`` keys.

Parsing is schema-driven, not model-specific: any checkpoint that emits
the hermes contract (or raw JSON) serves tools; others degrade to plain
text, exactly like vLLM with a mismatched parser.
"""

from __future__ import annotations

import json
import uuid
from typing import List, Optional, Tuple

TOOL_OPEN = "<tool_call>"
TOOL_CLOSE = "</tool_call>"


def render_tools_preamble(tools: List[dict],
                          tool_choice="auto") -> str:
    """System-preamble text describing the callable functions and the
    output contract. Appended to the system context before templating."""
    if not tools:
        return ""
    lines = [
        "You have access to the following functions. To call a function, "
        "respond with a <tool_call>{\"name\": ..., \"arguments\": {...}}"
        "</tool_call> block.",
        "<tools>",
    ]
    for tool in tools:
        fn = tool.get("function", tool)
        lines.append(json.dumps({
            "name": fn.get("name"),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters", {}),
        }, sort_keys=True))
    lines.append("</tools>")
    if isinstance(tool_choice, dict):
        forced = tool_choice.get("function", {}).get("name")
        if forced:
            lines.append(f"You must call the function {forced!r}.")
    elif tool_choice == "required":
        lines.append("You must call at least one function.")
    return "\n".join(lines)


def _try_parse(fragment: str) -> Optional[dict]:
    """One tool-call candidate -> {"name", "arguments"} or None."""
    try:
        obj = json.loads(fragment)
    except ValueError:
        return None
    if not isinstance(obj, dict) or "name" not in obj:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except ValueError:
            pass  # keep the raw string (OpenAI allows any string)
    return {"name": str(obj["name"]),
            "arguments": args if isinstance(args, str)
            else json.dumps(args)}


def _leading_json_object(text: str) -> Optional[str]:
    """The balanced JSON object at the start of ``text`` (brace scan that
    respects strings), or None."""
    start = text.find("{")
    if start == -1 or text[:start].strip():
        return None
    depth = 0
    in_str = False
    escape = False
    for i in range(start, len(text)):
        ch = text[i]
        if escape:
            escape = False
        elif ch == "\\":
            escape = in_str
        elif ch == '"':
            in_str = not in_str
        elif not in_str:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    return text[start : i + 1]
    return None


def parse_tool_calls(text: str,
                     allowed_names: Optional[List[str]] = None
                     ) -> Tuple[str, List[dict]]:
    """Generated text -> (content_without_tool_calls, tool_calls).

    tool_calls entries follow the OpenAI schema: {"id", "type":
    "function", "function": {"name", "arguments"}}. Malformed
    ``<tool_call>`` fragments stay in the content (degrade to plain text,
    never silently dropped). The bare-JSON fallback only fires when the
    object's name matches a DECLARED tool (``allowed_names``) — an answer
    that merely happens to be JSON with a "name" key is not a call."""
    calls: List[dict] = []
    content_parts: List[str] = []
    rest = text
    while True:
        idx = rest.find(TOOL_OPEN)
        if idx == -1:
            break
        content_parts.append(rest[:idx])
        end = rest.find(TOOL_CLOSE, idx)
        if end == -1:
            fragment = rest[idx + len(TOOL_OPEN):]
            rest = ""
        else:
            fragment = rest[idx + len(TOOL_OPEN): end]
            rest = rest[end + len(TOOL_CLOSE):]
        parsed = _try_parse(fragment.strip())
        if parsed is not None:
            calls.append(parsed)
        else:
            content_parts.append(fragment)
        if not rest:
            break
    content_parts.append(rest)
    if not calls:
        # Bare-JSON contract: the whole reply is one call object naming a
        # declared tool.
        fragment = _leading_json_object(text)
        if fragment:
            parsed = _try_parse(fragment)
            if parsed is not None and (
                    allowed_names is None
                    or parsed["name"] in allowed_names):
                calls.append(parsed)
                content_parts = [text[len(fragment):]]
    tool_calls = [
        {"id": f"call_{uuid.uuid4().hex[:24]}", "type": "function",
         "function": c}
        for c in calls
    ]
    content = "".join(content_parts).strip()
    return content, tool_calls


def tool_names(tools: List[dict]) -> List[str]:
    return [
        str(t.get("function", t).get("name")) for t in tools or []
    ]
