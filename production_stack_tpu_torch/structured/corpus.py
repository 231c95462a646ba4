"""Loader for the structured-output conformance corpus.

``corpus.json`` holds 30 constraint cases (regex / json_schema /
json_object), each with positive examples (must be accepted by the
compiled automaton AND, for schemas, by :func:`validate_instance`) and
negative examples (must be rejected). The corpus drives three layers of
checking: ``scripts/check_corpus_valid.py`` (lint: every case
compiles), ``tests/test_structured_output.py`` (tier-1 replay), and
``testing/structured_ab.py`` (engine/router conformance + overhead
bench).
"""

from __future__ import annotations

import json
import os
from typing import List

from production_stack_tpu_torch.structured.api import StructuredSpec

CORPUS_PATH = os.path.join(os.path.dirname(__file__), "corpus.json")


def load_corpus() -> List[dict]:
    with open(CORPUS_PATH, encoding="utf-8") as f:
        data = json.load(f)
    return data["cases"]


def case_spec(case: dict) -> StructuredSpec:
    """Canonical :class:`StructuredSpec` for a corpus case (the same
    canonicalization ``parse_structured`` applies to wire input)."""
    kind = case["kind"]
    if kind == "regex":
        return StructuredSpec("regex", case["spec"])
    if kind == "json_object":
        return StructuredSpec("json_object", "")
    return StructuredSpec("json_schema", json.dumps(
        case["spec"], separators=(",", ":"), ensure_ascii=False))


def case_request_fields(case: dict, surface: str = "guided") -> dict:
    """Wire-form request fields for a case.

    ``surface="guided"`` uses the vLLM extensions (``guided_regex`` /
    ``guided_json``); ``surface="response_format"`` uses the OpenAI
    field where it can express the case (json_schema / json_object —
    regex cases fall back to ``guided_regex``)."""
    kind = case["kind"]
    if kind == "regex":
        return {"guided_regex": case["spec"]}
    if kind == "json_object":
        return {"response_format": {"type": "json_object"}}
    if surface == "response_format":
        return {"response_format": {
            "type": "json_schema",
            "json_schema": {"name": case["name"],
                            "schema": case["spec"]}}}
    return {"guided_json": case["spec"]}
