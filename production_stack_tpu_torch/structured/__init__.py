"""Structured output: grammar-constrained decoding via token FSMs.

JSON Schema / regex constraints compile to a byte-level DFA
(``regex_dfa``), lift to a token-level FSM against the tokenizer vocab
(``tokenfsm``), and apply inside the fused decode programs as a packed
bitmask logit term — no per-step host round-trip. See
``docs/structured_output.md``.
"""

from production_stack_tpu_torch.structured.api import (  # noqa: F401
    StructuredSpec, compile_char_dfa, parse_structured, spec_regex)
from production_stack_tpu_torch.structured.regex_dfa import (  # noqa: F401
    CharDFA, StructuredError, compile_regex)
from production_stack_tpu_torch.structured.schema import (  # noqa: F401
    json_object_regex, schema_to_regex, validate_instance)
from production_stack_tpu_torch.structured.tokenfsm import (  # noqa: F401
    FSMState, StructuredCache, TokenFSM, mask_row_bytes, token_byte_table)

__all__ = [
    "StructuredSpec", "StructuredError", "CharDFA", "TokenFSM", "FSMState",
    "StructuredCache", "parse_structured", "compile_char_dfa",
    "compile_regex", "spec_regex", "schema_to_regex", "json_object_regex",
    "validate_instance", "token_byte_table", "mask_row_bytes",
]
