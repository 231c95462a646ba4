"""Attention ops: plain PyTorch versions and the CUDA kernel wrappers.

Importing this package builds nothing: each kernel is compiled at its
first launch (``ops/_build.py``).
"""

from production_stack_tpu_torch.ops.attention import (
    context_prefill_attention,
    paged_decode_attention,
    prefill_attention,
    write_kv_pages,
)

__all__ = ["context_prefill_attention", "paged_decode_attention",
           "prefill_attention", "write_kv_pages"]
