"""production-stack-tpu-torch: the serving engine ported to PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

Sits beside ``production_stack_tpu`` (the JAX reference, which it never
imports) and serves Llama-family, OPT and Mixtral models through the
same OpenAI surface and ``vllm:*``/``tpu:*`` metrics, so the router talks
to it over HTTP unchanged:

- ``engine/`` -- ``EngineCore`` (paged KV pool, prefix caching, chunked
  prefill of long prompts, K-step decode bursts) and a standard-library
  HTTP server;
- ``models/`` -- the Llama, OPT and Mixtral decoders over parameter
  dicts with the JAX package's leaf names, plus a converter for JAX
  parameter trees;
- ``ops/`` -- plain PyTorch attention and the wrappers of the CUDA
  kernels in ``csrc/`` (paged decode, cached prefill), built with nvcc
  at first use.
"""

__version__ = "0.1.0"
