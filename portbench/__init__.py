"""The benchmark of the PyTorch/CUDA port (``production_stack_tpu_torch``).

One run serves one cell of ``BENCHMARK.json`` through the port's OpenAI
server on one card and prints one JSON line; see ``README.md``.
"""
