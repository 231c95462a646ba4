"""Page probes of the paged decode kernel: the page gather alone
(:mod:`.kernel_dma_only`) and the gather with per-head reads or with the
products but no softmax (:mod:`.kernel_probe_strided`), each a CUDA
kernel (``csrc/page_probes.cu``) with a plain PyTorch version beside it.
They measure what the decode kernel's parts cost on the card; the
serving path never calls them.

Importing this package builds nothing: the kernel is compiled at its
first launch (``ops/_build.py``).
"""
