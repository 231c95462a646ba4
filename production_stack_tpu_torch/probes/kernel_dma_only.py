"""Page-gather probe of the paged decode kernel: the CUDA kernel
``csrc/page_probes.cu`` in its gather-only mode, and its plain version.

Replaces ``benchmarks/kernel_dma_only.py::dma_only`` of the JAX package:
the decode kernel's grid and page copies with the attention taken away,
so that how fast the card gathers scattered pages is read apart from
what the softmax costs. Every live chunk of ``pages_per_block`` pages of
every sequence is copied into shared memory; only an ``[8, D]`` float32
checksum is kept: the sum, over the live chunks ``c`` (``c * P * bs <
ctx``) of the last sequence, of token rows 0-7, kv head 0, of the
chunk's first page, K plus V. That is what the TPU kernel's in-order grid
left in its one output block.

On a CPU tensor :func:`dma_only` runs the plain version; on a CUDA tensor
it launches the kernel or raises, and never falls back.
``dma_only.launches_<dtype>`` counts its launches by page dtype (f32,
bf16, int8).

    python -m production_stack_tpu_torch.probes.kernel_dma_only [--device cpu]

prints the JAX script's rows at its shapes (``B, MAXB, NB, CTX = 16, 64,
843, 3000``, ``L, bs, KVH, D = 16, 64, 8, 128``, bf16 pages): the
contiguous read rate of one ``torch.sum`` over the pool, then one row per
``P`` of the gather over all ``L`` layers with its bytes, rate and the
floor at 3.35 TB/s. Times are CUDA-event device times; a run on the CPU checks
the rows and prints no time.
"""

from __future__ import annotations

import ctypes
import json

import torch

from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.probes import common
from production_stack_tpu_torch.probes.timing import cuda_time_ms

B, MAXB, NB, CTX = 16, 64, 843, 3000
L, bs, KVH, D = 16, 64, 8, 128
P_SWEEP = (4, 8, 16, 64)
ROWS = 8  # token rows of the checksum


def dma_only_reference(k_pages, v_pages, block_tables, context_lens, layer,
                       *, pages_per_block=8):
    """The plain version: the checksum, computed as defined."""
    Bn, MAXBn = common.check_operands(
        "dma_only", k_pages, v_pages, block_tables, context_lens, layer,
        pages_per_block)
    P = pages_per_block
    span = P * k_pages.shape[2]
    out = torch.zeros((ROWS, k_pages.shape[4]), dtype=torch.float32,
                      device=k_pages.device)
    if Bn == 0:
        return out
    ctx = int(context_lens[Bn - 1])
    for c in range(MAXBn // P):
        if c * span < ctx:
            page = int(block_tables[Bn - 1, c * P])
            out += (k_pages[layer, page, :ROWS, 0, :].float()
                    + v_pages[layer, page, :ROWS, 0, :].float())
    return out


def dma_only(k_pages, v_pages, block_tables, context_lens, layer, *,
             pages_per_block=8):
    """Gather every live chunk of pages of ``layer`` and return the
    ``[8, D]`` float32 checksum (see the module docstring).

    Raises if ``pages_per_block`` does not divide the table width (the
    JAX kernel silently dropped the tail there), if K and V differ in
    dtype or shape, or if a page operand is not 5-D."""
    if k_pages.device.type == "cpu":
        return dma_only_reference(k_pages, v_pages, block_tables,
                                  context_lens, layer,
                                  pages_per_block=pages_per_block)
    layer = int(layer)
    common.check_operands("dma_only", k_pages, v_pages, block_tables,
                          context_lens, layer, pages_per_block)
    if not k_pages.is_cuda:
        raise ValueError("dma_only kernel needs CUDA tensors")
    if k_pages.shape[2] < ROWS:
        raise ValueError(f"dma_only: a page must hold {ROWS} tokens")
    bt = block_tables.to(torch.int32).contiguous()
    cl = context_lens.to(torch.int32).contiguous()
    common.check_kernel_operands("dma_only", k_pages, v_pages)
    out = torch.zeros((ROWS, k_pages.shape[4]), dtype=torch.float32,
                      device=k_pages.device)
    lib = common.lib()
    with torch.cuda.device(k_pages.device):
        stream = torch.cuda.current_stream(k_pages.device).cuda_stream
        rc = lib.dma_only_launch(
            common.ptr(k_pages), common.ptr(v_pages), common.ptr(bt),
            common.ptr(cl), common.ptr(out),
            common.PAGE_DTYPES[k_pages.dtype],
            *common.shape_args(k_pages, bt), pages_per_block, layer,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, "dma_only")
    attr = "launches_" + common.DTYPE_NAMES[k_pages.dtype]
    setattr(dma_only, attr, getattr(dma_only, attr) + 1)
    return out


for _name in common.DTYPE_NAMES.values():
    setattr(dma_only, "launches_" + _name, 0)


def all_layers(k_pages, v_pages, block_tables, context_lens, *,
               pages_per_block=8):
    """:func:`dma_only` over every layer, the checksums summed (the JAX
    script's ``all_layers``)."""
    out = None
    for layer in range(k_pages.shape[0]):
        o = dma_only(k_pages, v_pages, block_tables, context_lens, layer,
                     pages_per_block=pages_per_block)
        out = o if out is None else out + o
    return out


def sweep_bytes(k_pages, block_tables, context_lens, P: int) -> int:
    """Bytes one :func:`all_layers` call reads: K and V of every page of
    every live chunk, in every layer."""
    MAXBn = block_tables.shape[1]
    n = common.pages_read(context_lens, MAXBn, k_pages.shape[2], P)
    return 2 * n * common.page_bytes(k_pages) * k_pages.shape[0]


def contiguous_row(k_pages) -> dict:
    """The contiguous-read yardstick: one float32 ``torch.sum`` over the
    whole K pool (device time; none on the CPU)."""
    nbytes = k_pages.numel() * k_pages.element_size()
    row = {"dtype": common.DTYPE_NAMES[k_pages.dtype],
           "pool_gb": nbytes / 1e9, "contiguous_sum_s": None,
           "contig_gbs": None}
    if k_pages.is_cuda:
        s = cuda_time_ms(lambda: torch.sum(k_pages, dtype=torch.float32)) / 1e3
        row.update(contiguous_sum_s=s, contig_gbs=nbytes / 1e9 / s)
    return row


def sweep_row(k_pages, v_pages, block_tables, context_lens, P: int) -> dict:
    """One row of the sweep: the gather over all layers at ``P`` pages a
    block, with its bytes, rate and floor at 3.35 TB/s (device time; none
    on the CPU)."""
    nbytes = sweep_bytes(k_pages, block_tables, context_lens, P)
    row = {"P": P, "dtype": common.DTYPE_NAMES[k_pages.dtype],
           "layers": k_pages.shape[0], "bytes_gb": nbytes / 1e9,
           "floor_s": nbytes / common.HBM_BYTES_PER_S,
           "dma_only_all_L_s": None, "effective_gbs": None}

    def run():
        return all_layers(k_pages, v_pages, block_tables, context_lens,
                          pages_per_block=P)

    if k_pages.is_cuda:
        s = cuda_time_ms(run) / 1e3
        row.update(dma_only_all_L_s=s, effective_gbs=nbytes / 1e9 / s)
    else:
        run()
    return row


def main(argv=None) -> int:
    device = common.main_device(__doc__, argv)
    k, v, bt, cl = common.make_inputs(
        B=B, MAXB=MAXB, NB=NB, ctx=CTX, L=L, bs=bs, KVH=KVH, D=D,
        dtype=torch.bfloat16, device=device)
    print(json.dumps(contiguous_row(k)), flush=True)
    for P in P_SWEEP:
        print(json.dumps(sweep_row(k, v, bt, cl, P)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
