"""Strided-read and product probe of the paged decode kernel: the CUDA
kernel ``csrc/page_probes.cu`` in its per-head modes, and their plain
versions.

Replaces ``benchmarks/kernel_probe_strided.py::build`` of the JAX
package: the decode kernel's page copies, then for each kv head ``h``
either its strided per-head reads (``mode="reads"``) or both of its
products without the softmax (``mode="dots"``), so that what reads and
products cost is read apart from the softmax. For each sequence ``b``,
live chunk ``c`` (``c * P * bs < ctx``) and kv head ``h``, with
``G = q.shape[1] // KVH`` query rows a head and ``K_h``, ``V_h`` the
chunk's ``P * bs`` token rows of head ``h`` in page order:

- ``reads``: ``o[b, h*G:(h+1)*G] += K_h[:G] + V_h[:G]``;
- ``dots``: ``o[b, h*G:(h+1)*G] += (q[b, h*G:(h+1)*G] @ K_h^T) @ V_h``,
  in float32, with no scale and no softmax.

Tokens past ``ctx`` in the last live chunk are read too, unmasked, as
the TPU kernel does. :func:`probe_strided` returns one layer's
``o [B, KVH*G, D]`` float32; :func:`build` returns the JAX script's
``run``, the sum over layers of ``o[0, 0, :8]`` as ``[1, 8]``.

The CUDA kernel keeps the port's decode kernel's layout: a block per
(kv head, chunk, sequence), 32-token tiles, the same per-head loads and
products. At ``P = MAXB`` its grid is the decode kernel's, so ``reads``
times that kernel's gather, ``dots - reads`` its products, and the
decode kernel minus ``dots`` its softmax.

On a CPU tensor :func:`probe_strided` runs the plain version; on a CUDA
tensor it launches the kernel or raises, and never falls back.
``probe_strided.launches_<mode>_<dtype>`` counts its launches.

    python -m production_stack_tpu_torch.probes.kernel_probe_strided [--device cpu]

prints one row per mode at the JAX script's shapes (its ``G = 8`` padded
rows a head, bf16 ``q`` and pages): the time of ``run`` over all ``L``
layers, its bytes and flops, and the floor at 3.35 TB/s.
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
G = 8  # padded head group rows
PAGES_PER_BLOCK = 8  # the JAX script's build default
MODES = ("reads", "dots")


def _check(q, k_pages, v_pages, block_tables, context_lens, layer, mode,
           pages_per_block):
    Bn, _ = common.check_operands(
        "probe_strided", k_pages, v_pages, block_tables, context_lens, layer,
        pages_per_block)
    if mode not in MODES:
        raise ValueError(f"probe_strided: mode {mode!r} not in {MODES}")
    _, _, bsn, KVHn, Dn = k_pages.shape
    if q.dim() != 3 or q.shape[0] != Bn or q.shape[2] != Dn:
        raise ValueError("probe_strided: q must be [B, KVH*G, D]")
    if q.shape[1] % KVHn:
        raise ValueError("probe_strided: q rows must be a multiple of KVH")
    if q.device != k_pages.device:
        raise ValueError(f"probe_strided: q on {q.device}, pages on "
                         f"{k_pages.device}")
    Gn = q.shape[1] // KVHn
    if Gn > pages_per_block * bsn:
        raise ValueError(f"probe_strided: G={Gn} rows a head exceed a chunk "
                         f"of {pages_per_block * bsn} tokens")
    return Gn


def probe_strided_reference(q, k_pages, v_pages, block_tables, context_lens,
                            layer, *, mode, pages_per_block=8):
    """The plain version: one layer's ``o [B, KVH*G, D]`` float32."""
    Gn = _check(q, k_pages, v_pages, block_tables, context_lens, layer, mode,
                pages_per_block)
    Bn, MAXBn = block_tables.shape
    _, _, bsn, KVHn, Dn = k_pages.shape
    P = pages_per_block
    nc = MAXBn // P
    live = common.live_chunks(context_lens, P * bsn, nc)  # [B, nc]
    bt = block_tables.to(torch.int64)
    kl, vl = k_pages[layer], v_pages[layer]  # [NB, bs, KVH, D]
    if mode == "reads":
        j = torch.arange(Gn, device=bt.device)
        cols = (torch.arange(nc, device=bt.device) * P)[:, None] + j // bsn
        pages = bt[:, cols]  # [B, nc, G]
        x = kl[pages, j % bsn].float() + vl[pages, j % bsn].float()
        x = torch.where(live[:, :, None, None, None], x, 0.0).sum(1)
        return x.transpose(1, 2).reshape(Bn, KVHn * Gn, Dn)  # [B, KVH*G, D]
    pages = bt.reshape(Bn, nc, P)
    kc = kl[pages].float().reshape(Bn, nc, P * bsn, KVHn, Dn)
    vc = vl[pages].float().reshape(Bn, nc, P * bsn, KVHn, Dn)
    qf = q.float().reshape(Bn, KVHn, Gn, Dn)
    s = torch.einsum("bhgd,bcthd->bchgt", qf, kc)
    o = torch.einsum("bchgt,bcthd->bchgd", s, vc)
    o = torch.where(live[:, :, None, None, None], o, 0.0).sum(1)
    return o.reshape(Bn, KVHn * Gn, Dn)


def probe_strided(q, k_pages, v_pages, block_tables, context_lens, layer, *,
                  mode, pages_per_block=8):
    """One layer's probe output ``o [B, KVH*G, D]`` float32 (see the
    module docstring). Raises if ``pages_per_block`` does not divide the
    table width, if K and V differ in dtype or shape, or if a page operand
    is not 5-D."""
    if k_pages.device.type == "cpu":
        return probe_strided_reference(
            q, k_pages, v_pages, block_tables, context_lens, layer,
            mode=mode, pages_per_block=pages_per_block)
    layer = int(layer)
    Gn = _check(q, k_pages, v_pages, block_tables, context_lens, layer, mode,
                pages_per_block)
    if not k_pages.is_cuda:
        raise ValueError("probe_strided kernel needs CUDA tensors")
    qf = q.float().contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    cl = context_lens.to(torch.int32).contiguous()
    common.check_kernel_operands("probe_strided", k_pages, v_pages)
    out = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    lib = common.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.probe_strided_launch(
            common.ptr(qf), common.ptr(k_pages), common.ptr(v_pages),
            common.ptr(bt), common.ptr(cl), common.ptr(out),
            int(mode == "dots"), common.PAGE_DTYPES[k_pages.dtype],
            *common.shape_args(k_pages, bt), Gn, pages_per_block, layer,
            ctypes.c_void_p(stream))
    _build.check(lib, rc, "probe_strided")
    attr = f"launches_{mode}_{common.DTYPE_NAMES[k_pages.dtype]}"
    setattr(probe_strided, attr, getattr(probe_strided, attr) + 1)
    return out


for _mode in MODES:
    for _name in common.DTYPE_NAMES.values():
        setattr(probe_strided, f"launches_{_mode}_{_name}", 0)


def build(mode, pages_per_block=8):
    """The JAX script's ``build``: returns ``run(q, k_pages, v_pages,
    block_tables, context_lens)``, which runs the probe over every layer
    and returns the sum over layers of ``o[0, 0, :8]`` as ``[1, 8]``
    float32."""
    if mode not in MODES:
        raise ValueError(f"probe_strided: mode {mode!r} not in {MODES}")

    def run(q, k_pages, v_pages, block_tables, context_lens):
        acc = torch.zeros(8, dtype=torch.float32, device=q.device)
        for layer in range(k_pages.shape[0]):
            o = probe_strided(q, k_pages, v_pages, block_tables,
                              context_lens, layer, mode=mode,
                              pages_per_block=pages_per_block)
            acc = acc + o[0, 0, :8]
        return acc.reshape(1, 8)

    return run


def work(q, k_pages, block_tables, context_lens, mode, P: int):
    """(bytes, flops) of one ``run``: K and V of every page of every live
    chunk in every layer, plus q read and o written once a layer; the
    products' 4 * KVH * G * D flops a token of every live chunk (dots)."""
    MAXBn = block_tables.shape[1]
    Ln, _, bsn, _, Dn = k_pages.shape
    n = common.pages_read(context_lens, MAXBn, bsn, P)
    nbytes = Ln * (2 * n * common.page_bytes(k_pages)
                   + q.numel() * (q.element_size() + 4))
    flops = 4 * q.shape[1] * Dn * n * bsn * Ln if mode == "dots" else 0
    return nbytes, flops


def sweep_row(q, k_pages, v_pages, block_tables, context_lens, mode,
              P: int) -> dict:
    """One row: ``run`` over all layers at ``P`` pages a block, with its
    bytes, flops and floor (device time; none on the CPU)."""
    nbytes, flops = work(q, k_pages, block_tables, context_lens, mode, P)
    row = {"mode": mode, "P": P, "dtype": common.DTYPE_NAMES[k_pages.dtype],
           "layers": k_pages.shape[0], "bytes_gb": nbytes / 1e9,
           "gflop": flops / 1e9,
           "floor_s": max(nbytes / common.HBM_BYTES_PER_S,
                          flops / common.BF16_FLOPS),
           "all_L_s": None, "effective_gbs": None}
    run = build(mode, P)

    def call():
        return run(q, k_pages, v_pages, block_tables, context_lens)

    if k_pages.is_cuda:
        s = cuda_time_ms(call) / 1e3
        row.update(all_L_s=s, effective_gbs=nbytes / 1e9 / s)
    else:
        call()
    return row


def main(argv=None) -> int:
    device = common.main_device(__doc__, argv)
    k, v, bt, cl = common.make_inputs(
        B=B, MAXB=MAXB, NB=NB, ctx=CTX, L=L, bs=bs, KVH=KVH, D=D,
        dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(common.SEED + 1)
    q = torch.randn((B, KVH * G, D), generator=g, device=device,
                    dtype=torch.bfloat16)
    for mode in MODES:
        print(json.dumps(sweep_row(q, k, v, bt, cl, mode, PAGES_PER_BLOCK)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
