"""What both page probes share: operand checks, the binding of
``csrc/page_probes.cu``, the bytes a probe reads, and seeded inputs."""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from production_stack_tpu_torch.ops import _build

KERNEL = "page_probes"
HEAD_DIMS = (32, 64, 128)  # the head dims the kernel is compiled for
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
SEED = 0  # of a probe's pages, tables and q, as the JAX scripts' seed 0


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def lib() -> ctypes.CDLL:
    out = _build.load(KERNEL)
    # k, v, tables, lens, out; dtype, B, MAXB, NB, bs, KVH, D, P, layer;
    # the stream.
    out.dma_only_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]
    out.dma_only_launch.restype = ctypes.c_int
    # q, k, v, tables, lens, out; dots, dtype, B, MAXB, NB, bs, KVH, D, G,
    # P, layer; the stream.
    out.probe_strided_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 11 + [ctypes.c_void_p]
    out.probe_strided_launch.restype = ctypes.c_int
    return out


def check_operands(what: str, k_pages, v_pages, block_tables, context_lens,
                   layer: int, pages_per_block: int):
    """Raise on anything the probes do not take (on either device);
    returns (B, MAXB)."""
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dim() != 5:
            raise ValueError(f"{what}: {name} must be [L, NB, bs, KVH, D]")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{what}: k and v pages differ in shape")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"{what}: k pages are {k_pages.dtype}, v pages "
                        f"{v_pages.dtype}")
    if k_pages.dtype not in PAGE_DTYPES:
        raise TypeError(f"{what}: unsupported page dtype {k_pages.dtype}")
    if block_tables.dim() != 2:
        raise ValueError(f"{what}: block_tables must be [B, MAXB]")
    B, MAXB = block_tables.shape
    if context_lens.shape != (B,):
        raise ValueError(f"{what}: context_lens must be [B]")
    P = int(pages_per_block)
    if P <= 0 or MAXB % P != 0:
        raise ValueError(f"{what}: pages_per_block {P} does not divide the "
                         f"table width {MAXB}")
    if not 0 <= layer < k_pages.shape[0]:
        raise ValueError(f"{what}: layer {layer} outside "
                         f"[0, {k_pages.shape[0]})")
    for name, t in (("v_pages", v_pages), ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != k_pages.device:
            raise ValueError(f"{what}: {name} on {t.device}, k_pages on "
                             f"{k_pages.device}")
    return B, MAXB


def check_kernel_operands(what: str, *tensors):
    """What the CUDA kernel needs beyond :func:`check_operands`: pages
    contiguous and 16-byte aligned, a token row a whole number of 16-byte
    copies, a head dim it is compiled for."""
    k_pages = tensors[0]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")
    _, _, _, KVH, D = k_pages.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if KVH * D * k_pages.element_size() % 16:
        raise ValueError(f"{what}: a token row must be a multiple of 16 bytes")


def shape_args(k_pages, block_tables):
    """B, MAXB, NB, bs, KVH, D: the shape arguments both launch functions
    take after their dtype."""
    _, NB, bs, KVH, D = k_pages.shape
    B, MAXB = block_tables.shape
    return B, MAXB, NB, bs, KVH, D


def live_chunks(context_lens, span: int, nc: int) -> torch.Tensor:
    """[B, nc] bool: chunk c of sequence b is live iff c * span < ctx."""
    starts = torch.arange(nc, device=context_lens.device) * span
    return starts[None, :] < context_lens.to(torch.int64)[:, None]


def pages_read(context_lens, MAXB: int, bs: int, P: int) -> int:
    """Pages a probe copies (per side, per layer): every page of every
    live chunk, ceil(ctx / (P * bs)) * P a sequence, capped at MAXB."""
    span = P * bs
    n = 0
    for ctx in context_lens.tolist():
        n += min(max(0, -(-int(ctx) // span)), MAXB // P) * P
    return n


def page_bytes(k_pages) -> int:
    _, _, bs, KVH, D = k_pages.shape
    return bs * KVH * D * k_pages.element_size()


def make_tables(rng, B: int, MAXB: int, NB: int) -> np.ndarray:
    """[B, MAXB] int32 page ids from one permutation of the pool, handed
    out column by column, so that the first ``NB // B`` pages of every
    row are all distinct: a page two live chunks shared could come from
    the L2 cache, and a rate would then read above the memory's."""
    perm = rng.permutation(NB)
    idx = np.arange(B * MAXB).reshape(MAXB, B).T % NB
    return perm[idx].astype(np.int32)


def make_pool(shape, dtype, device, seed: int):
    """K and V pages of random values from ``seed``: 0.1 * N(0, 1) in a
    float dtype (the JAX scripts' pages), uniform codes in [-127, 127] for
    int8."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(2):
        if dtype == torch.int8:
            out.append(torch.randint(-127, 128, shape, generator=g,
                                     device=device, dtype=torch.int8))
        else:
            x = torch.randn(shape, generator=g, device=device, dtype=dtype)
            out.append(x.mul_(0.1))
    return out[0], out[1]


def make_inputs(*, B, MAXB, NB, ctx, L, bs, KVH, D, dtype, device,
                seed: int = SEED):
    """Pages, tables and context lengths of a probe run: ``ctx`` is one
    length for every sequence or a list of B lengths."""
    lens = [ctx] * B if isinstance(ctx, int) else list(ctx)
    rng = np.random.default_rng(seed)
    k, v = make_pool((L, NB, bs, KVH, D), dtype, device, seed)
    bt = torch.from_numpy(make_tables(rng, B, MAXB, NB)).to(device)
    cl = torch.tensor(lens, dtype=torch.int32, device=device)
    return k, v, bt, cl


def main_device(doc: str, argv) -> torch.device:
    """The one option of a probe's ``main``: ``--device``, the card
    unless the caller asks for the CPU (the plain version, no times)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu: the plain version, no time")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "version")
    return device
