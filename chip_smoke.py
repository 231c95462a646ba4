#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # everything, as a check of the port
    python3 chip_smoke.py --profile  # where a decode step's time goes
                                     # (bf16, then int8 KV + weights)

Phases, each of which fails the run (non-zero exit, no result line):

1. build the three kernel libraries from ``production_stack_tpu_torch/csrc``
   (both attention kernels and the page probes; one nvcc per source,
   started together) and print the compiler's register/shared-memory
   report to standard error;
2. hold each attention kernel, in both page encodings (pages in q's
   dtype, and int8 pages with float32 scales), against its plain PyTorch
   version on the same CUDA tensors, at the Llama-3-8B main-path shapes
   in bf16 and at small f32 shapes, and time kernel, plain version and a
   library yardstick (``scaled_dot_product_attention`` on pre-gathered
   contiguous K/V, dequantized beforehand for int8, which excludes the
   page gather and the dequant and is never called by the port);
3. the page probes of the decode kernel (``csrc/page_probes.cu``: the
   page gather alone, and with per-head reads or with both products and
   no softmax), each mode and page dtype against its plain version at
   small shapes, at the 8B decode case and at the JAX scripts' shapes;
   then the probe path driven through its entry points (the
   ``torch.sum`` yardstick, the gather at 4-64 pages a block, reads and
   products at 4, 8 and 64, the decode kernel on the same pools), every
   rate held under 1.05 x 3.35 TB/s, printed as a ``{"probes": ...}``
   line;
4. serve ``meta-llama/Llama-3-8B`` at full width and depth with random
   weights through the port's OpenAI server (in-process, on a thread) and
   drive it over HTTP: concurrent greedy completions, a chunked long
   prompt, a prefix-cache hit, a streamed sampled chat, a repeated greedy
   request and a ``/metrics`` scrape; every request must finish with
   ``stop`` or ``length`` and both kernels must have launched;
5. free that engine and serve the same model again with
   ``--kv-cache-dtype int8 --quantization int8`` (int8 KV pages, int8
   weights), driven the same way; both kernels must have launched in
   their int8 mode, and never in the other. No probe launches on either
   served path.

The output ends with a ``{"kernels": [...]}`` line (each kernel in each
page encoding, each probe in each mode and page dtype), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a CUDA device or outside a checkout of the repo.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# Tolerances of kernel vs plain version, elementwise.
# f32: 2e-3 absolute, the TPU kernels' own parity bar; the f32 cases have
# short contexts, where |o| is 0.1-1 and a lost key tile moves o by O(0.1).
# bf16: per output row (one query token, one head), 2^-5 of the row's
# largest |o|, i.e. four to eight bf16 ulps of that element. Both sides
# round an f32 result to bf16 (at most 1/2 ulp each, so one ulp of the
# row's largest element apart), and the plain version's bf16 P.V product
# may reduce partial sums in bf16 (about one ulp more); two ulps are
# 2^-6 of the row's largest |o| at most, and were measured in the
# prefill cases. The rest is far below an ulp: the plain version rounds
# its softmax probabilities to bf16 (2^-9 relative per term, random in
# sign: ~1e-5 on o at 2k keys) and the kernel takes q pre-scaled and
# rounded to bf16 (~1e-3 on a score, ~1e-5 on o). A bar on the output's
# own scale matters because |o| is small here: with randn q/K/V over 2k
# keys o has a std of ~0.04. With int8 pages the kernel dequantizes into
# f32 while the plain version rounds each dequantized K/V element to bf16
# (2^-9 relative, random in sign) before its products: on o that is
# ~2^-9 x |v| x sqrt(sum p^2) ~ 2e-3 x 0.04 ~ 1e-4 from V and as much
# through the scores from K, about 2% of a bar of ~5e-3 (2^-5 of a row
# maximum near 0.15), so the same bar holds for both encodings.
# scripts/torch_kernel_faults.py shows that planted faults (a key tile
# skipped, a rescale left out; for int8 a scale read from kv head 0 or
# left out) fail this bar at the main-path shapes.
BF16_ROW_BAR = 2.0 ** -5
F32_BAR = 2e-3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- kernel phase -----------------------------------------------------------

def _tables(rng, B, MAXB, NB):
    """Distinct shuffled pages per sequence (scattered like real tables)."""
    import numpy as np

    return rng.permutation(NB)[: B * MAXB].reshape(B, MAXB).astype(np.int32)


def _pages(g, dtype, shape, int8):
    """Random pages [L, NB, bs, KVH, D] in ``dtype``, or those values
    quantized into the int8 ``(data, scales)`` encoding."""
    import torch

    from production_stack_tpu_torch.ops.attention import quantize_kv

    x = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    if not int8:
        return x
    data, scales = quantize_kv(x)
    return data, scales.reshape(shape[0], shape[1], shape[2] * shape[3])


def decode_case(dtype, B, H, KVH, D, L, bs, MAXB, ctx, seed, int8=False):
    """Inputs of one decode-attention launch, made on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = B * MAXB + 3
    k = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    v = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    q = torch.randn((B, H, D), generator=g, device="cuda", dtype=dtype)
    bt = torch.from_numpy(_tables(rng, B, MAXB, NB)).cuda()
    # Table entries past each live range point at page 0: a real page the
    # kernel must never read for this row.
    for b in range(B):
        bt[b, -(-ctx[b] // bs):] = 0
    cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    return dict(q=q, k_pages=k, v_pages=v, block_tables=bt, context_lens=cl,
                layer=L - 1, scale=D ** -0.5)


def prefill_case(dtype, B, T, H, KVH, D, L, bs, MAXB, prefix, take, seed,
                 int8=False):
    """Inputs of one cached-prefill launch in the engine's layout: the
    chunk's fresh K/V are already scattered (for int8 pages: quantized)
    into the pages, where the kernel and the plain version both read
    them."""
    import numpy as np
    import torch

    from production_stack_tpu_torch.ops.attention import write_kv_pages

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = B * MAXB + 3
    k = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    v = _pages(g, dtype, (L, NB, bs, KVH, D), int8)
    q = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=dtype)
    k_new = torch.randn((B, T, KVH, D), generator=g, device="cuda",
                        dtype=dtype)
    v_new = torch.randn((B, T, KVH, D), generator=g, device="cuda",
                        dtype=dtype)
    tables = _tables(rng, B, MAXB, NB)
    prefix = np.asarray(prefix, np.int64)
    take = np.asarray(take, np.int64)
    positions = prefix[:, None] + np.arange(T)[None, :]
    slots = np.full((B, T), -1, np.int64)
    for b in range(B):
        pos = positions[b, : take[b]]
        slots[b, : take[b]] = tables[b, pos // bs] * bs + pos % bs
    write_kv_pages(k, v, k_new, v_new, torch.from_numpy(slots), L - 1)
    bt = torch.from_numpy(tables).cuda()
    for b in range(B):
        bt[b, -(-int(prefix[b] + take[b]) // bs):] = 0
    return dict(
        q=q, k_pages=k, v_pages=v, block_tables=bt,
        positions=torch.from_numpy(positions).cuda(),
        total_lens=torch.tensor(prefix + take, dtype=torch.int32,
                                device="cuda"),
        layer=L - 1, scale=D ** -0.5)


def run_decode(c):
    from production_stack_tpu_torch.ops.paged_attention import paged_attention

    return paged_attention(c["q"], c["k_pages"], c["v_pages"],
                           c["block_tables"], c["context_lens"], c["layer"],
                           scale=c["scale"])


def plain_decode(c):
    from production_stack_tpu_torch.ops.attention import (
        paged_attention_reference,
    )

    return paged_attention_reference(
        c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
        c["context_lens"], c["layer"], scale=c["scale"])


def run_prefill(c):
    from production_stack_tpu_torch.ops.prefill_attention import (
        cached_prefill_attention,
    )

    return cached_prefill_attention(
        c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
        c["positions"], c["total_lens"], c["layer"], scale=c["scale"])


def plain_prefill(c):
    from production_stack_tpu_torch.ops.attention import (
        _context_prefill_reference,
    )

    return _context_prefill_reference(
        c["q"], c["k_pages"], c["v_pages"], c["block_tables"],
        c["positions"], c["total_lens"], c["layer"], scale=c["scale"])


# kernel entry (a kernel in one page encoding) -> (its wrapper, its plain
# version), each taking a case dict; the wrappers read the encoding off
# the pages.
KERNELS = {"paged_attention": (run_decode, plain_decode),
           "cached_prefill_attention": (run_prefill, plain_prefill),
           "paged_attention_int8": (run_decode, plain_decode),
           "cached_prefill_attention_int8": (run_prefill, plain_prefill)}


def main_path_cases():
    """The Llama-3-8B cases of both kernels (32/8 heads, D 128, 64-token
    pages, bf16 q), over bf16 pages and over int8 pages: (label, kernel
    entry, inputs, output rows compared)."""
    import torch

    bf16 = torch.bfloat16
    B, H, KVH, D, bs, ctx_len = 8, 32, 8, 128, 64, 2048
    ragged = [2048, 1, 37, 2000, 1500, 64, 65, 1024]
    cases = []
    for enc, seed in (("bf16", 0), ("int8", 100)):
        int8 = enc == "int8"
        suffix = "_int8" if int8 else ""
        cases += [
            (f"paged_attention {enc} ragged", "paged_attention" + suffix,
             decode_case(bf16, B, H, KVH, D, 2, bs, ctx_len // bs, ragged,
                         seed=seed + 10, int8=int8), None),
            (f"paged_attention {enc} 8x2048", "paged_attention" + suffix,
             decode_case(bf16, B, H, KVH, D, 2, bs, ctx_len // bs,
                         [ctx_len] * B, seed=seed + 11, int8=int8), None),
            # The third chunk of a 2,500-token prompt: 452 fresh tokens
            # padded to the 1024 bucket over a 2048-token prefix, table
            # capped at 64 pages; the padded query rows are discarded by
            # the engine.
            (f"cached_prefill {enc} ragged chunk",
             "cached_prefill_attention" + suffix,
             prefill_case(bf16, 1, 1024, H, KVH, D, 2, bs, 64, [2048], [452],
                          seed=seed + 30, int8=int8),
             (slice(None), slice(0, 452))),
            # A full 1024-token chunk continuation over a 1024-token prefix.
            (f"cached_prefill {enc} 1024/1024",
             "cached_prefill_attention" + suffix,
             prefill_case(bf16, 1, 1024, H, KVH, D, 2, bs, 32, [1024],
                          [1024], seed=seed + 31, int8=int8), None),
        ]
    return cases


def _gathered(c, n_tokens):
    """Contiguous [B, KVH, n, D] K/V of each row's first n tokens in q's
    dtype (for the library yardstick: gathered, and for int8 pages
    dequantized, outside its timing)."""
    from production_stack_tpu_torch.ops.attention import _gather_ctx

    k = _gather_ctx(c["k_pages"], c["block_tables"], c["layer"],
                    out_dtype=c["q"].dtype)[:, :n_tokens]
    v = _gather_ctx(c["v_pages"], c["block_tables"], c["layer"],
                    out_dtype=c["q"].dtype)[:, :n_tokens]
    return (k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())


def _page_bytes_per_token(c) -> int:
    """Bytes of one token's K and V over all kv heads in the case's page
    encoding (int8: one byte an element plus a float32 scale per head)."""
    from production_stack_tpu_torch.ops.attention import kv_page_data

    data = kv_page_data(c["k_pages"])
    KVH, D = data.shape[3], data.shape[4]
    per_head = D * data.element_size()
    if isinstance(c["k_pages"], tuple):
        per_head += 4
    return 2 * KVH * per_head


def _sdpa(q, k, v, mask=None):
    import torch.nn.functional as F

    # q arrives pre-scaled, as the kernels take it.
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          scale=1.0, enable_gqa=True)


def compare(got, want, rows=None):
    """(max_abs_err, largest error over its bar) of a kernel's output
    against its plain version's, elementwise with the bar of the dtype
    (see BF16_ROW_BAR); both are inf where the kernel's output is not
    finite."""
    import torch

    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        bar = torch.full_like(err, F32_BAR)
    else:
        bar = BF16_ROW_BAR * want.float().abs().amax(dim=-1, keepdim=True)
    ratio = torch.where(err > 0, err / bar, torch.zeros_like(err))
    return err.max().item(), ratio.max().item()


def check_close(name, got, want, rows=None):
    """:func:`compare`, logged; raises AssertionError past the bar."""
    max_err, over = compare(got, want, rows)
    log(f"[kernel] {name}: max_abs_err={max_err:.3e} err/bar={over:.3f} "
        f"({want.dtype})")
    if not over <= 1.0:
        raise AssertionError(f"{name}: error {over:.3f}x its bar "
                             f"(max_abs_err {max_err:.3e})")
    return max_err, over


def _time_decode(label, c):
    """Times of kernel, plain version and library yardstick on a decode
    case, with the bytes and operations its inputs need."""
    import torch

    B, H, D = c["q"].shape
    ctx_len = int(c["context_lens"].max())
    kg, vg = _gathered(c, ctx_len)
    qs = (c["q"] * c["scale"]).to(c["q"].dtype)[:, :, None, :]
    check_close(f"{label} vs sdpa yardstick", run_decode(c),
                _sdpa(qs, kg, vg)[:, :, 0])
    n_tok = int(c["context_lens"].sum())
    q_bytes = c["q"].element_size()
    return dict(
        ms=cuda_time_ms(lambda: run_decode(c)),
        plain_ms=cuda_time_ms(lambda: plain_decode(c)),
        library_ms=cuda_time_ms(lambda: _sdpa(qs, kg, vg)),
        bytes=(n_tok * _page_bytes_per_token(c) + 2 * B * H * D * q_bytes
               + c["block_tables"].numel() * 4 + B * 4),
        ops=4 * H * D * n_tok)


def _time_prefill(label, c):
    """Times of kernel, plain version and library yardstick on a
    single-row cached-prefill case, with the bytes and operations its
    inputs need (the (query, key) pairs of its causal mask)."""
    import torch

    _, T, H, D = c["q"].shape
    P = int(c["positions"][0, 0])
    kg, vg = _gathered(c, P + T)
    qs = (c["q"] * c["scale"]).to(c["q"].dtype).transpose(1, 2)
    span = torch.arange(P + T, device="cuda")
    mask = span[None, :] <= (P + torch.arange(T, device="cuda"))[:, None]
    check_close(f"{label} vs sdpa yardstick", run_prefill(c),
                _sdpa(qs, kg, vg, mask).transpose(1, 2))
    pairs = T * P + T * (T + 1) // 2
    return dict(
        ms=cuda_time_ms(lambda: run_prefill(c), iters=10),
        plain_ms=cuda_time_ms(lambda: plain_prefill(c), iters=5),
        library_ms=cuda_time_ms(lambda: _sdpa(qs, kg, vg, mask), iters=10),
        bytes=(2 * T * H * D * c["q"].element_size()
               + (P + T) * _page_bytes_per_token(c)
               + c["block_tables"].numel() * 4 + T * 4 + 4),
        ops=4 * H * D * pairs)


def kernel_phase():
    """Kernel vs plain version at main-path and small shapes, in both page
    encodings; returns the per-entry measurements of the main-path
    (Llama-3-8B) cases."""
    import torch

    f32 = torch.float32
    for int8 in (False, True):
        enc = "int8 pages" if int8 else "f32 pages"
        # Decode: small f32 shapes (GQA 4, 1 and 2; odd table widths;
        # ragged contexts incl. 1 token) and the main-path head layout.
        for i, (H, KVH, D, bs, MAXB, ctx) in enumerate([
                (8, 2, 64, 16, 5, [1, 80, 33]),
                (4, 4, 128, 4, 7, [28, 3, 17, 9]),
                (4, 2, 32, 4, 16, [64, 1]),
                (32, 8, 128, 64, 4, [1, 200, 64, 130])]):
            c = decode_case(f32, len(ctx), H, KVH, D, 3, bs, MAXB, ctx,
                            seed=i, int8=int8)
            check_close(f"paged_attention f32 case {i}, {enc}",
                        run_decode(c), plain_decode(c))
        # Cached prefill: small f32 shapes (GQA 3 and 1, empty prefix
        # rows, multi-tile queries, padded rows) and the main-path head
        # layout.
        for i, (T, H, KVH, D, bs, MAXB, prefix, take) in enumerate([
                (24, 6, 2, 64, 8, 12, [0, 17, 40], [24, 5, 13]),
                (40, 4, 4, 128, 4, 32, [3, 64], [40, 1]),
                (16, 4, 2, 32, 4, 16, [0, 0], [16, 7]),
                (96, 32, 8, 128, 64, 4, [0, 100], [96, 50])]):
            c = prefill_case(f32, len(prefix), T, H, KVH, D, 2, bs, MAXB,
                             prefix, take, seed=20 + i, int8=int8)
            got, want = run_prefill(c), plain_prefill(c)
            for b, n in enumerate(take):
                check_close(f"cached_prefill f32 case {i} row {b}, {enc}",
                            got[b, :n], want[b, :n])

    errs = {name: 0.0 for name in KERNELS}
    cases = {}
    for label, name, c, rows in main_path_cases():
        run, plain = KERNELS[name]
        err, _ = check_close(label, run(c), plain(c), rows)
        errs[name] = max(errs[name], err)
        cases[label] = c

    from production_stack_tpu_torch.probes.common import (
        BF16_FLOPS,
        HBM_BYTES_PER_S,
    )

    results = {}
    for enc in ("bf16", "int8"):
        suffix = "_int8" if enc == "int8" else ""
        results["paged_attention" + suffix] = _time_decode(
            f"paged_attention {enc}", cases[f"paged_attention {enc} 8x2048"])
        results["cached_prefill_attention" + suffix] = _time_prefill(
            f"cached_prefill {enc}", cases[f"cached_prefill {enc} 1024/1024"])
    for name, r in results.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = r["ops"] / BF16_FLOPS * 1e3
        r.update(max_abs_err=errs[name], bound_ms=max(byte_ms, op_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations")
        print(f"[bound] {name}: {r['bytes'] / 1e6:.2f} MB -> {byte_ms:.4f} ms "
              f"at 3.35 TB/s; {r['ops'] / 1e9:.1f} GFLOP -> {op_ms:.4f} ms at "
              f"989 TFLOP/s bf16; one launch per layer, 32 per decode step "
              f"or cached chunk", flush=True)
    for name, r in results.items():
        log(f"[kernel] {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    return results


# -- probe phase --------------------------------------------------------------

# A probe that reads faster than this many times the card's memory rate
# (``probes.common.HBM_BYTES_PER_S``) copied less than it claims: the
# planted dma_only fault of scripts/torch_kernel_faults.py (only the
# consumed rows copied) reads above it.
PROBE_RATE_FACTOR = 1.05
# Probe kernel vs plain version, of the largest |plain| value: the same
# float32 sums of page values in another order (atomics on the card);
# dots adds float32 products of D terms, then of up to P * bs tokens.
PROBE_GATHER_TOL = 1e-6
PROBE_DOTS_TOL = 1e-5
# The JAX scripts' shapes (benchmarks/kernel_dma_only.py:26-27, G from
# kernel_probe_strided.py:27), and the Llama-3-8B decode case of the
# kernel phase (8 x 2,048, 64-token pages, 32/8 heads) at the model's 32
# layers, so that one call's pool (2.15 GB) is far beyond the 50 MB L2.
JAX_PROBE_SHAPE = dict(B=16, MAXB=64, NB=843, ctx=3000, L=16, bs=64, KVH=8,
                       D=128, G=8)
DECODE_PROBE_SHAPE = dict(B=8, MAXB=32, NB=8 * 32 + 3, ctx=2048, L=32,
                          bs=64, KVH=8, D=128, G=4)
# P of each sweep: the gather, then reads and dots. Each holds P = MAXB
# (one block walks a sequence, the decode kernel's grid), where the
# decomposition is read.
PROBE_SWEEPS = {"jax_shapes": ((4, 8, 16, 64), (8, 64)),
                "decode_case": ((4, 8, 16, 32), (4, 32))}
PROBE_DTYPES = ("bf16", "int8")  # page dtypes of the kernels line


def probe_inputs(shape, dtype, seed=0):
    """(q, k, v, tables, lens) of a probe run on the card: pages of
    ``dtype``, bf16 q of KVH * G rows."""
    import torch

    from production_stack_tpu_torch.probes import common

    s = dict(shape)
    G = s.pop("G")
    k, v, bt, cl = common.make_inputs(dtype=dtype, device="cuda", seed=seed,
                                      **s)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((s["B"], s["KVH"] * G, s["D"]), generator=g,
                    device="cuda", dtype=torch.bfloat16)
    return q, k, v, bt, cl


def probe_compare(kind, inputs, P, layer):
    """(max_abs_err, error over its bar) of one probe launch against its
    plain version on the same inputs (``kind``: dma_only, reads, dots)."""
    from production_stack_tpu_torch.probes import kernel_dma_only as kdma
    from production_stack_tpu_torch.probes import kernel_probe_strided as kst

    q, k, v, bt, cl = inputs
    if kind == "dma_only":
        got = kdma.dma_only(k, v, bt, cl, layer, pages_per_block=P)
        want = kdma.dma_only_reference(k, v, bt, cl, layer,
                                       pages_per_block=P)
    else:
        got = kst.probe_strided(q, k, v, bt, cl, layer, mode=kind,
                                pages_per_block=P)
        want = kst.probe_strided_reference(q, k, v, bt, cl, layer, mode=kind,
                                           pages_per_block=P)
    tol = PROBE_DOTS_TOL if kind == "dots" else PROBE_GATHER_TOL
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = (got - want).abs().max().item()
    bar = tol * max(want.abs().max().item(), 1e-30)
    return err, err / bar


def check_probe(label, kind, inputs, P, layer):
    """:func:`probe_compare`, logged; raises past the bar."""
    err, over = probe_compare(kind, inputs, P, layer)
    log(f"[probe] {label}: max_abs_err={err:.3e} err/bar={over:.3f}")
    if not over <= 1.0:
        raise AssertionError(f"{label}: error {over:.3f}x its bar")
    return err


def check_probe_rate(label, nbytes, seconds):
    """Raise if a probe read faster than the card's memory can deliver."""
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    rate = nbytes / seconds
    if rate > PROBE_RATE_FACTOR * HBM_BYTES_PER_S:
        raise AssertionError(
            f"{label}: {rate / 1e12:.2f} TB/s is above 1.05 x 3.35 TB/s: "
            f"the probe copied less than it counts")
    return rate


def _probe_counters():
    """The launch counter of each probe entry: (wrapper, attribute)."""
    from production_stack_tpu_torch.probes.kernel_dma_only import dma_only
    from production_stack_tpu_torch.probes.kernel_probe_strided import (
        MODES,
        probe_strided,
    )

    out = {f"kernel_dma_only_{d}": (dma_only, f"launches_{d}")
           for d in PROBE_DTYPES}
    out.update({f"kernel_probe_strided_{m}_{d}": (probe_strided,
                                                   f"launches_{m}_{d}")
                for m in MODES for d in PROBE_DTYPES})
    return out


def _decode_all_layers_ms(q, k, v, bt, cl, dtype):
    """Device ms of the port's decode kernel over every layer of a probe
    pool at contexts ``cl`` (int8 pages get scales of one, so the kernel
    does its dequant)."""
    import torch

    from production_stack_tpu_torch.ops.paged_attention import (
        paged_attention,
    )
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    L, NB, bs, KVH, D = k.shape
    if dtype == torch.int8:
        ones = torch.ones((L, NB, bs * KVH), device="cuda")
        k, v = (k, ones), (v, ones)

    def call():
        for layer in range(L):
            paged_attention(q, k, v, bt, cl, layer, scale=D ** -0.5)

    return cuda_time_ms(call)


def _plain_run(mode, P, q, k, v, bt, cl):
    """The plain version of ``build(mode, P)``'s run."""
    import torch

    from production_stack_tpu_torch.probes import kernel_probe_strided as kst

    acc = torch.zeros(8, device=q.device)
    for layer in range(k.shape[0]):
        acc += kst.probe_strided_reference(
            q, k, v, bt, cl, layer, mode=mode, pages_per_block=P)[0, 0, :8]
    return acc.reshape(1, 8)


def _decomposition(rows, q, k, v, bt, cl, dtype):
    """The decode kernel's time split by the probes at P = MAXB, where the
    strided probe has the decode kernel's grid, tiles and loads and reads
    the same tokens (every live sequence's table in full, as the probes
    read whole chunks): the ring gather of whole pages (``dma_only``), the
    kernel's per-head loads over it (reads - dma_only), its products
    (dots - reads) and its softmax with the rest (the decode kernel over
    the same tokens - dots). With int8 pages the decode kernel also reads
    and applies the scales (1/32 of the code bytes at D = 128), which
    lands in the last term."""
    import torch

    MAXB, bs = bt.shape[1], k.shape[2]
    read_lens = torch.where(cl > 0, MAXB * bs, 0).to(cl.dtype)
    decode_s = rows["decode_kernel_all_L_s"] if torch.equal(read_lens, cl) \
        else _decode_all_layers_ms(q, k, v, bt, read_lens, dtype) / 1e3
    dma_s = rows[f"dma_only_P{MAXB}"]["dma_only_all_L_s"]
    reads_s = rows[f"reads_P{MAXB}"]["all_L_s"]
    dots_s = rows[f"dots_P{MAXB}"]["all_L_s"]
    return {"P": MAXB, "tokens_per_sequence": MAXB * bs,
            "decode_kernel_s": decode_s, "ring_gather_s": dma_s,
            "strided_loads_s": reads_s - dma_s,
            "products_s": dots_s - reads_s,
            "products_tflops": rows[f"dots_P{MAXB}"]["gflop"] / 1e3
            / (dots_s - reads_s),
            "softmax_rest_s": decode_s - dots_s}


def probe_phase():
    """Both probe kernels against their plain versions (small shapes, the
    8B decode case, the JAX shapes; every mode and page dtype), then the
    probe path driven through its entry points with every probe counter
    set to 0 just before and read just after: at both shapes the
    ``dma_only``, ``reads`` and ``dots`` sweeps of ``PROBE_SWEEPS`` (and
    the contiguous yardstick at the JAX shapes), each held to the rate
    limit, the decode kernel on the same pools and its decomposition.
    Returns (per-entry measurements, the ``probes`` summary)."""
    import torch

    from production_stack_tpu_torch.probes import kernel_dma_only as kdma
    from production_stack_tpu_torch.probes import kernel_probe_strided as kst
    from production_stack_tpu_torch.probes.common import (
        BF16_FLOPS,
        HBM_BYTES_PER_S,
    )
    from production_stack_tpu_torch.probes.timing import cuda_time_ms

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}
    kinds = ("dma_only", "reads", "dots")
    # Small shapes: ragged contexts incl. 0 and 1 token, GQA 3 and 6,
    # pages of 4-16 tokens, every head dim the kernel is built for.
    for i, (bs, KVH, D, G, MAXB, ctx) in enumerate([
            (16, 2, 64, 3, 8, [1, 40, 0, 128]),
            (8, 4, 128, 6, 12, [96, 0, 17, 1]),
            (4, 1, 32, 8, 16, [64, 33, 1, 0])]):
        shape = dict(B=4, MAXB=MAXB, NB=4 * MAXB + 3, ctx=ctx, L=2, bs=bs,
                     KVH=KVH, D=D, G=G)
        for name, dtype in dtypes.items():
            inputs = probe_inputs(shape, dtype, seed=i)
            for kind in kinds:
                if kind == "dma_only" and bs < 8:
                    continue
                for P in (1, 2, 4):
                    if kind != "dma_only" and G > P * bs:
                        continue
                    check_probe(f"{kind} small case {i} {name} P={P}", kind,
                                inputs, P, 1)
    errs = {name: 0.0 for name in _probe_counters()}

    def entry(kind, dname):
        if kind == "dma_only":
            return f"kernel_dma_only_{dname}"
        return f"kernel_probe_strided_{kind}_{dname}"

    for label, shape in (("decode_case", DECODE_PROBE_SHAPE),
                         ("jax_shapes", JAX_PROBE_SHAPE)):
        for dname in PROBE_DTYPES:
            inputs = probe_inputs(shape, dtypes[dname])
            for kind in kinds:
                for P in PROBE_SWEEPS[label][1]:
                    err = check_probe(f"{kind} {label} {dname} P={P}", kind,
                                      inputs, P, shape["L"] - 1)
                    errs[entry(kind, dname)] = max(errs[entry(kind, dname)],
                                                   err)
            if label == "jax_shapes":
                # The JAX scripts' checksum, over every layer.
                for mode in kst.MODES:
                    got = kst.build(mode, 8)(*inputs)
                    want = _plain_run(mode, 8, *inputs)
                    err = (got - want).abs().max().item()
                    tol = PROBE_DOTS_TOL if mode == "dots" else \
                        PROBE_GATHER_TOL
                    log(f"[probe] {mode} {label} {dname} run checksum: "
                        f"max_abs_err={err:.3e}")
                    if not err <= tol * max(want.abs().max().item(), 1e-30):
                        raise AssertionError(f"{mode} {dname}: run checksum "
                                             f"off by {err:.3e}")
                    errs[entry(mode, dname)] = max(errs[entry(mode, dname)],
                                                   err)
            del inputs
            _free_device_memory()

    counters = _probe_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    summary = {"jax_shapes": {}, "decode_case": {}}
    results = {}
    for dname in PROBE_DTYPES:
        dtype = dtypes[dname]
        for label, shape in (("jax_shapes", JAX_PROBE_SHAPE),
                             ("decode_case", DECODE_PROBE_SHAPE)):
            q, k, v, bt, cl = probe_inputs(shape, dtype)
            rows = {}
            if label == "jax_shapes":
                contig = kdma.contiguous_row(k)
                check_probe_rate(f"torch.sum {dname}",
                                 contig["pool_gb"] * 1e9,
                                 contig["contiguous_sum_s"])
                rows["contiguous"] = contig
            gather_ps, strided_ps = PROBE_SWEEPS[label]
            for P in gather_ps:
                row = kdma.sweep_row(k, v, bt, cl, P)
                check_probe_rate(f"dma_only {label} {dname} P={P}",
                                 row["bytes_gb"] * 1e9,
                                 row["dma_only_all_L_s"])
                rows[f"dma_only_P{P}"] = row
            for mode in kst.MODES:
                for P in strided_ps:
                    row = kst.sweep_row(q, k, v, bt, cl, mode, P)
                    check_probe_rate(f"{mode} {label} {dname} P={P}",
                                     row["bytes_gb"] * 1e9, row["all_L_s"])
                    rows[f"{mode}_P{P}"] = row
            rows["decode_kernel_all_L_s"] = _decode_all_layers_ms(
                q, k, v, bt, cl, dtype) / 1e3
            rows["decomposition"] = _decomposition(rows, q, k, v, bt, cl,
                                                   dtype)
            rows["split_gather_headroom"] = (
                rows[f"dma_only_P{gather_ps[-1]}"]["dma_only_all_L_s"]
                / rows[f"dma_only_P{gather_ps[0]}"]["dma_only_all_L_s"])
            summary[label][dname] = rows
            log(f"[probe] {label} {dname}: {json.dumps(rows)}")
            if label == "jax_shapes":
                # The kernels line: each entry at P=8, the JAX scripts'
                # default.
                L = k.shape[0]
                dma8 = rows["dma_only_P8"]
                plain_dma = cuda_time_ms(lambda: kdma.dma_only_reference(
                    k, v, bt, cl, L - 1, pages_per_block=8), iters=5)
                results[f"kernel_dma_only_{dname}"] = dict(
                    ms=dma8["dma_only_all_L_s"] * 1e3 / L,
                    plain_ms=plain_dma, bytes=dma8["bytes_gb"] * 1e9 / L,
                    ops=0)
                for mode in kst.MODES:
                    row = rows[f"{mode}_P8"]
                    results[f"kernel_probe_strided_{mode}_{dname}"] = dict(
                        ms=row["all_L_s"] * 1e3,
                        plain_ms=cuda_time_ms(lambda mode=mode: _plain_run(
                            mode, 8, q, k, v, bt, cl), iters=3, warmup=1),
                        bytes=row["bytes_gb"] * 1e9, ops=row["gflop"] * 1e9)
            del q, k, v, bt, cl
            _free_device_memory()
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the probe path")
    for name, r in results.items():
        byte_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = r["ops"] / BF16_FLOPS * 1e3
        r.update(max_abs_err=errs[name], launches=launches[name],
                 bound_ms=max(byte_ms, op_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations",
                 library_ms=None)
        log(f"[probe] {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"launches={r['launches']}")
    return results, summary


# -- served main path ---------------------------------------------------------

SERVE_ARGS = ["meta-llama/Llama-3-8B", "--device", "cuda", "--host",
              "127.0.0.1", "--port", "0", "--max-model-len", "4096",
              "--max-num-seqs", "8", "--seed", "0"]
INT8_ARGS = ["--kv-cache-dtype", "int8", "--quantization", "int8"]
REQUIRED_SERIES = (
    "vllm:num_requests_running", "vllm:num_requests_waiting",
    "vllm:gpu_cache_usage_perc", "vllm:gpu_prefix_cache_hits_total",
    "vllm:gpu_prefix_cache_queries_total", "tpu:hbm_kv_usage_perc",
    "tpu:prefix_cache_hits_total", "tpu:prefix_cache_queries_total",
    "tpu:hbm_headroom_bytes")


def _text(seed: int, n_chars: int) -> str:
    import numpy as np

    words = ["paged", "attention", "serves", "every", "decode", "step",
             "while", "prefix", "pages", "stay", "resident", "on", "the",
             "card", "and", "chunks", "stream", "through", "kernels"]
    rng = np.random.default_rng(seed)
    out = ""
    while len(out) < n_chars:
        out += words[int(rng.integers(len(words)))] + " "
    return out[:n_chars]


class Client:
    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def post(self, path: str, body: dict, stream: bool = False):
        import urllib.request

        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            if not stream:
                out = json.loads(resp.read().decode())
                out["_latency_s"] = time.perf_counter() - t0
                return out
            text, finish, first_s = "", None, None
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                piece = choice.get("delta", {}).get("content") or ""
                if piece and first_s is None:
                    first_s = time.perf_counter() - t0
                text += piece
                finish = choice.get("finish_reason") or finish
            return {"text": text, "finish_reason": finish,
                    "_latency_s": time.perf_counter() - t0,
                    "_first_token_s": first_s}

    def get(self, path: str) -> str:
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=60) as resp:
            return resp.read().decode()


def _finish(name: str, out: dict) -> str:
    if "choices" in out:
        finish = out["choices"][0]["finish_reason"]
    else:
        finish = out["finish_reason"]
    if finish not in ("stop", "length"):
        raise AssertionError(f"{name}: finish_reason {finish!r}")
    return finish


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _counters():
    """The launch counter of each kernel entry: (wrapper, attribute); the
    probes' too, so that a served run shows it never launched them."""
    from production_stack_tpu_torch.ops.paged_attention import paged_attention
    from production_stack_tpu_torch.ops.prefill_attention import (
        cached_prefill_attention,
    )

    return {"paged_attention": (paged_attention, "launches"),
            "cached_prefill_attention": (cached_prefill_attention,
                                         "launches"),
            "paged_attention_int8": (paged_attention, "launches_int8"),
            "cached_prefill_attention_int8": (cached_prefill_attention,
                                              "launches_int8"),
            **_probe_counters()}


def _weight_bytes(params):
    """(bytes stored, bytes a decode step's products move): an int8 leaf
    with its scale is read as int8, then copied to bf16 and that copy read
    by the product (1 + 2 + 2 bytes a weight); other leaves are read
    once."""
    import torch

    stored = moved = 0
    for t in _leaves(params):
        n = t.numel() * t.element_size()
        stored += n
        moved += 5 * t.numel() if t.dtype == torch.int8 else n
    return stored, moved


def serve_phase(label: str, extra_args, entries):
    """Serve Llama-3-8B through the port's server (``SERVE_ARGS`` plus
    ``extra_args``) and drive it over HTTP; every launch counter is set
    to 0 just before the drive and read just after. Returns (launch counts
    of the served run by kernel entry, summary); raises unless each of
    ``entries`` launched and no other entry did."""
    import threading

    from production_stack_tpu_torch.engine.server import build_server
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    import torch

    t0 = time.time()
    httpd, core = build_server(SERVE_ARGS + list(extra_args))
    torch.cuda.synchronize()
    init_s = time.time() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = Client(httpd.server_address[1])
    stored, moved = _weight_bytes(core.params)
    print(f"[bound] {label} weights: {stored / 1e9:.2f} GB stored -> "
          f"{stored / HBM_BYTES_PER_S * 1e3:.2f} ms per decode step at "
          f"3.35 TB/s; the products move {moved / 1e9:.2f} GB -> "
          f"{moved / HBM_BYTES_PER_S * 1e3:.2f} ms", flush=True)
    summary = {"config": label, "init_s": init_s,
               "num_blocks": core.num_blocks,
               "kv_cache_dtype": core.stats()["kv_cache_dtype"],
               "weight_bytes": stored,
               "weight_read_bound_ms_per_step":
                   stored / HBM_BYTES_PER_S * 1e3,
               "weight_moved_bound_ms_per_step":
                   moved / HBM_BYTES_PER_S * 1e3,
               "device_memory_allocated_gb":
                   torch.cuda.memory_allocated() / 1e9}
    try:
        # Warm-up (first-use library set-up of every GEMM shape, the
        # kernels' first launches): a prefill, a chunk continuation and a
        # decode burst, outside the measured run.
        _finish("warm-up", client.post("/v1/completions", {
            "prompt": _text(99, 1100), "max_tokens": 9, "temperature": 0}))
        base = core.stats()
        counters = _counters()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t_run = time.time()
        # Four concurrent greedy completions: a decode batch of 4. The
        # first prompt is shorter than one 64-token page, so its repeat
        # below cannot hit the prefix cache and recomputes exactly as the
        # first run did (a cache hit takes the cached-prefill path, whose
        # other bf16 rounding may flip a near-tied greedy token).
        prompts = [_text(i, 50 + 80 * i) for i in range(4)]
        results = [None] * 4

        def run(i):
            results[i] = client.post("/v1/completions", {
                "prompt": prompts[i], "max_tokens": 32, "temperature": 0})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for i, out in enumerate(results):
            if out is None:
                raise AssertionError(f"concurrent request {i} got no reply")
            _finish(f"concurrent {i}", out)
        # A ~2,500-token prompt: chunks of 1024 + 1024 + the rest, the
        # later two through the cached-prefill kernel.
        long_prompt = _text(10, 2500)
        long_out = client.post("/v1/completions", {
            "prompt": long_prompt, "max_tokens": 16, "temperature": 0})
        _finish("long prompt", long_out)
        # Shares its first 2,000 characters: a prefix-cache hit.
        hit_out = client.post("/v1/completions", {
            "prompt": long_prompt[:2000] + _text(11, 500), "max_tokens": 16,
            "temperature": 0})
        _finish("prefix hit", hit_out)
        chat_out = client.post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": _text(12, 200)}],
            "max_tokens": 24, "temperature": 0.8, "seed": 7,
            "stream": True}, stream=True)
        _finish("streamed chat", chat_out)
        again = client.post("/v1/completions", {
            "prompt": prompts[0], "max_tokens": 32, "temperature": 0})
        _finish("repeat", again)
        if again["choices"][0]["text"] != results[0]["choices"][0]["text"]:
            raise AssertionError("repeated greedy request gave another text")
        for name, out in [("concurrent 0", results[0]), ("long", long_out),
                          ("hit", hit_out)]:
            usage = out["usage"]
            want = 32 if name.startswith("concurrent") else 16
            if out["choices"][0]["finish_reason"] == "length" and \
                    usage["completion_tokens"] != want:
                raise AssertionError(f"{name}: usage {usage}")
        if not chat_out["text"]:
            raise AssertionError("streamed chat returned no text")
        metrics = client.get("/metrics")
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        missing = [m for m in REQUIRED_SERIES if m not in metrics]
        if missing:
            raise AssertionError(f"/metrics lacks {missing}")
        kv_label = f'kv_cache_dtype="{summary["kv_cache_dtype"]}"'
        if not any(line.startswith("tpu:kv_cache_bytes_per_token{")
                   and kv_label in line for line in metrics.splitlines()):
            raise AssertionError(
                f"/metrics: tpu:kv_cache_bytes_per_token lacks {kv_label}")
        now = core.stats()
        stats = {k: now[k] - base[k] for k in (
            "prefix_cache_hits", "prefill_time_total", "decode_time_total",
            "decode_forward_steps_total", "prefill_chunks_total",
            "cached_tokens_total", "prompt_tokens_total",
            "generation_tokens_total")}
        if stats["prefix_cache_hits"] <= 0:
            raise AssertionError("no prefix-cache hit was served")
        summary.update(
            run_s=time.time() - t_run,
            concurrent_latency_s=[r["_latency_s"] for r in results],
            long_latency_s=long_out["_latency_s"],
            hit_latency_s=hit_out["_latency_s"],
            chat_first_token_s=chat_out["_first_token_s"],
            chat_latency_s=chat_out["_latency_s"],
            prefill_time_s=stats["prefill_time_total"],
            decode_time_s=stats["decode_time_total"],
            decode_forward_steps=stats["decode_forward_steps_total"],
            decode_ms_per_step=1e3 * stats["decode_time_total"]
            / max(stats["decode_forward_steps_total"], 1),
            prefill_chunks=stats["prefill_chunks_total"],
            cached_tokens=stats["cached_tokens_total"],
            prompt_tokens=stats["prompt_tokens_total"],
            generation_tokens=stats["generation_tokens_total"],
            launches=launches,
            sample_text=results[0]["choices"][0]["text"][:40])
    finally:
        httpd.shutdown()
        httpd.server_close()
        core.stop()
    for name, n in launches.items():
        if name in entries and n <= 0:
            raise AssertionError(f"{name} never launched on the {label} "
                                 f"served path")
        if name not in entries and n != 0:
            raise AssertionError(f"{name} launched {n} times on the {label} "
                                 f"served path, which does not use it")
    return {name: launches[name] for name in entries}, summary


def _free_device_memory() -> None:
    """Drop what a finished engine left (its server's handler class holds
    it in a reference cycle) and return the cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def profile_phase(extra_args=()) -> dict:
    """Where a decode step's time goes: Llama-3-8B (``SERVE_ARGS`` plus
    ``extra_args``) with 8 sequences decoding at ~1k context, the engine's
    steps driven on this thread (the engine thread is not started), one
    warm-up burst, two timed bursts, then one burst under torch.profiler
    (its op table goes to standard error)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine.core import EngineCore
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.server import (
        build_arg_parser,
        config_from_args,
    )

    core = EngineCore(config_from_args(build_arg_parser().parse_args(
        SERVE_ARGS + list(extra_args))))
    for i in range(core.config.max_num_seqs):
        core.add_request(
            f"p{i}", core.tokenizer.encode(_text(100 + i, 1000)),
            SamplingParams(temperature=0, max_tokens=200, ignore_eos=True),
            lambda t, f: None)
    with torch.inference_mode():
        while True:
            action, req = core.scheduler.next_action()
            if action != "prefill":
                break
            core._do_prefill(req)
        core._do_decode()  # warm-up burst
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            core._do_decode()
        torch.cuda.synchronize()
        burst_s = (time.perf_counter() - t0) / 2
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            core._do_decode()
            torch.cuda.synchronize()
            prof_wall_s = time.perf_counter() - t0
    from torch.autograd import DeviceType

    K = core.config.decode_steps
    # Device-side rows only (kernels, copies, memsets): the CPU op rows
    # carry their kernels' time as well and would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    table = [{"name": e.key[:70], "calls": e.count,
              "device_ms_per_step": dev_us(e) / 1e3 / K} for e in top]
    log(prof.key_averages().table(row_limit=40))
    core.stop()
    return {
        "config": " ".join(extra_args) or "bf16",
        "rows": core.config.max_num_seqs, "steps_per_burst": K,
        "context_tokens": [len(s.req.all_token_ids)
                           for s in core.scheduler.running()],
        "ms_per_step": 1e3 * burst_s / K,
        "profiled_ms_per_step": 1e3 * prof_wall_s / K,
        "device_busy_ms_per_step": busy_us / 1e3 / K,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / prof_wall_s),
        "top_device_ops": table,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile the decode step (no result line)")
    args = ap.parse_args(argv)

    os.environ.setdefault("TPU_STACK_LOG_LEVEL", "WARNING")
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "production_stack_tpu_torch")):
        log("chip_smoke: run it from a checkout of the repo "
            "(production_stack_tpu_torch/ not found beside it)")
        return 2
    sys.path.insert(0, here)
    from production_stack_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    if args.profile:
        for extra in ((), INT8_ARGS):
            report = profile_phase(extra)
            print(json.dumps({"profile": report}), flush=True)
            _free_device_memory()
        print(f"card: {smi}", flush=True)
        return 0
    t0 = time.time()
    _build.build(["paged_attention", "prefill_attention", "page_probes"],
                 verbose=True)
    build_s = time.time() - t0
    for name, text in _build.build.last_log.items():
        log(f"[build] {name}:\n{text}")
    log(f"[build] all three kernel libraries built in {build_s:.1f} s")

    results = kernel_phase()
    probe_results, probes = probe_phase()
    print(json.dumps({"probes": probes}), flush=True)
    launches = {}
    for label, extra, entries in (
            ("bf16", (), ("paged_attention", "cached_prefill_attention")),
            ("int8 KV + int8 weights", INT8_ARGS,
             ("paged_attention_int8", "cached_prefill_attention_int8"))):
        # The previous engine's pool and weights go before the next one
        # sizes its pool from free memory.
        _free_device_memory()
        counts, summary = serve_phase(label, extra, entries)
        launches.update(counts)
        log(f"[serve] {json.dumps(summary)}")
        print(json.dumps({"serve": summary}), flush=True)
    results.update(probe_results)
    replaces = {
        "paged_attention":
            "production_stack_tpu/ops/pallas_paged_attention.py:231",
        "cached_prefill_attention":
            "production_stack_tpu/ops/pallas_prefill_attention.py:221",
        "kernel_dma_only": "benchmarks/kernel_dma_only.py:81",
        "kernel_probe_strided": "benchmarks/kernel_probe_strided.py:117"}
    sources = {
        "paged_attention":
            "production_stack_tpu_torch/csrc/paged_attention.cu",
        "cached_prefill_attention":
            "production_stack_tpu_torch/csrc/prefill_attention.cu",
        "kernel_dma_only": "production_stack_tpu_torch/csrc/page_probes.cu",
        "kernel_probe_strided":
            "production_stack_tpu_torch/csrc/page_probes.cu"}
    launches.update({name: r["launches"]
                     for name, r in probe_results.items()})
    kernels = []
    for name, r in results.items():
        base = next(b for b in replaces if name.startswith(b))
        kernels.append(dict(
            name=name, route="cuda", source=sources[base],
            replaces=replaces[base], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
