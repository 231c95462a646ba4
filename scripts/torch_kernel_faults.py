#!/usr/bin/env python3
"""Planted-fault check of the port's CUDA kernels (needs a card).

    python3 scripts/torch_kernel_faults.py

Shows that the kernel-vs-plain check of ``chip_smoke.py`` catches the
faults the bf16 kernels are prone to, at the Llama-3-8B main-path shapes:
for each kernel it builds copies of the sources with one fault planted,
each in a temporary directory under the git-ignored build directory,
swaps the faulty library in behind the kernel's wrapper, and holds the
output against the plain version with ``chip_smoke.compare`` on every
main-path case of that kernel entry (the int8 faults on the int8-page
cases). The faults: in the tensor-core cached prefill the last key tile
skipped, the accumulator rescale left out on the second tile, and the
causal test off by one (``<`` for ``<=``); in the split-K decode one
split's partial left out of the merge, and the last live split of each
sequence skipping its last tile; in the int8 page staging of both
(``csrc/mma.cuh``) each row's scale read from kv head 0's row, or the
scale left out. The unchanged kernels go through the same cases first
and must pass.

The page probes (``csrc/page_probes.cu``) get seven faults: ``dma_only``
copying only the 8 token rows its checksum consumes (every consumed value
stays right, so only chip_smoke.py's rate check can catch it: the sweep
at the JAX shapes must read above 1.05 x 3.35 TB/s); in the strided
probe on the decode kernel's tiles, ``reads`` loading only the first G
token rows of each chunk (every value ``reads`` consumes stays right; the
rate check of its sweep and the value check of ``dots``, which shares its
ring, catch it), the last live chunk skipped, the ``S_lo`` term of the
two-term ``S . V`` dropped, the chunk's last 64-key tile skipped,
``reads`` staging kv head 0's rows, and the int8 dequantizing pass
skipped (int8 cases). So a probe fault is held to the checks of every
mode and page dtype that runs the faulted code.

Prints one JSON line per kernel build (``{"clean": ...}`` or
``{"fault": ...}``, with each case's max_abs_err and error over its bar),
then the card's ``nvidia-smi`` name and power limit. Exits 1 if a clean
kernel fails its bar or a planted fault passes every case.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel entry (chip_smoke.KERNELS) -> (library name, faults)
# A fault is (label, source file (None: the library's .cu), text of the
# source it replaces, replacement).
_TILES = "const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;"
# The keys the decode kernel hands to the ring (csrc/decode_ring.cuh).
_SPLIT_KEYS = ("ring, k_pages, v_pages, k_scales, v_scales, pr, start, "
               "n_keys, tid,")
_RESCALE = ("          o[dn][2 * h] *= alpha;\n"
            "          o[dn][2 * h + 1] *= alpha;")
_CAUSAL = "const bool live = key <= rp && key < total;"
_MERGE_W = "const float w = ls > 0.f ? __expf(wgt[s * 16 + r] - M) : 0.f;"
# The int8 page staging that both kernels share (csrc/mma.cuh).
_SCALE_LOAD = ("    cp_async4(ks + tid, k_scales + row, scale_live);\n"
               "    cp_async4(vs + tid, v_scales + row, scale_live);")
_DEQUANT = ("h[j] = pack_bf16((float)b[2 * j] * s, "
            "(float)b[2 * j + 1] * s);")
_SCALE_FAULTS = [
    ("scale of kv head h read from head 0", "mma.cuh", _SCALE_LOAD,
     "    cp_async4(ks + tid, k_scales + row - (scale_live ? pr.kvh : 0),"
     " scale_live);\n"
     "    cp_async4(vs + tid, v_scales + row - (scale_live ? pr.kvh : 0),"
     " scale_live);"),
    ("scale left out", "mma.cuh", _DEQUANT,
     "h[j] = pack_bf16((float)b[2 * j], (float)b[2 * j + 1]);"),
]
FAULTS = {
    "paged_attention": ("paged_attention", [
        ("one split's partial left out of the merge", None, _MERGE_W,
         "const float w = (ls > 0.f && s != splits / 2) ? "
         "__expf(wgt[s * 16 + r] - M) : 0.f;"),
        ("the last live split skips its last tile", None, _SPLIT_KEYS,
         "ring, k_pages, v_pages, k_scales, v_scales, pr, start, "
         "start + split_tokens >= ctx ? (n_keys - 1) / kKeyTile * kKeyTile "
         ": n_keys, tid,"),
    ]),
    "cached_prefill_attention": ("prefill_attention", [
        ("skip the last key tile", None, _TILES,
         "const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile - 1;"),
        ("no accumulator rescale in the second tile", None, _RESCALE,
         "          o[dn][2 * h] *= it == 1 ? 1.f : alpha;\n"
         "          o[dn][2 * h + 1] *= it == 1 ? 1.f : alpha;"),
        ("causal test off by one (< for <=)", None, _CAUSAL,
         "const bool live = key < rp && key < total;"),
    ]),
    "paged_attention_int8": ("paged_attention", _SCALE_FAULTS),
    "cached_prefill_attention_int8": ("prefill_attention", _SCALE_FAULTS),
}


def _plant(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"fault anchor not found exactly once: {old!r}")
    return src.replace(old, new)


def _build_faulty(_build, workdir: str, plants):
    """Compile every faulty copy, one nvcc each, all started together.
    ``plants``: [(kernel entry, label, library name, source file, anchor,
    replacement)]. Returns [(kernel entry, label, library path)]."""
    jobs = []
    for i, (kernel, label, lib_name, where, old, new) in enumerate(plants):
        d = os.path.join(workdir, f"{kernel}-{i}")
        os.makedirs(d)
        for name in os.listdir(_build.CSRC):
            if name.endswith(".cuh") or name == f"{lib_name}.cu":
                shutil.copy(os.path.join(_build.CSRC, name), d)
        target = os.path.join(d, where or f"{lib_name}.cu")
        with open(target) as f:
            src = f.read()
        with open(target, "w") as f:
            f.write(_plant(src, old, new))
        cu = os.path.join(d, f"{lib_name}.cu")
        out = os.path.join(d, f"{lib_name}.so")
        cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", d, "-o", out, cu]
        jobs.append((kernel, label, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    built = []
    for kernel, label, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} / {label}:\n{log}")
        built.append((kernel, label, out))
    return built


def _run_cases(chip_smoke, kernel, cases):
    import torch

    run, plain = chip_smoke.KERNELS[kernel]
    out = []
    for label, name, c, rows in cases:
        if name != kernel:
            continue
        err, over = chip_smoke.compare(run(c), plain(c), rows)
        torch.cuda.synchronize()
        out.append({"case": label, "max_abs_err": err, "err_over_bar": over,
                    "caught": not over <= 1.0})
    return out


def _run_probe_cases(chip_smoke, kind, dname, inputs):
    """The checks of chip_smoke.py's probe phase that a fault of ``kind``
    must fail, over ``dname`` pages: the value against the plain version
    (every kind), and for the copying probes also the rate of a sweep over
    all layers at the JAX shapes (P=8), as a multiple of the card's
    3.35 TB/s."""
    from production_stack_tpu_torch.probes import kernel_dma_only as kdma
    from production_stack_tpu_torch.probes import kernel_probe_strided as kst
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    out = []
    for label, case, P in (("jax shapes", "jax", 8), ("jax shapes", "jax", 64),
                           ("8x2048", "decode", 4)):
        case_inputs = inputs[case, dname]
        err, over = chip_smoke.probe_compare(kind, case_inputs, P,
                                             case_inputs[1].shape[0] - 1)
        out.append({"case": f"{kind} {label} {dname} P={P}",
                    "max_abs_err": err, "err_over_bar": over,
                    "caught": not over <= 1.0})
    if kind != "dots":
        q, k, v, bt, cl = inputs["jax", dname]
        if kind == "dma_only":
            row = kdma.sweep_row(k, v, bt, cl, 8)
            seconds = row["dma_only_all_L_s"]
        else:
            row = kst.sweep_row(q, k, v, bt, cl, kind, 8)
            seconds = row["all_L_s"]
        rate = row["bytes_gb"] * 1e9 / seconds
        out.append({"case": f"{kind} sweep rate, jax shapes {dname} P=8",
                    "rate_over_hbm": rate / HBM_BYTES_PER_S,
                    "caught": rate / HBM_BYTES_PER_S
                    > chip_smoke.PROBE_RATE_FACTOR})
    return out


# Planted faults of the page probes: (label, source file (None:
# csrc/page_probes.cu), anchor, replacement, the (probe kind, page dtype)
# checks it must fail). The dma_only copy fault leaves every value the
# probe consumes in place, so only the rate check can catch it.
_DMA_COPY = "const int n16 = T * row16;"
_CHUNK_KEYS = ("ring, k_pages, v_pages, k_scales, v_scales, pr, start, "
               "span, tid,")
_TILE_LIVE = ("if (start >= context_lens[b]) return;  "
              "// a chunk past the context")
_LO_TERM = "            mma::pv_16<D, KS>(o, lo, vt + 16 * warp * KS, lane);\n"
_HEAD = "                         bs, KVH, kvh};"
_STAGING = ("      mma::dequant_kv_tile<D, kKeyTile, kThreads>(st, kd, vd, "
            "tid);\n")
_STRIDED = (("reads", "bf16"), ("dots", "bf16"))
PROBE_FAULTS = [
    ("dma_only: copy only the 8 token rows the checksum consumes", None,
     _DMA_COPY, "const int n16 = (p == 0 && t0 < 8) ? "
     "min(T, 8 - t0) * row16 : 0;", (("dma_only", "bf16"),)),
    ("load only the first G token rows of each chunk", None, _CHUNK_KEYS,
     "ring, k_pages, v_pages, k_scales, v_scales, pr, start, min(span, G), "
     "tid,", _STRIDED),
    ("skip the last live chunk", None, _TILE_LIVE,
     "if (start + span >= context_lens[b]) return;", _STRIDED),
    ("dots: the S_lo term of S . V dropped", None, _LO_TERM, "",
     (("dots", "bf16"),)),
    ("skip the chunk's last 64-key tile", None, _CHUNK_KEYS,
     "ring, k_pages, v_pages, k_scales, v_scales, pr, start, "
     "(span - 1) / kKeyTile * kKeyTile, tid,", _STRIDED),
    ("reads: kv head 0's rows staged", None, _HEAD,
     "                         bs, KVH, DOTS ? kvh : 0};",
     (("reads", "bf16"),)),
    # In the ring the decode kernel shares; only the probe's library is
    # rebuilt with it.
    ("int8: the dequantizing pass skipped", "decode_ring.cuh", _STAGING, "",
     (("reads", "int8"), ("dots", "int8"))),
]


def _swap_in(_build, lib_name, path):
    lib = ctypes.CDLL(path)
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _build._libs[lib_name] = lib  # the wrapper now launches it


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_faults: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from production_stack_tpu_torch.ops import _build

    smi = chip_smoke.nvidia_smi_line()
    cases = chip_smoke.main_path_cases()
    probe_inputs = {
        (case, dname): chip_smoke.probe_inputs(shape, dtype)
        for case, shape in (("jax", chip_smoke.JAX_PROBE_SHAPE),
                            ("decode", chip_smoke.DECODE_PROBE_SHAPE))
        for dname, dtype in (("bf16", torch.bfloat16),
                             ("int8", torch.int8))}
    ok = True
    for kernel, (lib_name, _) in FAULTS.items():
        _build.load(lib_name)
        rows = _run_cases(chip_smoke, kernel, cases)
        ok &= not any(r["caught"] for r in rows)
        print(json.dumps({"clean": {"kernel": kernel, "cases": rows}}),
              flush=True)
    _build.load("page_probes")
    for kind, dname in sorted({c for *_, checks in PROBE_FAULTS
                               for c in checks}):
        rows = _run_probe_cases(chip_smoke, kind, dname, probe_inputs)
        ok &= not any(r["caught"] for r in rows)
        print(json.dumps({"clean": {"kernel": f"page_probes {kind} {dname}",
                                    "cases": rows}}), flush=True)
    clean = dict(_build._libs)
    plants = [(kernel, label, lib_name, where, old, new)
              for kernel, (lib_name, faults) in FAULTS.items()
              for label, where, old, new in faults]
    plants += [(i, label, "page_probes", where, old, new)
               for i, (label, where, old, new, _) in enumerate(PROBE_FAULTS)]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        for kernel, label, path in _build_faulty(_build, workdir, plants):
            probe = isinstance(kernel, int)  # an index of PROBE_FAULTS
            lib_name = "page_probes" if probe else FAULTS[kernel][0]
            _swap_in(_build, lib_name, path)
            try:
                if probe:
                    rows = [r for kind, dname in PROBE_FAULTS[kernel][4]
                            for r in _run_probe_cases(chip_smoke, kind,
                                                      dname, probe_inputs)]
                else:
                    rows = _run_cases(chip_smoke, kernel, cases)
            finally:
                _build._libs[lib_name] = clean[lib_name]
            caught = any(r["caught"] for r in rows)
            ok &= caught
            print(json.dumps({"fault": {
                "kernel": "page_probes" if probe else kernel, "fault": label,
                "caught": caught, "cases": rows}}), flush=True)
    print(f"card: {smi}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
