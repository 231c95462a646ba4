#!/usr/bin/env python3
"""Planted-fault check of the port's CUDA kernels (needs a card).

    python3 scripts/torch_kernel_faults.py

Shows that the kernel-vs-plain check of ``chip_smoke.py`` catches the
faults a tiled online softmax is prone to, at the Llama-3-8B main-path
shapes: for each kernel it builds copies of the source with one fault
planted (a key tile skipped, or the running rescale ``alpha`` left out in
one tile; in the int8 page path, each row's scale read from kv head 0's
row, or the scale left out), each in a temporary directory under the
git-ignored build directory, swaps the faulty library in behind the
kernel's wrapper, and holds the output against the plain version with
``chip_smoke.compare`` on every main-path case of that kernel entry (the
int8 faults on the int8-page cases). The unchanged kernels go through
the same cases first and must pass.

The page probes (``csrc/page_probes.cu``) get three faults: ``dma_only``
copying only the 8 token rows its checksum consumes (every consumed value
stays right, so only chip_smoke.py's rate check can catch it: the sweep
at the JAX shapes must read above 1.05 x 3.35 TB/s), ``reads`` loading
only the first G token rows of each chunk, and ``dots`` skipping the last
live chunk (caught by the value check). The ``reads`` fault also leaves
every value ``reads`` consumes right, and ``reads`` in the decode
kernel's layout runs far below the memory rate even with its loads cut,
so the rate check misses it; its load loop is the one ``dots`` runs,
whose value check catches it. So a probe fault is held to the checks of
every mode that runs the faulted code.

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
# A fault is (label, text of the source it replaces, replacement).
_DECODE_LOOP = "for (int start = 0; start < ctx; start += kTile) {"
_DECODE_ALPHA = "float a = acc_sh[i] * alpha_sh[g];"
_PREFILL_LOOP = "for (int k0 = 0; k0 < n_keys; k0 += kTK) {"
_PREFILL_ALPHA = "const float a = alpha_sh[pr * RPT + i];"
# The int8 path of both kernels scales each loaded row by its own scale.
_SCALES = ("scale8(kt, k_scales[row]);\n"
           "          scale8(vt, v_scales[row]);")
_SCALE_FAULTS = [
    ("scale of kv head h read from head 0", _SCALES,
     "scale8(kt, k_scales[row - kvh]);\n"
     "          scale8(vt, v_scales[row - kvh]);"),
    ("scale left out", _SCALES, "")]
FAULTS = {
    "paged_attention": ("paged_attention", [
        ("skip the last key tile", _DECODE_LOOP,
         "for (int start = 0; start + kTile < ctx; start += kTile) {"),
        ("skip the middle key tile", _DECODE_LOOP,
         _DECODE_LOOP + "\n    if (start == ctx / (2 * kTile) * kTile) "
         "continue;"),
        ("no rescale in the second tile", _DECODE_ALPHA,
         "float a = acc_sh[i] * (start == kTile ? 1.f : alpha_sh[g]);"),
        ("no rescale in the middle tile", _DECODE_ALPHA,
         "float a = acc_sh[i] * (start == ctx / (2 * kTile) * kTile ? 1.f "
         ": alpha_sh[g]);"),
    ]),
    "cached_prefill_attention": ("prefill_attention", [
        ("skip the last key tile", _PREFILL_LOOP,
         "for (int k0 = 0; k0 + kTK < n_keys; k0 += kTK) {"),
        ("skip the middle key tile", _PREFILL_LOOP,
         _PREFILL_LOOP + "\n    if (k0 == n_keys / (2 * kTK) * kTK) "
         "continue;"),
        ("no rescale in the second tile", _PREFILL_ALPHA,
         "const float a = k0 == kTK ? 1.f : alpha_sh[pr * RPT + i];"),
        ("no rescale in the middle tile", _PREFILL_ALPHA,
         "const float a = k0 == n_keys / (2 * kTK) * kTK ? 1.f : "
         "alpha_sh[pr * RPT + i];"),
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
    ``plants``: [(kernel entry, label, library name, anchor, replacement)].
    Returns [(kernel entry, label, library path)]."""
    jobs = []
    for i, (kernel, label, lib_name, old, new) in enumerate(plants):
        with open(os.path.join(_build.CSRC, f"{lib_name}.cu")) as f:
            src = f.read()
        d = os.path.join(workdir, f"{kernel}-{i}")
        os.makedirs(d)
        for h in os.listdir(_build.CSRC):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
        cu = os.path.join(d, f"{lib_name}.cu")
        with open(cu, "w") as f:
            f.write(_plant(src, old, new))
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


def _run_probe_cases(chip_smoke, kind, inputs):
    """The checks of chip_smoke.py's probe phase that a fault of ``kind``
    must fail: the value against the plain version (every kind), and for
    the copying probes also the rate of a sweep over all layers at the
    JAX shapes (bf16 pages, P=8), as a multiple of the card's 3.35 TB/s."""
    from production_stack_tpu_torch.probes import kernel_dma_only as kdma
    from production_stack_tpu_torch.probes import kernel_probe_strided as kst
    from production_stack_tpu_torch.probes.common import HBM_BYTES_PER_S

    out = []
    for label, case, P in (("jax shapes", "jax", 8), ("jax shapes", "jax", 64),
                           ("8x2048", "decode", 4)):
        err, over = chip_smoke.probe_compare(kind, inputs[case], P,
                                             inputs[case][1].shape[0] - 1)
        out.append({"case": f"{kind} {label} P={P}", "max_abs_err": err,
                    "err_over_bar": over, "caught": not over <= 1.0})
    if kind != "dots":
        q, k, v, bt, cl = inputs["jax"]
        if kind == "dma_only":
            row = kdma.sweep_row(k, v, bt, cl, 8)
            seconds = row["dma_only_all_L_s"]
        else:
            row = kst.sweep_row(q, k, v, bt, cl, kind, 8)
            seconds = row["all_L_s"]
        rate = row["bytes_gb"] * 1e9 / seconds
        out.append({"case": f"{kind} sweep rate, jax shapes P=8",
                    "rate_over_hbm": rate / HBM_BYTES_PER_S,
                    "caught": rate / HBM_BYTES_PER_S
                    > chip_smoke.PROBE_RATE_FACTOR})
    return out


# Planted faults of the page probes (csrc/page_probes.cu): (probe, label,
# anchor, replacement). The dma_only copy fault leaves every value the
# probe consumes in place, so only the rate check can catch it.
_DMA_COPY = "const int n16 = T * row16;"
_TILE_LOAD = "if (t < n) {"
_TILE_LIVE = ("if ((long long)c * span >= context_lens[b]) return;  "
              "// not a live chunk")
PROBE_FAULTS = [
    ("dma_only", "copy only the 8 token rows the checksum consumes",
     _DMA_COPY, "const int n16 = (p == 0 && t0 < 8) ? "
     "min(T, 8 - t0) * row16 : 0;"),
    ("reads", "load only the first G token rows of each chunk",
     _TILE_LOAD, "if (t < n && start + t < G) {"),
    ("dots", "skip the last live chunk", _TILE_LIVE,
     "if ((long long)(c + 1) * span >= context_lens[b]) return;"),
]
# The probe kinds whose checks run on each fault: those that run the
# faulted code (reads and dots share one load loop).
PROBE_CHECKS = {"dma_only": ("dma_only",), "reads": ("reads", "dots"),
                "dots": ("dots",)}


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
        "jax": chip_smoke.probe_inputs(chip_smoke.JAX_PROBE_SHAPE,
                                       torch.bfloat16),
        "decode": chip_smoke.probe_inputs(chip_smoke.DECODE_PROBE_SHAPE,
                                          torch.bfloat16)}
    ok = True
    for kernel, (lib_name, _) in FAULTS.items():
        _build.load(lib_name)
        rows = _run_cases(chip_smoke, kernel, cases)
        ok &= not any(r["caught"] for r in rows)
        print(json.dumps({"clean": {"kernel": kernel, "cases": rows}}),
              flush=True)
    _build.load("page_probes")
    for kind, *_ in PROBE_FAULTS:
        rows = _run_probe_cases(chip_smoke, kind, probe_inputs)
        ok &= not any(r["caught"] for r in rows)
        print(json.dumps({"clean": {"kernel": "page_probes " + kind,
                                    "cases": rows}}), flush=True)
    clean = dict(_build._libs)
    plants = [(kernel, label, lib_name, old, new)
              for kernel, (lib_name, faults) in FAULTS.items()
              for label, old, new in faults]
    plants += [(kind, label, "page_probes", old, new)
               for kind, label, old, new in PROBE_FAULTS]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        for kernel, label, path in _build_faulty(_build, workdir, plants):
            probe = kernel in ("dma_only", "reads", "dots")
            lib_name = "page_probes" if probe else FAULTS[kernel][0]
            _swap_in(_build, lib_name, path)
            try:
                if probe:
                    rows = [r for kind in PROBE_CHECKS[kernel]
                            for r in _run_probe_cases(chip_smoke, kind,
                                                      probe_inputs)]
                else:
                    rows = _run_cases(chip_smoke, kernel, cases)
            finally:
                _build._libs[lib_name] = clean[lib_name]
            caught = any(r["caught"] for r in rows)
            ok &= caught
            print(json.dumps({"fault": {"kernel": kernel, "fault": label,
                                        "caught": caught, "cases": rows}}),
                  flush=True)
    print(f"card: {smi}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
