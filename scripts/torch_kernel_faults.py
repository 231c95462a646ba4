#!/usr/bin/env python3
"""Planted-fault check of the port's CUDA attention kernels (needs a card).

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


def _build_faulty(_build, workdir: str):
    """Compile every faulty copy, one nvcc each, all started together.
    Returns [(kernel, label, library path)]."""
    jobs = []
    for kernel, (lib_name, faults) in FAULTS.items():
        with open(os.path.join(_build.CSRC, f"{lib_name}.cu")) as f:
            src = f.read()
        for i, (label, old, new) in enumerate(faults):
            d = os.path.join(workdir, f"{kernel}-{i}")
            os.makedirs(d)
            for h in os.listdir(_build.CSRC):
                if h.endswith(".cuh"):
                    shutil.copy(os.path.join(_build.CSRC, h), d)
            cu = os.path.join(d, f"{lib_name}.cu")
            with open(cu, "w") as f:
                f.write(_plant(src, old, new))
            out = os.path.join(d, f"{lib_name}.so")
            cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", d, "-o",
                   out, cu]
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
    ok = True
    for kernel, (lib_name, _) in FAULTS.items():
        _build.load(lib_name)
        rows = _run_cases(chip_smoke, kernel, cases)
        ok &= not any(r["caught"] for r in rows)
        print(json.dumps({"clean": {"kernel": kernel, "cases": rows}}),
              flush=True)
    clean = dict(_build._libs)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        for kernel, label, path in _build_faulty(_build, workdir):
            lib_name = FAULTS[kernel][0]
            lib = ctypes.CDLL(path)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _build._libs[lib_name] = lib  # the wrapper now launches it
            try:
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
