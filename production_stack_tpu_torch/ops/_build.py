"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use, on the machine that has the card, into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc -o _build/<name>-<hash>.so csrc/<name>.cu

The library is loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, every size ``c_int``, and each launch function returns
``cudaGetLastError()``, which the wrappers turn into an exception. Only
the sources in the checkout are used; the output directory
(``production_stack_tpu_torch/_build/``) is ignored by git and keyed by
a hash of the sources, so an edited kernel is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit")


def _sources(name: str):
    main = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return main, headers


def _lib_path(name: str) -> str:
    main, headers = _sources(name)
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for path in [main] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str, verbose: bool):
    main, _ = _sources(name)
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", CSRC, "-o", out, main]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    return cmd


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns name -> library path;
    raises with the compiler's output if any build fails. With
    ``verbose`` the compiler's register/shared-memory report is
    returned in ``build.last_log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        path = _lib_path(name)
        paths[name] = path
        if os.path.exists(path) and not verbose:
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            _compile_cmd(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, paths[name])
    build.last_log = logs
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(logs[n] for n in failed)))
    return paths


build.last_log = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(path)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
