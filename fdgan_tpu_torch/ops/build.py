"""Build and load the hand-written CUDA kernels.

The sources under ``fdgan_tpu_torch/csrc`` are compiled at first use with
``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/kernels/<hash>/`` at the root of
the checkout (``FDGAN_KERNEL_DIR`` overrides it), keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already built. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("dense_layer.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (all return an int: cudaGetLastError() after launch)
_SIGNATURES = {
    "fdgan_dense_layer_f32": [_P] * 8 + [_I] * 4 + [_P],
    "fdgan_dense_layer_bf16": [_P] * 8 + [_I] * 4 + [_P],
    "fdgan_h_stats_f32": [_P] * 6 + [_I] * 2 + [_P],
    "fdgan_h_stats_bf16": [_P] * 6 + [_I] * 2 + [_P],
    "fdgan_h_stats_rows": [],
}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall time of the build in this process (0 if it was cached)
build_log = ""       # nvcc's output, including ptxas's register and spill report


def kernel_dir() -> Path:
    root = os.environ.get("FDGAN_KERNEL_DIR")
    return Path(root) if root else Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if no build of these
    sources exists. Safe to call from several threads; concurrent processes
    each build into a temporary file and the last rename wins."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = kernel_dir() / _digest()
        so = out_dir / "libfdgan_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            (out_dir / "build.log").write_text(build_log)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fdgan_error_string.argtypes = [ctypes.c_int]
        lib.fdgan_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.fdgan_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
