"""Build and load the hand-written CUDA kernels.

The sources under ``fdgan_tpu_torch/csrc`` are compiled at first use with
``nvcc``, one process per source, all started together, and linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/<hash>/`` at the root of the checkout
(``FDGAN_KERNEL_DIR`` overrides it), keyed by a hash of the sources, the
headers they include and the flags, so an edited source rebuilds and an
unchanged one loads the library already built. Nothing here runs at import.
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
SOURCES = ("dense_layer.cu", "freq_filters.cu", "probes.cu", "channel_stats.cu")
HEADERS = ("mma_bf16.cuh", "wgmma_bf16.cuh", "wgmma_tf32.cuh")  # included by the sources: part of the build's hash
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes (all return an int: cudaGetLastError() after launch)
_SIGNATURES = {
    "fdgan_dense_layer_f32": [_P] * 8 + [_I] * 8 + [_P],
    "fdgan_dense_layer_bf16": [_P] * 8 + [_I] * 8 + [_P],
    "fdgan_h_stats_f32": [_P] * 6 + [_I] * 3 + [_P],
    "fdgan_h_stats_f32_blocks": [_I],
    "fdgan_h_stats_bf16": [_P] * 6 + [_I] * 3 + [_P],
    "fdgan_h_stats_bf16_mma": [_P] * 6 + [_I] * 3 + [_P],
    "fdgan_h_stats_bf16_blocks": [_I],
    "fdgan_h_stats_rows": [],
    "fdgan_tw1_stamps": [_P, _I],
    "fdgan_tf32x3_selfcheck": [_P] * 3 + [_I] * 4 + [_P],
    "fdgan_channel_stats_bf16": [_P] * 3 + [_I] * 4 + [_P],
    "fdgan_channel_stats_blocks": [_I, _I],
    "fdgan_freq_filters_f32": [_P] * 3 + [_I] * 3 + [_P],
    "fdgan_freq_filters_bf16": [_P] * 3 + [_I] * 3 + [_P],
    "fdgan_freq_filters_halo_f32": [_P] * 5 + [_I] * 3 + [_P],
    "fdgan_freq_filters_halo_bf16": [_P] * 5 + [_I] * 3 + [_P],
    "fdgan_probe_mm": [_P] * 3 + [_I] * 2 + [_P],
    "fdgan_probe_scale_copy": [_P, _P, _L, _I, _P],
    "fdgan_probe_conv1": [_P, _P, _I] + [_P] * 4 + [_I, _I, _P],
    "fdgan_probe_conv2": [_P] * 3 + [_I] * 4 + [_P],
    "fdgan_wgmma_selfcheck": [_P] * 3 + [_I] * 7 + [_P],
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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile_and_link(so_path: str) -> str:
    """Compile each source to an object, all ``nvcc`` processes started
    together, then link the objects into ``so_path``. Returns nvcc's output;
    raises if a step fails."""
    nvcc = _nvcc()
    objs = [f"{so_path}.{i}.o" for i in range(len(SOURCES))]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    try:
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(f"--- {src}\n{out}" for src, out in zip(SOURCES, outs))
        failed = [f"{src} ({proc.returncode})" for src, proc in zip(SOURCES, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so_path, *objs], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        return log
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)


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
            t0 = time.perf_counter()
            try:
                build_log = _compile_and_link(tmp)
            except RuntimeError:
                os.unlink(tmp)
                raise
            build_seconds = time.perf_counter() - t0
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
