"""Build and load the hand-written CUDA kernels.

The sources under ``fdgan_tpu_torch/csrc`` are compiled at first use with
``nvcc``, one process per source, all started together, and linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/<hash>/`` at the root of the checkout
(``FDGAN_KERNEL_DIR`` overrides it), keyed by a hash of the sources, the
headers they include and the flags, so an edited source rebuilds and an
unchanged one loads the library already built. Nothing here runs at import.

Two programs for a process without Python are built the same way, with
``g++`` against the installed torch's headers and libraries (and its
``_GLIBCXX_USE_CXX11_ABI``), each keyed by a hash of its source, the flags
and the torch version: ``torch_ops_library()``, the ``fdgan::`` operators
for libtorch (``native/fdgan_ops.cpp``, linked against the kernel library,
beside it), and ``aoti_runner()``, the package runner
(``native/aoti_runner.cpp``). Python never loads the first: ``ops/library.py``
defines the same operators there.
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
NATIVE = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("dense_layer.cu", "freq_filters.cu", "probes.cu", "channel_stats.cu", "window_attention.cu")
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
    "fdgan_window_attention_bf16": [_P] * 4 + [_I] * 6 + [_P],
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


_cxx = None


def cxx() -> str:
    """A C++ compiler that links OpenMP code, as AOTInductor's packages are
    built (``-fopenmp``): ``$CXX`` where it does, else ``g++`` on the PATH.
    Raises if neither does."""
    global _cxx
    if _cxx is None:
        tried = []
        for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
            if not cand or cand in tried:
                continue
            tried.append(cand)
            with tempfile.TemporaryDirectory() as d:
                probe = subprocess.run([cand, "-fopenmp", "-shared", "-fPIC", "-x", "c++", "-", "-o",
                                        os.path.join(d, "probe.so")], input="int f() { return 0; }\n",
                                       capture_output=True, text=True)
            if probe.returncode == 0:
                _cxx = cand
                break
        else:
            raise RuntimeError(f"no C++ compiler that links -fopenmp (tried {tried or 'none'})")
    return _cxx


def _torch_build():
    """(g++, include flags, torch's lib directory, the ABI flag, torch's
    version) for a program built against the installed torch."""
    import torch
    from torch.utils import cpp_extension

    gxx = cxx()
    includes = [f"-I{p}" for p in cpp_extension.include_paths()]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    return gxx, includes, Path(torch.__file__).resolve().parent / "lib", abi, torch.__version__


def _build_native(out: Path, cmd, source: Path) -> Path:
    """Run ``cmd`` (with ``{out}`` for the output path) into a temporary
    file beside ``out`` and rename it into place; returns ``out``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=out.parent)
    os.close(fd)
    try:
        res = subprocess.run([tmp if a == "{out}" else a for a in cmd], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"building {source.name} failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _native_digest(source: Path, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return h.hexdigest()[:16]


def torch_ops_library() -> Path:
    """Path of ``libfdgan_torch_ops.so``, built first where missing: the
    ``fdgan::`` operators of ``native/fdgan_ops.cpp`` for a libtorch process
    (``aoti_runner --ops``), linked against the kernel library (built first
    too) in whose directory it lands. Needs the CUDA headers (``CUDA_HOME``,
    else /usr/local/cuda)."""
    load()
    kdir = kernel_dir() / _digest()
    gxx, includes, tlib, abi, version = _torch_build()
    cuda = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    flags = ["-std=c++17", "-O2", "-shared", "-fPIC", abi, *includes, f"-I{cuda}/include", version]
    source = NATIVE / "fdgan_ops.cpp"
    out = kdir / f"torch_ops-{_native_digest(source, flags)}" / "libfdgan_torch_ops.so"
    with _lock:
        if out.exists():
            return out
        return _build_native(out, [gxx, *flags[:-1], str(source), "-o", "{out}", f"-L{kdir}", "-l:libfdgan_kernels.so",
                                   f"-Wl,-rpath,{kdir}", f"-L{tlib}", f"-Wl,-rpath,{tlib}", "-ltorch", "-ltorch_cpu",
                                   "-ltorch_cuda", "-lc10", "-lc10_cuda"], source)


def aoti_runner(out_dir=None) -> Path:
    """Path of the ``aoti_runner`` executable (``native/aoti_runner.cpp``),
    built first where missing, into ``out_dir`` or ``build/kernels/
    aoti_runner-<hash>/``. Linked against libtorch (and libtorch_cuda where
    the installed torch has it: its CUDA package runner registers there)."""
    gxx, includes, tlib, abi, version = _torch_build()
    flags = ["-std=c++17", "-O2", abi, *includes, version]
    source = NATIVE / "aoti_runner.cpp"
    digest = _native_digest(source, flags)
    out = (Path(out_dir) if out_dir else kernel_dir() / f"aoti_runner-{digest}") / "aoti_runner"
    cuda_libs = ["-ltorch_cuda"] if (tlib / "libtorch_cuda.so").exists() else []
    with _lock:
        if out.exists():
            return out
        return _build_native(out, [gxx, *flags[:-1], str(source), "-o", "{out}", f"-L{tlib}", f"-Wl,-rpath,{tlib}",
                                   "-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", *cuda_libs, "-lc10",
                                   "-Wl,--as-needed", "-ldl", "-lpthread"], source)
