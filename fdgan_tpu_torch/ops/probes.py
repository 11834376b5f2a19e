"""The kernel probes: stages of the dense layer and streaming copies, each
as a hand-written CUDA kernel with its plain PyTorch version beside it.

Counterpart of ``tools/probe_pallas{,2,3,4,5}.py``, the Pallas measurements
that decided the dense layer's design on the TPU. On a CUDA tensor each
wrapper launches its kernel of ``csrc/probes.cu`` or raises; on a CPU
tensor it runs the plain version. They are measurements, not layers of the
model: none is differentiable (the Pallas probes have no VJP). All take
and return bf16.

======================= ===================================================
``probe_mm``            Y = A·B, (M,128)·(128,128), fp32 sums, one rounding
                        (``probe_pallas.py:18``, ``probe_pallas2.py:14``,
                        ``probe_pallas3.py:52``); row tile 64, 128 or 256
``scale_copy``          Y = 2·A, 16-byte loads and stores with streaming
                        cache hints, one block per 4 KB
                        (``probe_pallas3.py:32``)
``scale_copy_staged``   the same through three 4 KB stages in shared
                        memory that the threads fill with ``cp.async``
                        (``probe_pallas4.py:49``)
``scale_copy_bulk``     the same through four 4 KB stages that bulk
                        copies (the Tensor Memory Accelerator, 1-D) fill
                        and empty, with ``mbarrier`` objects between the
                        copies and the threads: a second answer to the
                        same probe
``conv1_segments``      relu(cat(segments)·a + b) rounded, ·W1, from 1 to 8
                        segment arrays without forming the concat
                        (``probe_pallas5.py:69,99``), on ``mma.sync``
                        (``mma``) or, K2's body, on ``wgmma`` (``wgmma``)
``conv2``               3×3 conv 128 → 32, zero padding, as nine 32-wide
                        products (``taps9``) or one tap-packed product
                        (``packed``) (``probe_pallas5.py:158``), both on
                        ``mma.sync``; or, a kernel row's three taps side by
                        side, on Hopper's warpgroup products (``wgmma``),
                        K1's second stage
======================= ===================================================

``wgmma_selfcheck`` multiplies one 64-row tile through the descriptor
helper and ``wgmma`` wrappers of ``csrc/wgmma_bf16.cuh``: a check of the
shared-memory layout the ``wgmma`` kernels rely on, not a probe.

``launches`` counts each kernel's launches in this process; the plain
versions do not move it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from fdgan_tpu_torch.ops.dense import w1_tw1_planes

INTER = 128   # K1's intermediate width: K and N of probe_mm, conv1's N, conv2's K
GROWTH = 32   # conv2's output channels
MM_TILES = (64, 128, 256)
MAX_SEGMENTS = 8
CONV1_MODES = ("mma", "wgmma")  # the C entry's body 0, 1
CONV2_MODES = ("taps9", "packed", "wgmma")  # the C entry's body 0, 1, 2

launches: Dict[str, int] = {
    "probe_mm": 0,
    "probe_scale_copy": 0,
    "probe_scale_copy_staged": 0,
    "probe_scale_copy_bulk": 0,
    "probe_conv1": 0,
    "probe_conv1_wgmma": 0,
    "probe_conv2_taps9": 0,
    "probe_conv2_packed": 0,
    "probe_conv2_wgmma": 0,
}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions: fp32 arithmetic on the bf16 values, rounded where the
# kernels round
# ---------------------------------------------------------------------------

def mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def scale_copy_reference(a: torch.Tensor) -> torch.Tensor:
    return (a.float() * 2.0).to(a.dtype)


def conv1_reference(segments: Sequence[torch.Tensor], a, b, w1) -> torch.Tensor:
    """t = relu(x·a + b) in fp32 over the concat x, rounded to x's dtype,
    times W1 with fp32 sums, rounded once."""
    x = torch.cat(list(segments), dim=-1)
    t = torch.relu(x.float() * a.float() + b.float()).to(x.dtype)
    return (t.float() @ w1.to(x.dtype).float()).to(x.dtype)


def conv2_reference(g: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """NHWC g (B,H,W,128), HWIO w2 (3,3,128,32) → (B,H,W,32): an fp32 conv
    of the bf16 values (they multiply exactly), rounded once."""
    f = F.conv2d(g.permute(0, 3, 1, 2).float(), w2.to(g.dtype).permute(3, 2, 0, 1).float(), padding=1)
    return f.to(g.dtype).permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Checks shared by the wrappers; they run for CPU tensors too, so that what
# the kernels refuse is refused everywhere
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape_tail=None) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
    if shape_tail is not None and tuple(t.shape[-len(shape_tail):]) != tuple(shape_tail):
        raise ValueError(f"{name} must end in {tuple(shape_tail)}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (a slice of a larger tensor may not be)")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")


def _same_device(x: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on cpu or cuda, got {x.device}")


def _launch(name: str, entry: str, x: torch.Tensor, *args) -> None:
    """Call the C entry point on x's device and current stream; raise on a
    CUDA error; count the launch."""
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, entry)
    launches[name] += 1


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def probe_mm(a: torch.Tensor, b: torch.Tensor, tile_rows: int = 128) -> torch.Tensor:
    """Y = A·B for A (M,128), B (128,128), bf16, through ``probe_mm_kernel``
    with ``tile_rows`` rows of A per block step."""
    _check(a, "a", (INTER,))
    _check(b, "b", (INTER, INTER))
    if a.dim() != 2:
        raise ValueError(f"a must be (M, {INTER}), got shape {tuple(a.shape)}")
    if tile_rows not in MM_TILES:
        raise ValueError(f"tile_rows must be one of {MM_TILES}, got {tile_rows}")
    _same_device(a, b)
    if a.device.type == "cpu":
        return mm_reference(a, b)
    m = a.shape[0]
    if m >= 2**31 - 256:
        raise ValueError("a has too many rows for the kernel's 32-bit tile index")
    bt = b.t().contiguous()  # the B fragment reads pairs of k: B is staged as [n][k]
    y = torch.empty((m, INTER), device=a.device, dtype=a.dtype)
    _launch("probe_mm", "fdgan_probe_mm", a, a.data_ptr(), bt.data_ptr(), y.data_ptr(), m, tile_rows)
    return y


_COPY_MODES = ("probe_scale_copy", "probe_scale_copy_staged", "probe_scale_copy_bulk")  # the C entry's mode 0, 1, 2


def _scale_copy(a: torch.Tensor, mode: int) -> torch.Tensor:
    _check(a, "a")
    _same_device(a)
    if a.device.type == "cpu":
        return scale_copy_reference(a)
    y = torch.empty_like(a)
    _launch(_COPY_MODES[mode], "fdgan_probe_scale_copy", a, a.data_ptr(), y.data_ptr(), a.numel(), mode)
    return y


def scale_copy(a: torch.Tensor) -> torch.Tensor:
    """Y = 2·A (bf16, any shape) with plain 16-byte loads and stores, a
    vector a thread and one block per 4 KB, loads that bypass L1 and leave
    L2 first, streaming stores."""
    return _scale_copy(a, 0)


def scale_copy_staged(a: torch.Tensor) -> torch.Tensor:
    """Y = 2·A through shared memory: each block takes 12 KB through
    three 4 KB stages that the threads fill with their own asynchronous
    copies (``cp.async``), all three in flight at once, and store from as
    each lands; three blocks an SM."""
    return _scale_copy(a, 1)


def scale_copy_bulk(a: torch.Tensor) -> torch.Tensor:
    """Y = 2·A through four 4 KB stages (16 KB a block) that bulk copies
    (``cp.async.bulk``) fill and empty: one thread loads and stores whole
    stages, and ``mbarrier`` objects tell it and the threads that double
    the stages in place when each may go on; three blocks an SM."""
    return _scale_copy(a, 2)


def conv1_segments(segments: Sequence[torch.Tensor], a, b, w1, mode: str = "mma") -> torch.Tensor:
    """relu(cat(segments, -1)·a + b) rounded to bf16, times W1 (C,128), from
    1 to 8 segment arrays (..., width_i) that share their leading shape; a, b
    (C) are indexed by the channel's place in the concat, which is never
    formed on the card. Returns (..., 128). ``mode`` picks the kernel body:
    ``mma`` (``mma.sync`` fragments, one block per 128 pixels) or ``wgmma``
    (K2's body: persistent warpgroups, W1 resident, ``wgmma`` products)."""
    if mode not in CONV1_MODES:
        raise ValueError(f"mode must be one of {CONV1_MODES}, got {mode!r}")
    segments = list(segments)
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"1 to {MAX_SEGMENTS} segments, got {len(segments)}")
    lead = tuple(segments[0].shape[:-1])
    for i, s in enumerate(segments):
        _check(s, f"segment {i}")
        if tuple(s.shape[:-1]) != lead:
            raise ValueError(f"segment {i} has leading shape {tuple(s.shape[:-1])}, segment 0 {lead}")
        if s.shape[-1] % 8:
            # the kernel reads 16-byte vectors of 8 channels, each from one segment
            raise ValueError(f"segment {i} has {s.shape[-1]} channels: every width must be a multiple of 8")
    c = sum(s.shape[-1] for s in segments)
    if tuple(w1.shape) != (c, INTER):
        raise ValueError(f"w1 must be ({c}, {INTER}), got {tuple(w1.shape)}")
    if a.numel() != c or b.numel() != c:
        raise ValueError(f"a, b must have {c} entries")
    x = segments[0]
    _same_device(x, *segments[1:], a, b, w1)
    if x.device.type == "cpu":
        return conv1_reference(segments, a, b, w1)
    npix = x.numel() // x.shape[-1]
    if npix >= 2**31 - INTER:
        raise ValueError("too many pixels for the kernel's 32-bit pixel index")
    ak, bk = (t.to(torch.float32).contiguous() for t in (a, b))
    w1k = w1.to(x.dtype)
    # the mma.sync body stages W1 as (128, C); the wgmma body reads it as K2 does
    w1k = w1k.t().contiguous() if mode == "mma" else w1_tw1_planes(w1k)
    out = torch.empty(lead + (INTER,), device=x.device, dtype=x.dtype)
    ptrs = (ctypes.c_void_p * MAX_SEGMENTS)(*[s.data_ptr() for s in segments])
    widths = (ctypes.c_int * MAX_SEGMENTS)(*[s.shape[-1] for s in segments])
    name = "probe_conv1" if mode == "mma" else "probe_conv1_wgmma"
    _launch(name, "fdgan_probe_conv1", x, ptrs, widths, len(segments), ak.data_ptr(), bk.data_ptr(),
            w1k.data_ptr(), out.data_ptr(), npix, CONV1_MODES.index(mode))
    return out


def conv2(g: torch.Tensor, w2: torch.Tensor, mode: str = "taps9") -> torch.Tensor:
    """3×3 conv with zero padding of NHWC g (B,H,W,128) by HWIO w2
    (3,3,128,32) → (B,H,W,32). ``mode`` picks the kernel body: ``taps9``
    accumulates nine 32-wide products, ``packed`` takes the taps side by
    side in one wide product and adds its slices at their shifts (both on
    ``mma.sync``), ``wgmma`` takes a kernel row's three taps side by side in
    warpgroup products whose operands the tensor core reads from shared
    memory itself, and adds the three shares of an output at their shifts."""
    if mode not in CONV2_MODES:
        raise ValueError(f"mode must be one of {CONV2_MODES}, got {mode!r}")
    _check(g, "g", (INTER,))
    if g.dim() != 4:
        raise ValueError(f"g must be NHWC (B, H, W, {INTER}), got shape {tuple(g.shape)}")
    if tuple(w2.shape) != (3, 3, INTER, GROWTH):
        raise ValueError(f"w2 must be (3, 3, {INTER}, {GROWTH}), got {tuple(w2.shape)}")
    _same_device(g, w2)
    if g.device.type == "cpu":
        return conv2_reference(g, w2)
    bsz, h, w, _ = g.shape
    if bsz * h * w >= 2**31 - 1:
        raise ValueError("too many pixels for the kernel's 32-bit pixel index")
    # per tap and output channel its 128 inputs, (9, 32, 128): the layout K1
    # reads, and the transpose of the (128, 288) tap-packed matrix
    w2r = w2.to(g.dtype).permute(0, 1, 3, 2).contiguous()
    out = torch.empty((bsz, h, w, GROWTH), device=g.device, dtype=g.dtype)
    _launch(f"probe_conv2_{mode}", "fdgan_probe_conv2", g, g.data_ptr(), w2r.data_ptr(), out.data_ptr(),
            bsz, h, w, CONV2_MODES.index(mode))
    return out


SELFCHECK_MAX_ROWS = 137  # rows of a's buffer in the self-check kernel's shared memory
SELFCHECK_N = (GROWTH, 3 * GROWTH, INTER)  # the wgmma shapes m64nNk16 the kernels use


def wgmma_selfcheck(a: torch.Tensor, b: torch.Tensor, row_off: int = 0, a_rows: int = SELFCHECK_MAX_ROWS,
                    reps: int = 1, blocks: int = 1) -> torch.Tensor:
    """(64, N) fp32 = reps · a[row_off : row_off + 64] · bᵀ for bf16 a (rows, K)
    and b (N, K), N 32, 96 or 128, K a multiple of 16 up to 128: one tile through
    the ``wgmma`` helpers, A starting ``row_off`` rows into a buffer whose
    planes of 8 k values hold ``a_rows`` rows (137, the default, puts a plane
    16 bytes past a multiple of 128 as the kernels do; 136 aligns it), as a
    tap of the 3×3 conv does. ``reps`` and ``blocks`` repeat the product, per
    block and over blocks: a launch to time. The plain version on the CPU."""
    _check(a, "a")
    _check(b, "b")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a (rows, K) and b (N, K), got {tuple(a.shape)} and {tuple(b.shape)}")
    rows, k = a.shape
    n = b.shape[0]
    if n not in SELFCHECK_N or k % 16 or not 16 <= k <= 128:
        raise ValueError(f"N must be one of {SELFCHECK_N} and K a multiple of 16 up to 128, got N={n}, K={k}")
    if not 0 <= row_off <= rows - 64 or not rows <= a_rows <= SELFCHECK_MAX_ROWS:
        raise ValueError(f"64 rows from row_off={row_off} of a's {rows} rows, in planes of a_rows={a_rows} "
                         f"(at most {SELFCHECK_MAX_ROWS}), do not fit")
    if reps < 1 or blocks < 1:
        raise ValueError(f"reps and blocks must be positive, got {reps} and {blocks}")
    _same_device(a, b)
    if a.device.type == "cpu":
        return reps * (a[row_off:row_off + 64].float() @ b.float().t())
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    d = torch.empty((64, n), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        err = lib.fdgan_wgmma_selfcheck(a.data_ptr(), b.data_ptr(), d.data_ptr(), rows, n, k, row_off, a_rows, reps,
                                        blocks, torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "fdgan_wgmma_selfcheck")
    return d
