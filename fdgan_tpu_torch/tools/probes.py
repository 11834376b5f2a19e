"""The kernel probes on one CUDA GPU: what a hand-written kernel reaches on
this card, stage by stage of the dense layer.

    python -m fdgan_tpu_torch.tools.probes [--only p1,p5] [--size full] [--seed 0] [--trace build/copy_trace.json]

The counterpart of running ``tools/probe_pallas{,2,3,4,5}.py`` on the TPU.
For each probe kernel of ``ops/probes.py`` it builds the inputs from the
seed at the probes' own sizes (2²¹ rows of 128; dense-block-1 tensors at
8×512×512: arrays of 0.5-0.7 GB, far beyond the L2, so every launch finds
them cold), holds the kernel against its plain version, times it with CUDA
events around 20 launches after a warm-up, and prints one JSON line:

- ``ms`` per launch, and ``bound_ms``, the least time the card could take:
  the larger of the bytes the function must move (every input read once,
  every output written once) over 3.35 TB/s and its operations over the
  peak for their type (989 TFLOP/s for bf16 on the tensor cores, 67 TFLOP/s
  outside them), with the side that binds in ``bound_by`` and
  ``share`` = bound_ms / ms;
- ``tflops`` and ``gbs``, the operations and bytes above over ``ms``;
- ``library_ms``: one PyTorch call that computes the same function
  (``library`` names it), where there is one, else null. Where there is,
  kernel and library are timed in turns (``turns_ms``: kernel, library,
  library, kernel, 4 rounds of 20 launches): ``ms`` and ``library_ms`` are
  medians, ``ms_spread`` and ``library_ms_spread`` [min, max];
  ``plain_ms``: the plain version (fp32 arithmetic, slow by design, 2
  launches);
- ``max_abs_err`` against the plain version, and the tolerance it was held to.

It ends with one line per question the Pallas probes asked, answered for
this card from the numbers above, and a line with the ``wgmma`` self-check
(one tile through the helpers of ``csrc/wgmma_bf16.cuh`` against
``torch.matmul``) and what one ``wgmma`` costs an SM. ``--trace`` first
writes a ``torch.profiler`` trace of one ``torch.mul(a, 2)`` and one launch
of each copy body at (2²¹, 128) bf16 to that path and prints each kernel's
launch shape (grid, block, registers, shared memory, estimated occupancy).
Needs a CUDA device and exits non-zero without one; ``run(device="cpu", size="tiny")`` is the CPU rehearsal the
tests use, which checks the plain versions' plumbing and reports no time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fdgan_tpu_torch.ops import probes

# data-sheet peaks of one H100 SXM at its full power limit
PEAK_BYTES_S = 3.35e12
PEAK_TENSOR_FLOPS = 989e12   # bf16, dense
PEAK_TF32_FLOPS = 495e12     # tf32 in the tensor cores, dense
PEAK_CUDA_CORE_FLOPS = 67e12

SEGMENT_WIDTHS = (64, 32, 32, 32)  # dense block 1 before its fourth layer
SIZES = {  # rows of the (M,128) arrays; (B,H,W) of the image tensors
    "full": {"m": 2**21, "image": (8, 512, 512)},
    "ragged": {"m": 2**21 - 24, "image": (3, 120, 200)},
    "tiny": {"m": 232, "image": (1, 12, 20)},
}
TIMED_LAUNCHES = 20

# One bf16 step: kernel and plain version round fp32 sums of the same exact
# bf16 products once, and sums taken in another order can land on the other
# side of a rounding boundary (2^-7 relative at the bottom of a binade). The
# absolute part covers values near 0, where cancellation leaves the fp32
# order error (~1e-5 here) larger than any relative bound.
PRODUCT_TOL = {"rtol": 2.0**-7, "atol": 1e-4}
# conv1 also rounds t = relu(a·x + b) to bf16 before the product; a fused
# multiply-add on one side can move a t by one step, which moves a sum by up
# to |w|·|t|·2^-8 ≈ 1e-3 whatever its own size.
CONV1_TOL = {"rtol": 2.0**-7, "atol": 2e-3}
# doubling is exact in bf16
COPY_TOL = {"rtol": 0.0, "atol": 0.0}


@dataclass(frozen=True)
class Probe:
    ids: Tuple[str, ...]          # the Pallas probes this kernel answers
    replaces: str                 # file:line of the function that reaches pl.pallas_call
    make: Callable                # (size, rng, device) -> inputs
    kernel: Callable              # (*inputs) -> bf16 tensor, through the wrapper
    plain: Callable
    work: Callable                # (*inputs) -> (operations, bytes)
    tol: Dict[str, float]
    library: Optional[Tuple[str, Callable, Callable]] = None  # (name, prepare(*inputs) -> args, call(*args))
    tensor_cores: bool = True


def _uniform(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """bf16 uniform [0, 1) of ``shape`` from ``rng``: through numpy up to
    4 M values, beyond that on the device from a seed drawn from ``rng``."""
    n = int(np.prod(shape))
    if n <= 2**22:
        return torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(device).bfloat16()
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32).bfloat16()


def _normal(rng: np.random.Generator, shape, scale: float, device, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device).to(dtype)


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes that reading or writing each of ``tensors`` once moves."""
    return sum(t.numel() * t.element_size() for t in tensors)


def make_mm(size, rng, device):
    m = SIZES[size]["m"]
    return _uniform(rng, (m, probes.INTER), device), _normal(rng, (probes.INTER, probes.INTER), probes.INTER**-0.5, device)


def make_copy(size, rng, device):
    return (_uniform(rng, (SIZES[size]["m"], probes.INTER), device),)


def make_conv1(size, rng, device, widths: Sequence[int] = SEGMENT_WIDTHS):
    image = SIZES[size]["image"]
    c = sum(widths)
    segs = [_uniform(rng, image + (w,), device) for w in widths]
    a = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(device)
    b = _normal(rng, (c,), 0.3, device, torch.float32)
    return segs, a, b, _normal(rng, (c, probes.INTER), c**-0.5, device)


def make_conv2(size, rng, device):
    image = SIZES[size]["image"]
    return (_uniform(rng, image + (probes.INTER,), device),
            _normal(rng, (3, 3, probes.INTER, probes.GROWTH), (9 * probes.INTER) ** -0.5, device))


def _mm_work(a, b):
    return 2 * a.shape[0] * probes.INTER * probes.INTER, 2 * nbytes(a) + nbytes(b)


def _copy_work(a):
    return a.numel(), 2 * nbytes(a)


def _conv1_work(segs, a, b, w1):
    npix = segs[0].numel() // segs[0].shape[-1]
    return (2 * npix * w1.shape[0] * probes.INTER,
            nbytes(*segs, a, b, w1) + npix * probes.INTER * segs[0].element_size())


def _conv2_work(g, w2):
    npix = g.numel() // probes.INTER
    return 2 * npix * 9 * probes.INTER * probes.GROWTH, nbytes(g, w2) + npix * probes.GROWTH * g.element_size()


def _conv2_library_args(g, w2):
    # cuDNN's layouts: NCHW-shaped channels_last views of g and of OIHW weights
    return g.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv1_probe(mode: str) -> Probe:
    return Probe(
        ids=("P5a", "P5b"), replaces="tools/probe_pallas5.py:69", make=make_conv1,
        kernel=lambda segs, a, b, w1: probes.conv1_segments(segs, a, b, w1, mode), plain=probes.conv1_reference,
        work=_conv1_work, tol=CONV1_TOL,
    )


def _conv2_probe(mode: str) -> Probe:
    return Probe(
        ids=("P5c",), replaces="tools/probe_pallas5.py:158", make=make_conv2,
        kernel=lambda g, w2: probes.conv2(g, w2, mode), plain=probes.conv2_reference, work=_conv2_work,
        tol=PRODUCT_TOL,
        library=("F.conv2d(channels_last bf16, padding=1)", _conv2_library_args,
                 lambda x, w: F.conv2d(x, w, padding=1)),
    )


PROBES: Dict[str, Probe] = {
    "probe_mm": Probe(
        ids=("P1", "P2", "P3b"), replaces="tools/probe_pallas.py:18", make=make_mm, kernel=probes.probe_mm,
        plain=probes.mm_reference, work=_mm_work, tol=PRODUCT_TOL,
        library=("torch.matmul", lambda a, b: (a, b), torch.matmul),
    ),
    "probe_scale_copy": Probe(
        ids=("P3a",), replaces="tools/probe_pallas3.py:32", make=make_copy, kernel=probes.scale_copy,
        plain=probes.scale_copy_reference, work=_copy_work, tol=COPY_TOL, tensor_cores=False,
        library=("torch.mul(a, 2)", lambda a: (a,), lambda a: torch.mul(a, 2)),
    ),
    "probe_scale_copy_staged": Probe(
        ids=("P4",), replaces="tools/probe_pallas4.py:49", make=make_copy, kernel=probes.scale_copy_staged,
        plain=probes.scale_copy_reference, work=_copy_work, tol=COPY_TOL, tensor_cores=False,
        library=("torch.mul(a, 2)", lambda a: (a,), lambda a: torch.mul(a, 2)),
    ),
    "probe_scale_copy_bulk": Probe(
        ids=("P4",), replaces="tools/probe_pallas4.py:49", make=make_copy, kernel=probes.scale_copy_bulk,
        plain=probes.scale_copy_reference, work=_copy_work, tol=COPY_TOL, tensor_cores=False,
        library=("torch.mul(a, 2)", lambda a: (a,), lambda a: torch.mul(a, 2)),
    ),
    "probe_conv1": _conv1_probe("mma"),
    "probe_conv1_wgmma": _conv1_probe("wgmma"),
    "probe_conv2_taps9": _conv2_probe("taps9"),
    "probe_conv2_packed": _conv2_probe("packed"),
    "probe_conv2_wgmma": _conv2_probe("wgmma"),
}


def bound_ms(operations: float, moved: float, tensor_cores: bool = True, tf32: bool = False) -> Tuple[float, str]:
    """The least time in ms the card could take, and which side binds:
    ``operations`` at the tensor cores' bf16 rate, their tf32 rate
    (``tf32``: a 3×TF32 product counts three), or the CUDA cores' fp32 rate
    (``tensor_cores=False``)."""
    by_bytes = moved / PEAK_BYTES_S
    rate = PEAK_TF32_FLOPS if tf32 else PEAK_TENSOR_FLOPS if tensor_cores else PEAK_CUDA_CORE_FLOPS
    by_ops = operations / rate
    return 1000 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def cuda_ms(fn: Callable, launches: int = TIMED_LAUNCHES, warmup: int = TIMED_LAUNCHES) -> float:
    """ms per launch: CUDA events around ``launches`` calls after a warm-up
    of as many (the first timing after the inputs are made read 5-10 % high
    with 2 to 5 warm-up launches)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


TURN_ROUNDS = 4  # kernel, library, library, kernel, kernel, library, library, kernel


def turns_ms(kernel: Callable, library: Callable, rounds: int = TURN_ROUNDS,
             timer: Callable[[Callable], float] = cuda_ms) -> Dict[str, object]:
    """A kernel and the library call that computes the same function, timed
    in turns: ``rounds`` rounds of one ``timer`` reading each (by default
    CUDA events around 20 launches), the kernel first in even rounds and the
    library first in odd ones, so that neither side always follows the
    other. Returns each side's median and its [min, max] over the rounds."""
    if rounds < 3:
        raise ValueError(f"at least 3 rounds, got {rounds}")
    times: Dict[str, List[float]] = {"kernel": [], "library": []}
    fns = {"kernel": kernel, "library": library}
    for r in range(rounds):
        for side in ("kernel", "library") if r % 2 == 0 else ("library", "kernel"):
            times[side].append(timer(fns[side]))
    k, lib = times["kernel"], times["library"]
    return {"ms": statistics.median(k), "ms_spread": [min(k), max(k)],
            "library_ms": statistics.median(lib), "library_ms_spread": [min(lib), max(lib)]}


# How far one side's median moves between two runs on one card: torch.mul's
# at (2^21, 128) bf16 read 0.3545 and 0.3572 ms on one H100 (0.8 %), though
# each run's own turns lay within 0.1 %.
RUN_DRIFT = 0.01


def turn_verdict(row: dict) -> str:
    """How the kernel's turns compare with the library's: 'faster than' when
    its slowest turn beat the library's fastest and its median lies more
    than RUN_DRIFT below the library's, 'slower than' the other way round,
    else 'tied with': a gap inside the drift between runs is no finding."""
    (k_lo, k_hi), (l_lo, l_hi) = row["ms_spread"], row["library_ms_spread"]
    ratio = row["ms"] / row["library_ms"]
    if k_hi < l_lo and ratio < 1 - RUN_DRIFT:
        return "faster than"
    if k_lo > l_hi and ratio > 1 + RUN_DRIFT:
        return "slower than"
    return "tied with"


def compare(got: torch.Tensor, want: torch.Tensor, tol: Dict[str, float], what: str) -> float:
    """max |got − want|; raises unless every value is within ``tol``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, expected {tuple(want.shape)} {want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    bad = diff > tol["atol"] + tol["rtol"] * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        where = bad.nonzero()[:4].tolist()
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} values beyond {tol}, "
                             f"max_abs_err {err}, first at {where}")
    return err


def _release(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def check(name: str, size: str = "full", device="cuda", seed: int = 0) -> float:
    """The kernel ``name`` against its plain version on seeded inputs of
    ``size``; returns max_abs_err, raises on disagreement."""
    probe = PROBES[name]
    inputs = probe.make(size, np.random.default_rng(seed), device)
    got, want = probe.kernel(*inputs), probe.plain(*inputs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    err = compare(got, want, probe.tol, f"{name} at {size}")
    del inputs, got, want
    _release(device)
    return err


def _timings(name: str, probe: Probe, inputs) -> Dict[str, object]:
    """The timed part of a row; CUDA only."""
    out: Dict[str, object] = {}
    if probe.library is not None:  # in turns with the library call
        label, prepare, call = probe.library
        args = prepare(*inputs)
        out.update(turns_ms(lambda: probe.kernel(*inputs), lambda: call(*args)), library=label)
        del args
    else:
        out["ms"] = cuda_ms(lambda: probe.kernel(*inputs))
    if name == "probe_mm":  # the row-tile sweep; ms above is the default tile's
        out["tile_ms"] = {str(t): cuda_ms(lambda: probes.probe_mm(*inputs, tile_rows=t)) for t in probes.MM_TILES}
    if name.startswith("probe_conv1"):
        # the same kernel from one concatenated array, and the concat's own cost
        segs, a, b, w1 = inputs
        out["cat_ms"] = cuda_ms(lambda: torch.cat(segs, dim=-1))
        x = torch.cat(segs, dim=-1)
        out["mono_ms"] = cuda_ms(lambda: probe.kernel([x], a, b, w1))
        del x
    out["plain_ms"] = cuda_ms(lambda: probe.plain(*inputs), launches=2, warmup=1)
    return out


def run(device="cuda", size: str = "full", only: Optional[Sequence[str]] = None, seed: int = 0,
        on_row: Optional[Callable[[dict], None]] = None) -> List[dict]:
    """One row per probe kernel: checked against its plain version at
    ``size``, and on a CUDA device timed. On the CPU every time is None: a
    CPU run writes nothing under a device metric's name. ``on_row`` sees
    each row as soon as it is made."""
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device")
    names = list(PROBES) if only is None else list(only)
    rows = []
    for name in names:
        probe = PROBES[name]
        inputs = probe.make(size, np.random.default_rng(seed), device)
        got, want = probe.kernel(*inputs), probe.plain(*inputs)
        if on_card:
            torch.cuda.synchronize()
        err = compare(got, want, probe.tol, f"{name} at {size}")
        shape = [list(t.shape) for t in (inputs[0] if isinstance(inputs[0], list) else inputs[:1])]
        del got, want
        _release(device)
        operations, moved = probe.work(*inputs)
        bound, by = bound_ms(operations, moved, probe.tensor_cores)
        row = {"name": name, "probes": ", ".join(probe.ids), "replaces": probe.replaces, "size": size, "shape": shape,
               "dtype": "bfloat16", "device": torch.cuda.get_device_name(0) if on_card else "cpu",
               "operations": operations, "bytes": moved, "bound_ms": bound, "bound_by": by,
               "max_abs_err": err, "tol": probe.tol,
               "ms": None, "ms_spread": None, "share": None, "tflops": None, "gbs": None, "library": None,
               "library_ms": None, "library_ms_spread": None, "plain_ms": None}
        if on_card:
            row.update(_timings(name, probe, inputs))
            row["share"] = bound / row["ms"]
            row["tflops"] = operations / row["ms"] / 1e9
            row["gbs"] = moved / row["ms"] / 1e6
        rows.append(row)
        if on_row is not None:
            on_row(row)
        del inputs
        _release(device)
    return rows


WGMMA_RATE_REPS = 4000  # products of K = 128 (or 64) per block in a rate launch


def wgmma_selfcheck(device="cuda", seed: int = 0) -> float:
    """One 64-row tile through the ``wgmma`` helpers (descriptor, fences,
    m64n32k16, m64n96k16 and m64n128k16) against ``torch.matmul`` in fp32, for each
    (N, K) the kernels use and A starting at row offsets a tap of the 3×3 conv
    produces, in padded and unpadded planes; returns the largest error and
    raises beyond 1e-3 (fp32 sums of ≤ 128 exact bf16 products of N(0, 1)
    values in another order differ by ~1e-5)."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for n, k in ((probes.GROWTH, 128), (3 * probes.GROWTH, 128), (probes.INTER, 64), (probes.INTER, 16)):
        a, b = _normal(rng, (136, k), 1.0, device), _normal(rng, (n, k), 1.0, device)
        for row_off, a_rows in ((0, 137), (1, 137), (19, 137), (38, 137), (72, 137), (8, 136), (23, 136)):
            got = probes.wgmma_selfcheck(a, b, row_off, a_rows)
            err = (got - a[row_off:row_off + 64].float() @ b.float().t()).abs().max().item()
            if not err <= 1e-3:
                raise AssertionError(f"wgmma self-check: N={n} K={k} row_off={row_off} a_rows={a_rows}: max_abs_err {err}")
            worst = max(worst, err)
    return worst


def wgmma_rates(seed: int = 0) -> List[dict]:
    """What one ``wgmma`` costs an SM, both operands in shared memory: the
    self-check's product repeated by 1, 2 and 3 warpgroups per SM on every SM
    (CUDA events around 3 launches). ``ns`` is per instruction per SM; the
    kernels' products cannot go faster than this. CUDA only."""
    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for n, k in ((probes.GROWTH, 128), (3 * probes.GROWTH, 128), (probes.INTER, 64)):
        a, b = _normal(rng, (136, k), 1.0, "cuda"), _normal(rng, (n, k), 1.0, "cuda")
        for per_sm in (1, 2, 3):
            ms = cuda_ms(lambda: probes.wgmma_selfcheck(a, b, 19, reps=WGMMA_RATE_REPS, blocks=sms * per_sm),
                         launches=3, warmup=1)
            count = WGMMA_RATE_REPS * (k // 16) * per_sm
            rows.append({"wgmma": f"m64n{n}k16", "warpgroups_per_sm": per_sm, "ns": 1e6 * ms / count,
                         "tflops": 2 * 64 * n * 16 * count * sms / ms / 1e9})
    return rows


def tf32x3_rates(seed: int = 0) -> List[dict]:
    """What one 3×TF32 k-step of the fp32 dense-layer kernels costs an SM:
    ``ops.dense.tf32x3_selfcheck`` (K = 64, A split in registers, the three
    m64nNk8 tf32 products a k-step takes) repeated by 1, 2 and 3 warpgroups
    per SM on every SM, CUDA events around 3 launches. ``ns`` is per k-step per
    SM; ``tflops`` counts the fp32 products (a third of the tf32 work), the
    rate K1's and K2's products cannot pass. CUDA only."""
    from fdgan_tpu_torch.ops import dense

    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a = torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32, device="cuda")
    rows = []
    for n in (3 * probes.GROWTH, probes.INTER):
        b = torch.tensor(rng.standard_normal((64, n)), dtype=torch.float32, device="cuda")
        for per_sm in (1, 2, 3):
            ms = cuda_ms(lambda: dense.tf32x3_selfcheck(a, b, reps=WGMMA_RATE_REPS, blocks=sms * per_sm),
                         launches=3, warmup=1)
            count = WGMMA_RATE_REPS * (64 // 8) * per_sm
            rows.append({"tf32x3": f"m64n{n}k8 x3", "warpgroups_per_sm": per_sm, "ns": 1e6 * ms / count,
                         "tflops": 2 * 64 * n * 8 * count * sms / ms / 1e9})
    return rows


def _verdict(ms: float, other_ms: float, spread: float = 0.03) -> str:
    """'faster', 'slower' or, within the spread between two timings of one
    kernel in one run (~3 %), 'the same'."""
    if abs(ms / other_ms - 1) <= spread:
        return "the same within the run's spread"
    return "faster" if ms < other_ms else "slower"


def _turns(row: dict, key: str) -> str:
    """'median ms [min-max]' of one side of a row's turns."""
    lo, hi = row[f"{key}_spread"]
    return f"{row[key]:.4f} ms [{lo:.4f}-{hi:.4f}]"


def answers(rows: List[dict]) -> List[dict]:
    """One line per question the Pallas probes asked, answered from the
    timed rows (those whose probes were run)."""
    r = {row["name"]: row for row in rows if row["ms"] is not None}
    out = []

    def say(question: str, answer: str) -> None:
        out.append({"question": question, "answer": answer})

    if "probe_mm" in r:
        mm = r["probe_mm"]
        say("P1 (probe_pallas.py): does a hand-written kernel deliver the matrix unit's throughput on this "
            "chip, against the library's product?",
            f"probe_mm {mm['ms']:.3f} ms = {mm['tflops']:.1f} TFLOP/s, {mm['gbs']:.0f} GB/s, "
            f"{100 * mm['share']:.0f} % of its {mm['bound_by']} bound ({mm['bound_ms']:.3f} ms); "
            f"{mm['library']} {_turns(mm, 'library_ms')}: in turns the kernel is {turn_verdict(mm)} the library "
            f"({mm['ms'] / mm['library_ms']:.3f}x its median). The product is bound by bytes, not by the tensor cores.")
        tiles = mm["tile_ms"]
        best = min(tiles, key=tiles.get)
        say("P2, P3b (probe_pallas2.py, probe_pallas3.py pmm): which row tile, and does the grid's order matter?",
            "row tile -> ms: " + ", ".join(f"{t}: {ms:.3f}" for t, ms in tiles.items()) +
            f"; best {best}. All blocks run at once here, so there is no sequential or parallel grid to choose.")
    if "probe_scale_copy" in r:
        cp = r["probe_scale_copy"]
        say("P3a (probe_pallas3.py pcopy): what does a streaming copy written by hand reach, against the "
            "library's?",
            f"probe_scale_copy {_turns(cp, 'ms')} = {cp['gbs']:.0f} GB/s, {100 * cp['share']:.1f} % of "
            f"3350 GB/s; {cp['library']} {_turns(cp, 'library_ms')} = {cp['bytes'] / cp['library_ms'] / 1e6:.0f} "
            f"GB/s: in turns the kernel is {turn_verdict(cp)} the library ({cp['ms'] / cp['library_ms']:.3f}x "
            "its median).")
        staged = [r[n] for n in ("probe_scale_copy_staged", "probe_scale_copy_bulk") if n in r]
        if staged:
            say("P4 (probe_pallas4.py): can hand-rolled multi-buffered asynchronous copies beat the plain "
                "copy, and the library's?",
                f"against the plain copy's {cp['ms']:.4f} ms: " + "; ".join(
                    f"{st['name']} {_turns(st, 'ms')} = {st['gbs']:.0f} GB/s, {_verdict(st['ms'], cp['ms'])} "
                    f"({st['ms'] / cp['ms']:.3f}x its time); in turns {turn_verdict(st)} {st['library']} "
                    f"({_turns(st, 'library_ms')})" for st in staged) + ".")
    conv1 = [r[n] for n in ("probe_conv1", "probe_conv1_wgmma") if n in r]
    if conv1:
        say("P5 Q1 (probe_pallas5.py seg_conv1, mono_conv1): does reading the concat as separate segment "
            "arrays cost anything?",
            "; ".join(f"{c1['name']}: from {len(c1['shape'])} segments {c1['ms']:.3f} ms, from one concatenated "
                      f"array {c1['mono_ms']:.3f} ms, {_verdict(c1['ms'], c1['mono_ms'])} "
                      f"({c1['ms'] / c1['mono_ms']:.2f}x), {100 * c1['share']:.0f} % of its {c1['bound_by']} bound "
                      f"({c1['bound_ms']:.3f} ms)" for c1 in conv1) +
            f"; torch.cat of the segments alone {conv1[0]['cat_ms']:.3f} ms, which the segment read would remove.")
    if "probe_conv2_taps9" in r and "probe_conv2_packed" in r:
        t9, pk = r["probe_conv2_taps9"], r["probe_conv2_packed"]
        say("P5 Q2 (probe_pallas5.py conv2): does conv2 as one tap-packed N=288 product beat the nine-tap "
            "loop?",
            f"taps9 {t9['ms']:.3f} ms = {t9['tflops']:.1f} TFLOP/s, packed {pk['ms']:.3f} ms = "
            f"{pk['tflops']:.1f} TFLOP/s: {_verdict(pk['ms'], t9['ms'])} ({pk['ms'] / t9['ms']:.2f}x taps9's time); bound "
            f"{t9['bound_ms']:.3f} ms ({t9['bound_by']}); {t9['library']} {t9['library_ms']:.3f} ms.")
        if "probe_conv2_wgmma" in r:
            wg = r["probe_conv2_wgmma"]
            say("Does wgmma close conv2's gap to cuDNN? (the third body: the tensor core reads g and W2 from "
                "shared memory itself, a tap is a row offset of the descriptor, a kernel row's three taps lie side by side)",
                f"wgmma {wg['ms']:.3f} ms = {wg['tflops']:.1f} TFLOP/s, {100 * wg['share']:.0f} % of the bound: "
                f"taps9 ({t9['ms']:.3f} ms) takes {t9['ms'] / wg['ms']:.2f}x its time; in turns it is "
                f"{turn_verdict(wg)} {wg['library']} ({_turns(wg, 'library_ms')}), "
                f"{wg['ms'] / wg['library_ms']:.2f}x the library's median.")
        if "probe_conv1" in r:
            c1 = r["probe_conv1"]
            npix = c1["operations"] // (2 * sum(SEGMENT_WIDTHS) * probes.INTER)
            h_bytes = 2 * npix * probes.INTER * 2  # h written once and read once, in bf16
            say("P5 Q3 (probe_pallas5.py): what does a round trip of h (128 channels) through device memory "
                "between two phases cost?",
                f"conv1 {c1['ms']:.3f} ms + conv2 {min(t9['ms'], pk['ms']):.3f} ms as two kernels; the "
                f"round trip itself moves {h_bytes / 1e9:.2f} GB, {1000 * h_bytes / PEAK_BYTES_S:.3f} ms at "
                "the card's memory rate, of which each kernel's bound already holds its half.")
    return out


def select(only: str) -> Optional[List[str]]:
    """Kernel names for a comma-separated list of Pallas probes (``p1`` ..
    ``p5``, each selecting the kernels that answer it) or kernel names
    (``mm``, ``probe_conv2_packed``); None, meaning all, for an empty list."""
    picked = []
    for word in (w.strip().lower() for w in only.split(",")):
        if not word:
            continue
        hits = [n for n, p in PROBES.items()
                if n == f"probe_{word.removeprefix('probe_')}" or word in (i.lower().rstrip("abc") for i in p.ids)]
        if not hits:
            raise ValueError(f"unknown probe {word!r}")
        picked += [n for n in hits if n not in picked]
    return picked or None


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


TRACE_FIELDS = ("grid", "block", "registers per thread", "shared memory", "est. achieved occupancy %")


def copy_launch_shapes(path: Path, seed: int = 0) -> List[dict]:
    """One torch.mul(a, 2) and one launch of each copy body at (2²¹, 128)
    bf16 under torch.profiler, its chrome trace written to ``path``: per
    kernel event, in launch order, the call that made it, the kernel's name,
    its device µs and TRACE_FIELDS as the trace reports them. CUDA only."""
    from torch.profiler import ProfilerActivity, profile

    a = _uniform(np.random.default_rng(seed), (SIZES["full"]["m"], probes.INTER), "cuda")
    calls = [("torch.mul(a, 2)", lambda: torch.mul(a, 2)), ("probe_scale_copy", lambda: probes.scale_copy(a)),
             ("probe_scale_copy_staged", lambda: probes.scale_copy_staged(a)),
             ("probe_scale_copy_bulk", lambda: probes.scale_copy_bulk(a))]
    for _, call in calls:  # built, opted in and warm before the trace
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _, call in calls:
            call()
        torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    kernels = sorted((e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    if len(kernels) != len(calls):
        raise RuntimeError(f"expected {len(calls)} kernel events in the trace, found {len(kernels)}")
    return [{"call": label, "kernel": e["name"], "us": e.get("dur"),
             **{k: e.get("args", {}).get(k) for k in TRACE_FIELDS}} for (label, _), e in zip(calls, kernels)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="", help="comma-separated Pallas probes (p1 .. p5) or kernels (" +
                        ", ".join(n.removeprefix("probe_") for n in PROBES) + "); default all")
    parser.add_argument("--size", default="full", choices=sorted(SIZES))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", default="", help="first trace torch.mul(a, 2) and the copy bodies, "
                        "writing the chrome trace to this path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probes: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        only = select(args.only)
    except ValueError as e:
        parser.error(str(e))
    card = card_line()
    print(card, flush=True)
    if args.trace:
        for shape in copy_launch_shapes(Path(args.trace), args.seed):
            print(json.dumps({"launch_shape": shape, "card": card}), flush=True)
    rows = run("cuda", args.size, only, args.seed, on_row=lambda row: print(json.dumps({**row, "card": card}), flush=True))
    for line in answers(rows):
        print(json.dumps(line), flush=True)
    print(json.dumps({"wgmma_selfcheck_max_abs_err": wgmma_selfcheck(), "wgmma_rates": wgmma_rates()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
