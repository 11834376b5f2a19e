"""Where bf16 K2's time goes inside the kernel, on one CUDA GPU: clock64
stamps per phase of ``tw1_stream`` (``csrc/wgmma_bf16.cuh``).

    python -m fdgan_tpu_torch.tools.stamp_k2 [--shapes 8,512,512,64 8,128,128,992] [--launches 10]

Builds the kernel library with ``-DFDGAN_TW1_STAMPS`` into a directory of
its own (the library the model uses carries no stamps), runs K2
(``ops.dense.h_batch_stats``) ``--launches`` times per shape on seeded bf16
inputs and prints the card's name, power limit and SM clock, then one JSON
line per shape:

- ``cycles_per_step``: each phase's cycles per 64-channel step (summed over
  the warps, over their steps): ``w1_ring`` (waiting for a chunk of W1 past
  the resident ones, and the block barrier of those steps), ``issue`` (the
  products' start), ``x_wait`` (the step's copies of x landing), ``t``
  (t computed into the A fragments, under the products), ``copies`` (the
  next copies' issue), ``products_wait`` and ``epilogue`` (K2's running
  sums, and their reduction every 16 tiles);
- ``kernel_cycles_per_warp``: from a warp's start to its end, per launch,
  and ``steps_per_warp``;
- ``ms``: the stamped K2's time per call by CUDA events (the stamps read
  the clock a few times a step).

Needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import List, Sequence, Tuple

import torch

PHASES = ("w1_ring", "issue", "x_wait", "t", "copies", "products_wait", "epilogue")
STAMP_FLAG = "-DFDGAN_TW1_STAMPS"


def _inputs(shape: Sequence[int], seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.rand(tuple(shape), generator=gen, device="cuda").bfloat16()
    a1 = torch.rand(c, generator=gen, device="cuda") + 0.5
    b1 = 0.3 * torch.randn(c, generator=gen, device="cuda")
    w1 = (torch.randn(c, 128, generator=gen, device="cuda") * c ** -0.5).bfloat16()
    return x, a1, b1, w1


def stamps(shapes: Sequence[Tuple[int, ...]], launches: int = 10, seed: int = 0) -> List[dict]:
    """One row per shape, as the module's docstring says. Builds and loads
    the stamped library: call it in a process that has not loaded the
    kernels yet."""
    from fdgan_tpu_torch.ops import build, dense
    from fdgan_tpu_torch.tools.probes import cuda_ms

    if STAMP_FLAG not in build.NVCC_FLAGS:
        if build._lib is not None:
            raise RuntimeError("the kernel library is already loaded without stamps: run this in a new process")
        build.NVCC_FLAGS = build.NVCC_FLAGS + (STAMP_FLAG,)
    lib = build.load()
    buf = (ctypes.c_ulonglong * 16)()
    rows = []
    for shape in shapes:
        x, a1, b1, w1 = _inputs(shape, seed)
        dense.h_batch_stats(x, a1, b1, w1)  # warm-up
        torch.cuda.synchronize()
        build.check(lib, lib.fdgan_tw1_stamps(buf, 1), "fdgan_tw1_stamps")
        for _ in range(launches):
            dense.h_batch_stats(x, a1, b1, w1)
        torch.cuda.synchronize()
        build.check(lib, lib.fdgan_tw1_stamps(buf, 1), "fdgan_tw1_stamps")
        v = list(buf)
        steps, warps = v[7], v[9]
        rows.append({"shape": list(shape), "launches": launches,
                     "cycles_per_step": {p: v[i] / steps for i, p in enumerate(PHASES)},
                     "kernel_cycles_per_warp": v[8] / warps, "steps_per_warp": steps / warps,
                     "ms": cuda_ms(lambda: dense.h_batch_stats(x, a1, b1, w1))})
        del x
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", nargs="+", default=["8,512,512,64", "8,256,256,128", "8,128,128,992"],
                        help="B,H,W,C of x (bf16)")
    parser.add_argument("--launches", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stamp_k2: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shapes]
    rows = stamps(shapes, args.launches, args.seed)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
