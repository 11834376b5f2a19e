"""Time K1, K2, K3 and the generator's forward of one checkout of the port, on one CUDA GPU.

    python fdgan_tpu_torch/tools/compare_trees.py [--root DIR] [--label NAME]

Imports ``fdgan_tpu_torch`` from ``--root`` (default: the checkout that
holds this file), so that one call on the card can time two trees in turns,
for example an earlier commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists and the working tree:

    python fdgan_tpu_torch/tools/compare_trees.py --root old --label parent
    python fdgan_tpu_torch/tools/compare_trees.py --label change

Each tree builds its own kernels into its own ``build/``. Prints the card's
name and power limit, then one JSON line per measurement, each with the
label:

- ``k3``: ``frequency_fuse`` (K3) at 4×256×256×3 and 8×512×512×3 in bf16:
  ``device_ms``, the ms per launch of 40 launches queued behind ~20 ms of
  products (the device alone, no wait for the host), ``bound_ms`` (24 bytes a
  pixel in bf16 at 3.35 TB/s) and ``share`` = bound / device;
- ``k1`` / ``k2``: the fp32 dense-layer kernels (``fused_dense_layer``,
  ``h_batch_stats``) at the demo's batch-1 layer shapes at 1024²
  (``DENSE_SHAPES``), inputs from seed 0, TF32 off: ``device_ms`` as for K3
  (20 launches), ``max_abs_err`` against the tree's plain twin in full fp32
  (K2: the larger of the mean's and the variance's), and the 3×TF32 bound
  (``bound_ms``, three tf32 products per fp32 product at 495 TFLOP/s, or the
  bytes at 3.35 TB/s, whichever is larger) with ``share`` = bound / device;
- ``k1_bf16``: the bf16 K1 at 8×512×512×64 (serving's first dense
  layer), inputs from seed 0: ``device_ms`` as for K3 (20 launches) and
  ``max_abs_err`` against the tree's twin;
- ``generator``: the full-width generator (seed-0 weights, bf16, 8×512²,
  batch BN, ``inference_mode``): ms per forward (CUDA events over 5 forwards
  after 2) and ``peak_gib`` (``max_memory_allocated`` over one forward, less
  what was allocated before it), through ``FDGAN.forward`` and, where the
  tree has it, ``models.fdgan_fast.apply``; and ``serving``, the same for
  ``fdgan_fast.apply`` in running BN, the engine's default;
- ``demo_fp32``: the demo's forward, fp32 (TF32 off), batch BN, batch 1 at
  1024² (seed-0 weights; ``fdgan_fast.apply`` where the tree has it): ms per
  forward as above;
- ``train_bf16``: the train step at 4×256² bf16 without the perceptual term
  (seed-0 state), bare (``make_train_step`` on batches already on the card)
  and through the training CLI's loop (``cli.train.train`` over an in-memory
  loader of numpy pairs, ``--poolSize 0``, 10 steps logged every 5; its
  second window), in turns, bare, loop, loop, bare: ms per step of each turn
  (host clock, the card synchronised) and the loop's over the bare step's.
  The CLI writes under ``build/compare_trees`` of this checkout, and the
  directory is removed.

``--only`` keeps the lines it names (comma-separated: k3, k1, k2, k1_bf16,
generator, demo_fp32, train_bf16; ``generator`` includes ``serving``).
The dense kernels' ``device_ms`` is the median of DEVICE_SAMPLES samples,
every one under ``device_ms_samples``: a card's times drift by several %
within a process as it warms.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

K3_SHAPES = [(4, 256, 256, 3), (8, 512, 512, 3)]
# the demo's dense layers at 1024², batch 1: block 1's first, block 2's first, block 3's first and last
DENSE_SHAPES = [(1, 1024, 1024, 64), (1, 512, 512, 128), (1, 256, 256, 256), (1, 256, 256, 992)]
K1_BF16_SHAPE = (8, 512, 512, 64)  # the bf16 K1 at serving's first dense layer
LINES = ("k3", "k1", "k2", "k1_bf16", "generator", "demo_fp32", "train_bf16")
DEVICE_SAMPLES = 5


def _dense_inputs(shape):
    """A dense layer's fp32 inputs from seed 0: x, a1, b1, w1, a2, b2, w2 on the card."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    arrays = [rng.uniform(size=shape), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c),
              rng.standard_normal((c, 128)) / np.sqrt(c), rng.uniform(0.5, 1.5, 128), rng.normal(0, 0.3, 128),
              rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)]
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays]


def _device_ms(timing, fn) -> dict:
    """``device_ms`` of fn, the median of DEVICE_SAMPLES samples, and the samples."""
    samples = [timing.device_ms(fn) for _ in range(DEVICE_SAMPLES)]
    return {"device_ms": statistics.median(samples), "device_ms_samples": samples}


def _k1_bf16_row(label, dense, timing) -> dict:
    """The ``k1_bf16`` line: K1 at K1_BF16_SHAPE from seed-0 inputs, on the device alone."""
    args = [a.bfloat16() if a.dim() in (2, 4) else a for a in _dense_inputs(K1_BF16_SHAPE)]  # x, w1, w2 in bf16
    with torch.inference_mode():
        err = (dense.fused_dense_layer(*args).float() - dense.layer_reference(*args).float()).abs().max().item()
        ms = _device_ms(timing, lambda: dense.fused_dense_layer(*args))
    return {"label": label, "k1_bf16": list(K1_BF16_SHAPE), "dtype": "bfloat16", "max_abs_err": err} | ms


def _dense_rows(label, dense, timing, only):
    """One JSON line per fp32 kernel and shape: device ms, error against the twin, 3×TF32 bound."""
    for shape in DENSE_SHAPES:
        args = _dense_inputs(shape)
        npix, c = shape[0] * shape[1] * shape[2], shape[-1]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), torch.inference_mode():
            f_k, f_p = dense.fused_dense_layer(*args), dense.layer_reference(*args)
            s_k, s_p = dense.h_batch_stats(*args[:4]), dense.h_stats_reference(*args[:4])
            cases = {
                "k1": (lambda: dense.fused_dense_layer(*args), (f_k - f_p).abs().max().item(),
                       2 * npix * (c * 128 + 9 * 128 * 32), 4 * npix * (c + 32)),
                "k2": (lambda: dense.h_batch_stats(*args[:4]),
                       max((a - b).abs().max().item() for a, b in zip(s_k, s_p)), 2 * npix * c * 128, 4 * npix * c),
            }
            for name, (fn, err, flop, moved) in cases.items():
                if name not in only:
                    continue
                ms = _device_ms(timing, fn)
                bound = 1e3 * max(3 * flop / 495e12, moved / 3.35e12)
                print(json.dumps({"label": label, name: list(shape), "dtype": "float32", "max_abs_err": err,
                                  "bound_ms": bound, "share": bound / ms["device_ms"]} | ms), flush=True)
        del args, f_k, f_p
        torch.cuda.empty_cache()


TRAIN_LOOP = (4, 256, 10)  # batch, size, steps a turn


def _train_row(label) -> dict:
    """The ``train_bf16`` line (the module's docstring)."""
    import contextlib
    import io
    import shutil
    import time

    from fdgan_tpu_torch.cli import train as cli
    from fdgan_tpu_torch.data.h5 import DataLoader
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

    b, size, steps = TRAIN_LOOP
    rng = np.random.default_rng(2)
    gts = [rng.uniform(size=(size, size, 3)).astype(np.float32) for _ in range(b * steps)]
    pairs = [(np.clip(0.6 * g + 0.3, 0, 1).astype(np.float32), g) for g in gts]
    batches = [[torch.from_numpy(np.stack(side)).cuda() for side in zip(*pairs[i * b:(i + 1) * b])]
               for i in range(steps)]
    state, tx_g, tx_d = create_train_state(0, device="cuda")
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), compute_dtype=torch.bfloat16)
    step(state, *batches[0])  # warm-up
    root = Path(__file__).resolve().parents[2] / "build" / "compare_trees"

    def bare() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for haze, gt in batches:
            step(state, haze, gt)
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t) / steps

    def loop() -> float:
        shutil.rmtree(root, ignore_errors=True)
        opt = cli.build_parser().parse_args([
            "--exp", str(root), "--precision", "bf16", "--lambdaPerceptual", "0", "--poolSize", "0", "--epochs",
            "1", "--logEvery", str(steps // 2), "--batchSize", str(b), "--imageSize", str(size)])
        with contextlib.redirect_stdout(io.StringIO()):
            cli.train(opt, DataLoader(pairs, batch_size=b, shuffle=True, seed=0), None, "cuda")
        with open(root / "train_log.jsonl") as f:
            img_s = [r["imgs_per_sec"] for r in map(json.loads, f) if "imgs_per_sec" in r]
        shutil.rmtree(root, ignore_errors=True)
        return 1000 * b / img_s[-1]

    turns = {"bare": [], "loop": []}
    for name in ("bare", "loop", "loop", "bare"):
        turns[name].append(bare() if name == "bare" else loop())
    return {"label": label, "train_bf16": [b, size, size, 3], "bare_ms": turns["bare"], "loop_ms": turns["loop"],
            "loop_over_bare": sum(turns["loop"]) / sum(turns["bare"])}


def _timing():
    """This checkout's ``tools/timing.py``, loaded by path: it imports only
    torch, and importing it as part of the package would bind
    ``fdgan_tpu_torch`` to this checkout instead of ``--root``'s."""
    spec = importlib.util.spec_from_file_location("fdgan_timing", Path(__file__).with_name("timing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--only", default=",".join(LINES), help="the lines to print, comma-separated")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if only - set(LINES):
        raise SystemExit(f"--only takes {', '.join(LINES)}; got {args.only}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees needs a CUDA device")
    timing = _timing()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from fdgan_tpu_torch.models.fdgan import FDGAN
    from fdgan_tpu_torch.ops import dense, freq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    src = Path(freq.__file__).resolve().parents[2]
    for shape in K3_SHAPES if "k3" in only else ():
        x = torch.tensor(np.random.default_rng(3).uniform(size=shape), dtype=torch.bfloat16, device="cuda")
        ms = timing.device_ms(lambda: freq.frequency_fuse(x), launches=40)
        bound = x.numel() * 4 * x.element_size() / 3.35e12 * 1e3  # 3 values read, 9 written a pixel
        print(json.dumps({"label": args.label, "root": str(src), "k3": list(shape), "dtype": "bfloat16",
                          "device_ms": ms, "bound_ms": bound, "share": bound / ms}), flush=True)
        del x
    _dense_rows(args.label, dense, timing, only)
    if "k1_bf16" in only:
        print(json.dumps(_k1_bf16_row(args.label, dense, timing) | {"root": str(src)}), flush=True)
    try:
        from fdgan_tpu_torch.models import fdgan_fast
    except ImportError:  # a tree from before the fast forward
        fdgan_fast = None
    if "generator" in only:
        _generator_rows(args.label, FDGAN, fdgan_fast, timing)
    if "demo_fp32" in only:
        _demo_row(args.label, FDGAN, fdgan_fast, timing)
    if "train_bf16" in only:
        print(json.dumps(_train_row(args.label)), flush=True)
    return 0


def _generator_rows(label, FDGAN, fdgan_fast, timing) -> None:
    """The ``generator`` and ``serving`` lines (the module's docstring)."""
    model = FDGAN(device="cuda", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(8, 512, 512, 3)).astype(np.float32)).cuda().bfloat16()
    forwards = {("module", "batch"): lambda: model(x, bn_mode="batch")}
    if fdgan_fast is not None:
        forwards["fast", "batch"] = lambda: fdgan_fast.apply(model, x, bn_mode="batch")
        forwards["fast", "running"] = lambda: fdgan_fast.apply(model, x, bn_mode="running")
    with torch.inference_mode():
        for (name, mode), fn in forwards.items():
            ms = timing.events_ms(fn)
            key = "serving" if mode == "running" else "generator"
            print(json.dumps({"label": label, key: name, "shape": [8, 512, 512, 3], "bn_mode": mode,
                              "dtype": "bfloat16", "ms": ms, "img_s": 8000.0 / ms, "peak_gib": timing.peak_gib(fn)}),
                  flush=True)
    del model, x, forwards
    torch.cuda.empty_cache()


def _demo_row(label, FDGAN, fdgan_fast, timing) -> None:
    """The ``demo_fp32`` line (the module's docstring)."""
    model = FDGAN(device="cuda", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, 1024, 1024, 3)).astype(np.float32)).cuda()
    forward = (lambda: fdgan_fast.apply(model, x, bn_mode="batch")) if fdgan_fast else (lambda: model(x, bn_mode="batch"))
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ms = timing.events_ms(forward)
    print(json.dumps({"label": label, "demo_fp32": [1, 1024, 1024, 3], "bn_mode": "batch", "dtype": "float32",
                      "ms": ms}), flush=True)
    del model, x
    torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
