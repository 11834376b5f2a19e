#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, kernel-probe, demo,
training-CLI, model-zoo, data-parallel, serving-mesh, sharded-training,
export and device-resident training paths once on one CUDA GPU, and check
them.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp-ranks   # only phase 10's ranks: one per card over NCCL, and their step timed
    python3 chip_smoke.py --mesh-ranks # only phase 11's mesh: one rank per card over NCCL, timed against one card
    python3 chip_smoke.py --sp-ranks   # only phase 12's steps: one rank per card over NCCL, 1xN at 2048^2 (and 512^2
                                       # with the contextual term) against one card; with one card, that
                                       # contextual cell's memory as gloo ranks of the card

Run from the root of a checkout. Phases, each of which raises on failure:

1. device and build: the card's name and power limit from nvidia-smi, then
   the kernels of fdgan_tpu_torch/csrc built from source;
2. the fp32 kernels' 3×TF32 helpers on one tile against a float64 product
   (``ops.dense.tf32x3_selfcheck``) and what a 3×TF32 k-step costs an SM
   (``tools.probes.tf32x3_rates``: the ceiling of their products); then
   kernels against their plain twins at the dense-layer shapes of the
   8×512² serving path, of the 4×256² train path and of the demo's batch-1
   forward at 1024² (fp32, whose K1 and K2 take 3×TF32 products, against
   twins without TF32; and bf16), fp32 also at C = 20 from a buffer of
   ld 52, with CUDA-event times, on the device alone too (``k*_device_ms``),
   and both fp32 bounds (3×TF32, the one a kernel is held to, and the CUDA
   cores'); K1 and K2 also from a channel slice of a wider buffer (the
   dense block's concat), K1 into one, held bit for bit against the
   contiguous launch; in bf16 K2 (wgmma) is also held against and timed
   beside its earlier mma.sync body;
2b. channel_stats (csrc/channel_stats.cu) against its twin, and on a second
   launch (the same bits), at the shapes both paths give it: the 45 a
   batch-BN forward reduces (3 block inputs and 42 new 32-channel slices,
   from views of the blocks' concat buffers) at 8×512² (serving) and at
   4×256² (training), D's three BatchNorm inputs from D's own convs on a
   fused 4×256² batch (training), and a ragged shape; its gradient (the
   closed-form VJP) against the exact one and the twin's at the ragged shape
   and at D's widest input; its times;
3. the full-width FDGAN generator (random weights, seed 0) at 8×512², through
   both forwards, ``models.fdgan_fast.apply`` (what the engine and the train
   step run) and ``FDGAN.forward``: the kernel path against the plain path in
   fp32 for both BN modes, the fast forward against the module forward, the
   bf16 PSNR check, the launch counts per bf16 forward, img/s in bf16 for
   both BN modes and both forwards in turns, and the peak memory of the
   batch-BN forward;
4. serving: InferenceEngines (bf16, running and batch BN, the fast forward)
   behind the BatchingFrontend answer ragged uint8 requests from several
   threads.
   The kernels' launch counters are zeroed just before this phase and read
   just after it: every kernel must have run in it. Then the warmup
   (``InferenceEngine.warmup`` of two shapes over the ladder:
   ``stats["compiles"]`` rungs × shapes, no dispatch statistic moved, K1 42
   a rung and shape by the counters), ``auto_warm`` (a new bucket's first
   request, its other rungs run in the background, a top-rung request
   after it counts no compile), and a fresh process's first request at
   512², cold and after ``warmup``, in turns;
5. training: K3 against its plain version at the train path's shape and
   others (fp32 bit for bit, and bf16), with its time on the device alone
   beside its bound, gradients through K1, K2 and K3
   against the plain path, one fp32 train step with the kernels against one
   without, then the path itself: the adversarial train step at 4×256²,
   bf16, no perceptual term, 10 steps with the kernels and 10 plain, in
   turns, with img/s, peak memory and the launches per step (counters
   zeroed just before, read just after: K1 42, K2 42, K3 3 and
   channel_stats 45 for G and 3 for each of D's three forwards), and 3 split
   G/D steps through an ImagePool;
6. probes: the wgmma self-check (one tile through the helpers of
   csrc/wgmma_bf16.cuh against torch.matmul), each of the nine probe kernels
   (csrc/probes.cu) against its plain version at its full shape (2²¹ rows of
   128; 8×512×512 images) and at a ragged one (the three copy bodies bit
   for bit: the plain copy, one block per 4 KB with streaming cache hints;
   the cp.async stages and the bulk stages, TMA loads and stores, each block
   three or four 4 KB chunks through as many stages), every
   row tile of probe_mm, the conv1 bodies and the conv2 bodies against each
   other, what one wgmma costs an SM; then
   the path, fdgan_tpu_torch.tools.probes.run() as
   `python -m fdgan_tpu_torch.tools.probes` runs it, with the probes'
   launch counters zeroed just before and read just after: one timed JSON
   line per probe (a probe with a library call timed in turns with it,
   kernel, library, library, kernel, ...: each side's median and [min, max])
   and one line per question the Pallas probes asked, and each copy body's
   turns beside torch.mul's with the verdict;
7. the demo: the core of ``python -m fdgan_tpu_torch.cli.demo``
   (``cli.demo.dehaze``) through ``data.h5.DataLoader`` over in-memory
   (haze, gt) pairs made from seed 0 (so that neither h5py nor PIL is
   needed), the full-width generator (random weights, seed 0), batch 1: two
   images of 1024², one of 1200×1600 (NTIRE'19 Dense-Haze) and a ragged
   1021×1533 (reflect-padded to 1024×1536 and cropped back). The kernels'
   launch counters are zeroed just before the path's runs (fp32 batch BN,
   the demo's default; bf16 batch BN; the tiled route) and read just after:
   K1 42 and K2 42 per image, channel_stats 45 per bf16 image, K1 42 per
   tile. Then the checks: fp32 kernels against plain within GEN_TOL and
   their 8-bit PNG levels within 1; the bf16 PSNR against the fp32 output;
   the tiled route (--tile 512 --halo 128, running BN, fp32) against its
   plain version and against ``InferenceEngine(tile=512, halo=128)``, and
   its difference from the untiled forward beside the JAX suite's bounds
   (reported, not gated); ``ops.metrics`` PSNR/SSIM on the 8-bit outputs;
   one 1024² image per precision under ``cli._common.maybe_profile``, whose
   trace must name K1's and K2's kernels 42 times each (fp32: the 3×TF32
   kernels; it gives the device's busy time);
   ms per image in turns (kernels, plain, plain, kernels) for fp32 and bf16,
   the tiled route's ms and the 1200×1600 forward's peak memory;
8. the training CLI: the core of ``python -m fdgan_tpu_torch.cli.train``
   (``cli.train.train``) over in-memory pairs (seed 0), the exp directories
   under build/train_cli. (1) The CLI's defaults in bf16: 8×256²,
   --poolSize 50, two epochs of 4 batches, --keepBest on 2 val images of
   256² every 4 steps, then one more epoch into the same exp directory,
   which must print "resumed from ... at step 8" and load a state equal bit
   for bit to the file; the kernels' counters are zeroed just before and
   read just after: K1 42, K2 42, K3 3, channel_stats 54 per train step
   and K1 42, K2 42, channel_stats 0 per val image (the eval is fp32);
   netG_best.pth loads through cli._common.load_generator and the engine
   serves it; the checkpoints' save and load ms and size. (2) The loop
   against the bare step: 10 steps at 4×256² bf16 without the pool, its img/s
   beside phase 5's. (3) The perceptual term through --vggWeights (a VGG16
   .pth from seed 0): ms per step with and without it. (4) The memory levers
   at 2×1024² bf16: remat False, True, "stages" and --accumSteps 2, peak
   memory, ms and launches of one timed step each (REMAT_LAUNCHES); then in
   fp32 at 2×64² each remat mode against no remat;
9. the model zoo behind ``cli/convert`` (build/zoo): each registry family's
   seed-0 weights written as the reference's .pth (DataParallel prefix,
   doubled blockUNet keys), converted to a JAX params .msgpack by
   ``cli.convert.main`` and loaded from it by ``cli._common.load_model``,
   the .msgpack converted back to the same .pth tensors. The kernels'
   counters are read around every run of the path ("zoo"): (1) ``dehaze``,
   DCPDN's full generator, at 512², batch 1 and 4 (its transmission head's
   bias set to 1, so that J = (I − A)/t + A is conditioned); (2)
   ``densenet_dehaze`` at 4×512²; (3) ``dense``, ``dense2``, ``unetg``,
   ``unetg2`` at 512² (``unetg2`` also at 256², where the innermost BN is
   1×1), ``patchd`` at 4×256², ``begand`` at 4×64². Each in batch and
   running BN: fp32 (TF32 off) kernels against plain within GEN_TOL for
   every output (all four of ``dehaze``), bf16 PSNR against fp32 plain no
   more than 1 dB below the plain path's, and the launches of each forward
   exactly K1 and K2 42 (``densenet_dehaze`` 64; K2 0 in running BN) and
   channel_stats as counted from the module tree (bf16 batch BN), each of
   those channel_stats launches held against its twin on its own input
   (down to 1×1 maps and C = 20 padded to 24). ms per bf16 batch-BN forward
   of ``dehaze`` and ``densenet_dehaze`` at 4×512² in turns of 10 forwards,
   and their peak memory; ``densenet_dehaze``'s gradients with remat
   against without (fp32, 2×64²). (4) The contextual term: the bf16 train
   step at 4×256² with a seed-0 VGG16 .pth, without and with the term in
   turns of 20 steps (launches per step as phase 5's), one fp32 2×64²
   step with the term, kernels against plain at phase 5's criteria, and
   ``cli.train.train --lambdaCX 1`` at the CLI's defaults for one epoch of
   2 batches. Then,
   outside the path's count, K1 and K2 at C = 400 and 456 (densenet_dehaze's
   blocks 3 and 4; 16 and 8 modulo 32) against their twins, from contiguous
   x and from the concat buffer's slice (the same bits), with their times;
10. data parallelism, ``FDGAN_TPU_DIST`` (build/dp), the kernels' counters
   read around every run of the path ("dp"): (a) a process group of one rank
   over NCCL, joined through ``dist.mesh.maybe_init_distributed`` with
   explicit coordinates: 10 data-parallel train steps at 4×256² bf16 (no
   perceptual term) in turns with phase 5's bare step, their launches per
   step (K1 42, K2 42, K3 3, channel_stats 54) and their collectives (none),
   and one fp32 2×64² step equal bit for bit to the step without a group
   (under torch's deterministic implementations, which make two steps
   without a group equal too); (c) ``cli.train.train`` in that group for one
   epoch of 2 batches at 8×256² bf16: process 0's log and checkpoint, then
   the state written as a JAX ``TrainState`` (``save_jax_checkpoint``), from
   which the CLI resumes with its loaded state bit for bit the file's; (b)
   two ranks on this one card over gloo (NCCL refuses two ranks on one
   device), processes of ``python -m fdgan_tpu_torch.tools.dp_step`` killed
   after 300 s, each on one row of a 2×64² batch through the kernels, with
   the batch statistics global across the ranks: fp32 and fp32 with remat
   against one process's kernel step on the whole batch at phase 5's
   criteria (and the step's generator output within GEN_TOL), bf16 by the
   PSNR criterion (the step's generator output against the fp32 step's, no
   more than 1 dB below the one-process bf16 step's); each rank's launches
   and collectives exact;
11. the serving mesh (``InferenceEngine(mesh=..., spatial=...)``): K1 with
   halo rows on shards of whole 8-row tiles, the same bits as K1 on the
   whole image and within the twin tolerance; ranks of
   ``python -m fdgan_tpu_torch.tools.mesh_serve`` over gloo on this one
   card, 2 then 4, on 2×256² through 1×2, 2×1 and 2×2 meshes against the
   engine in one process (fp32 running BN at atol 1e-5, fp32 batch BN at
   atol 2e-4 / rtol 1e-3 with the seam gate, bf16 by the PSNR criterion), every halo'd
   K1 launch of a forward against its twin on its own input, each rank's
   launches, halo exchanges and statistics' all-reduces per forward exact;
   ``cli.serve --spatialShards 2`` on 2 ranks against one process;
12. training with H sharded (``make_train_step(mesh=)``): K3 with halo rows
   on bands of 5 shapes (uneven, fp32 and bf16, 1×2048²) the same bits as K3
   on the whole image and within its twin's tolerance, and on the device
   alone with and without its rows; ranks of ``python -m
   fdgan_tpu_torch.tools.sp_step`` over gloo on this one card, 2 then 4, one
   step at 2×256² through the 1×2 and 2×2 meshes against one process's step
   on the whole batch (fp32: the train-step criteria and the gradient
   vectors; bf16: phase 10's gate), every halo'd K3 launch against its twin,
   each rank's launches, halo exchanges, count and statistics all-reduces
   exact. The contextual term with H sharded: one fp32 step at 2×64² with CX
   (a seed-0 VGG16) through the 1×2 and 2×2 meshes against one process at
   the same criteria, each rank's kernels' launches, gathers (1) and max
   reductions (2) exact, the band-local control (each band's term alone)
   failing the losses' criterion, and CX alone on bands of relu3_3-sized
   maps (2×64×64×256): the shares add up to the whole maps' term, the
   gradients stitch to its gradients, and no rank saves more than its
   band's rows of the N×N matrix.
13. the export path (``io.export``, ``native/``; build/export): the
   generator (seed 0) exported by ``export_forward``, saved and loaded back,
   at the engine's default (8×512² bf16 running BN), the demo's (1×1024²
   fp32 batch BN) and 2×256² bf16 batch BN; each loaded program's forward
   with the counters zeroed just before and read just after (K1 42, K2 42 in
   batch BN, channel_stats 45 in bf16 batch BN), every launch held against
   its twin on its own input, the fp32 program against the eager forward
   within GEN_TOL and the bf16 ones by the PSNR criterion; ms per forward at
   8×512² in turns with the eager forward. Then one AOTInductor package,
   ``export_native_bundle`` at 1×512² bf16 running BN with uint8 in and
   out (its export, compile, save and load seconds, MB): in Python
   (``aoti_load_package``: K1 42 by the counters, each held against its
   twin, and the profiler's kernel names reported) and through ``aoti_runner
   --ops`` (``native/``, built here: the same bytes, K1 42 a forward by the
   C++ operators' own counts), within one level of the eager engine's
   uint8, as is the ``ExportedProgram``; the runner without ``--ops`` must
   stop naming it; ms per forward in turns (eager, program, package) and
   per request (the runner against the package in Python); the runner's
   HTTP daemon: /dehaze (the same bytes), /healthz, /stats, and /reload
   with a package of two outputs (refused, the old one serving: ADVICE r5
   fault 2), a .sig mismatch (409) and Content-Length: 0 (re-promoted).
14. device-resident training at phase 5's cell (4×256² bf16, no perceptual
   term; build/device_loop): one chunk of ``make_device_loop`` (10 steps over
   5 staged bf16 batches) under ``torch.cuda.set_sync_debug_mode("error")``,
   the counters zeroed just before and read just after (K1 42, K2 42, K3 3,
   channel_stats 54 a step), against 10 streaming steps on the same batches
   at phase 5's criteria (both under torch's deterministic algorithms); the
   pool loop (``make_device_pool_loop``, pool 50) over 3 chunks under
   "error" too; img/s of a chunk in turns with phase 8's streaming loop;
   ``make_device_eval`` against the host ``cli.train.evaluate`` on 4 fp32
   256² val images (rtol 1e-4); an ``AsyncCheckpointer`` save during a
   chunk, its file the state at ``save()``, the ms the loop loses to it
   against a blocking save; ``cli.train.train --deviceSteps 10`` over
   in-memory loaders (staged, logged, evaluated on the device, its async
   checkpoint the final state).
15. DehazeFormer's window attention (``--window-attention`` runs it alone):
   the kernel against its plain version at DehazeFormer-B's three attending
   stage shapes at 8×460×620, both shifts; its times, the plain version's
   and ``scaled_dot_product_attention``'s. Then DehazeFormer-B through
   ``InferenceEngine`` (bf16, bucket 4, uint8 in and out) as the bulk cell
   and ``cli/serve --inDir`` run it: 8 images of 460×620 by
   ``predict_batch`` with the counter zeroed just before and read just after
   (24 launches), every device kernel of one batch counted in the
   profiler's trace, and the host's enqueue of one forward from an idle
   device.

The line before the last holds the per-kernel summary as JSON (time, bound,
plain version's and library call's time, the probes' spreads in turns,
launches per path, the training CLI's, the zoo's, "dp", "mesh", "sp", "warmup", "sp_cx" (the
contextual term's sharded steps) and "device_loop" included; K3's with
and without halo rows; K1's and K2's
times at C = 400 and 456; the fp32 K1 and K2 as entries of their own, timed
at 1×1024²×64 with their launches from the fp32 demo run); the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

SHAPES = [  # (B, H, W, C): one layer per dense block of the 8×512² serving path, a ragged C, a ragged W
    (8, 512, 512, 64),
    (8, 256, 256, 128),
    (8, 128, 128, 256),
    (8, 128, 128, 992),
    (8, 120, 200, 64),
    # the first layer of each dense block of the 4×256² train path, and block 3's last
    (4, 256, 256, 64),
    (4, 128, 128, 128),
    (4, 64, 64, 256),
    (4, 64, 64, 992),
    # the demo's batch-1 layers at 1024² (cli/demo, fp32 by default): block 1's first at 1024², block 2's at
    # 512², block 3's first and last at 256²
    (1, 1024, 1024, 64),
    (1, 512, 512, 128),
    (1, 256, 256, 256),
    (1, 256, 256, 992),
]
TIMED_SHAPE = SHAPES[0]
DEMO_LAYER = (1, 1024, 1024, 64)  # where the fp32 kernels' line is timed
# fp32 only (bf16 needs C % 8 == 0): C = 20 from a buffer slice of ld 52, which the fp32 kernels read
# with 16-byte loads as it is
F32_RAGGED = ((1, 256, 256, 20), 52)
# fp32 tolerances are the JAX suite's (tests/test_pallas_dense.py:52,67-68)
K1_TOL_F32 = dict(atol=2e-4, rtol=1e-3)
K2_MEAN_TOL = dict(atol=1e-4, rtol=1e-4)
K2_VAR_TOL = dict(atol=1e-4, rtol=1e-3)
# bf16: kernel and twin round t, g and f to bf16 at the same points; fp32 sums
# taken in another order can move a value across a rounding boundary, one
# bf16 step (2^-8 relative). Four steps of relative slack plus an absolute
# floor of 1e-2 for values near zero.
K1_TOL_BF16 = dict(atol=1e-2, rtol=1.6e-2)
GEN_TOL = dict(atol=5e-4, rtol=1e-3)  # tests/test_pallas_dense.py:132
K3_SHAPES = [(4, 256, 256, 3), (8, 512, 512, 3), (1, 24, 40, 3), (2, 120, 200, 3), (1, 130, 135, 3)]  # the path's first
# K3 and its plain version normalise in x's dtype and sum in fp32 in the same
# order without fused multiply-adds: fp32 is held bit for bit; bf16 at one
# bf16 step (2^-8 relative) in case an fp32 sum lands on the other side of a
# rounding boundary.
K3_TOL = {"float32": dict(atol=0, rtol=0), "bfloat16": dict(atol=2.0**-8, rtol=2.0**-8)}
# channel_stats against its twin (the one-pass formula in fp32 on the card):
# tests/test_pallas_dense.py:67-68's statistics tolerances; the kernel's float64
# partials are the more exact of the two
STATS_MEAN_TOL = dict(atol=1e-4, rtol=1e-4)
STATS_VAR_TOL = dict(atol=1e-4, rtol=1e-3)
# the dense blocks of the 8×512² serving path: (H, block input C, layers)
BLOCKS = [(512, 64, 6), (256, 128, 12), (128, 256, 24)]
TRAIN_SHAPE = (4, 256, 256)  # bench.py:65-78: 4 images of 256², bf16, no perceptual term
TRAIN_STEPS = 10
LR = 2e-4
# serving: running BN makes each image independent of its batch-mates, but
# the batch size changes cuDNN's algorithms for the plain convs, so the bf16
# result may move by a few bf16 steps (2^-7 near ±1) after ~60 layers.
SERVE_TOL = dict(atol=5e-2, mean=2e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms, the wrapper's host time
    included (``tools/timing.py::device_ms`` times the device alone)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def exact_fp32():
    """cuDNN and matmul without TF32."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def phase_device():
    import torch

    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from fdgan_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        # C7518 and its like: the compiler serialised wgmma products. C7519 (it added the
        # warpgroup.arrive before products whose accumulators it had just written) is routine.
        if "(C7519)" in line:
            continue
        if "registers" in line or "spill" in line or "error" in line.lower() or "(C75" in line:
            log(f"  ptxas: {line.strip()}")


def layer_inputs(shape, dtype, gen):
    import torch

    b, h, w, c = shape
    dev = "cuda"

    def normal(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    def uniform(*s, lo=0.5, hi=1.5):
        return torch.rand(s, generator=gen, device=dev) * (hi - lo) + lo

    x = normal(b, h, w, c).to(dtype)
    a1, b1 = uniform(c), normal(c, scale=0.3)
    w1 = normal(c, 128, scale=c ** -0.5).to(dtype)
    a2, b2 = uniform(128), normal(128, scale=0.3)
    w2 = normal(3, 3, 128, 32, scale=(9 * 128) ** -0.5).to(dtype)
    return x, a1, b1, w1, a2, b2, w2


def dense_bounds(x, a1, b1, w1, a2, b2, w2):
    """K1's and K2's bounds on these inputs: every input read once, every
    output written once. bf16 products at the tensor cores' bf16 peak. fp32
    products two ways: as the kernels take them, 3×TF32 (three tf32 products
    each) at the tensor cores' tf32 peak, the bound a kernel is held to
    (``k*_bound_ms``), and on the CUDA cores (``k*_cuda_core_bound_ms``)."""
    from fdgan_tpu_torch.tools.probes import bound_ms, nbytes

    npix, c = x.numel() // x.shape[-1], x.shape[-1]
    work = {"k1": (2 * npix * (c * 128 + 9 * 128 * 32),
                   nbytes(x, a1, b1, w1, a2, b2, w2) + npix * 32 * x.element_size()),
            "k2": (2 * npix * c * 128, nbytes(x, a1, b1, w1) + 2 * 128 * 4)}
    out = {}
    for k, (flop, moved) in work.items():
        if x.element_size() == 2:
            out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bound_ms(flop, moved)
        else:
            out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bound_ms(3 * flop, moved, tf32=True)
            out[f"{k}_cuda_core_bound_ms"], out[f"{k}_cuda_core_bound_by"] = bound_ms(flop, moved, tensor_cores=False)
    return out


def buffer_view(x, ld):
    """x copied into the first C channels of a (B, H, W, ld) buffer, as the
    slice a dense layer reads, and the 32 channels after it, as the slice it
    writes."""
    import torch

    c = x.shape[-1]
    buf = torch.zeros(tuple(x.shape[:3]) + (ld,), device=x.device, dtype=x.dtype)
    buf[..., :c] = x
    return buf[..., :c], buf[..., c:c + 32]


def phase_kernels():
    import torch

    from fdgan_tpu_torch.ops import dense
    from fdgan_tpu_torch.tools.probes import tf32x3_rates
    from fdgan_tpu_torch.tools.timing import device_ms

    # the fp32 kernels' 3xTF32 helpers on one tile against a float64 product, and what a
    # 3xTF32 k-step costs an SM: the ceiling of their products
    rng = np.random.default_rng(0)
    for n in (96, 128):
        a = torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32, device="cuda")
        b = torch.tensor(rng.standard_normal((64, n)), dtype=torch.float32, device="cuda")
        err = (dense.tf32x3_selfcheck(a, b).double() - a.double() @ b.double()).abs().max().item()
        if err > 2.0**-18 * (a.double().abs() @ b.double().abs()).max().item():
            raise AssertionError(f"the 3xTF32 self-check at N = {n} is off by {err}")
    ceiling = {}
    for r in tf32x3_rates():
        log(json.dumps(r))
        ceiling[r["tf32x3"]] = max(ceiling.get(r["tf32x3"], 0.0), r["tflops"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {"float32": {"k1": 0.0, "k2": 0.0}, "bfloat16": {"k1": 0.0, "k2": 0.0}}
    # a dense block's concat: ld 256 at the timed shape, as block 1's buffer
    cases = [(dtype, shape, max(256, shape[-1] + 32)) for dtype in (torch.float32, torch.bfloat16) for shape in SHAPES]
    cases.append((torch.float32,) + F32_RAGGED)
    for dtype, shape, ld in cases:
        x, a1, b1, w1, a2, b2, w2 = layer_inputs(shape, dtype, gen)
        bf16 = dtype == torch.bfloat16
        xv, fv = buffer_view(x, ld)
        with exact_fp32():
            f_k = dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2)
            f_p = dense.layer_reference(x, a1, b1, w1, a2, b2, w2)
            m_k, v_k = dense.h_batch_stats(x, a1, b1, w1)
            m_p, v_p = dense.h_stats_reference(x, a1, b1, w1)
            with torch.inference_mode():
                dense.fused_dense_layer(xv, a1, b1, w1, a2, b2, w2, out=fv)
            m_v, v_v = dense.h_batch_stats(xv, a1, b1, w1)
            m_k2, v_k2 = dense.h_batch_stats(x, a1, b1, w1)
        torch.cuda.synchronize()
        tol = K1_TOL_F32 if dtype == torch.float32 else K1_TOL_BF16
        e1 = (f_k.float() - f_p.float()).abs().max().item()
        e2 = max((m_k - m_p).abs().max().item(), (v_k - v_p).abs().max().item())
        ok1 = torch.allclose(f_k.float(), f_p.float(), **tol)
        ok2 = torch.allclose(m_k, m_p, **K2_MEAN_TOL) and torch.allclose(v_k, v_p, **K2_VAR_TOL)
        # the buffer view changes addresses, not arithmetic: the same bits; and K2's static
        # tile walk gives the same bits on every launch
        ok_view = torch.equal(fv, f_k) and torch.equal(m_v, m_k) and torch.equal(v_v, v_k)
        ok_again = torch.equal(m_k2, m_k) and torch.equal(v_k2, v_k)
        ok_mma, e_mma = True, None
        if bf16:
            # the two K2 bodies sum the same fp32 products in other orders
            m_m, v_m = dense._launch_k2_mma(x, a1, b1, w1)
            e_mma = max((m_k - m_m).abs().max().item(), (v_k - v_m).abs().max().item())
            ok_mma = torch.allclose(m_k, m_m, **K2_MEAN_TOL) and torch.allclose(v_k, v_m, **K2_VAR_TOL)
        w = worst[str(dtype).split(".")[-1]]
        w["k1"], w["k2"] = max(w["k1"], e1), max(w["k2"], e2)
        # bf16's twin runs fp32 convs on bf16 values: TF32 holds bf16
        # operands exactly, so it is left on (the serving default) for timing
        with exact_fp32() if dtype == torch.float32 else contextlib.nullcontext():
            t = {
                "k1_ms": cuda_ms(lambda: dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2)),
                "k1_plain_ms": cuda_ms(lambda: dense.layer_reference(x, a1, b1, w1, a2, b2, w2)),
                "k2_ms": cuda_ms(lambda: dense.h_batch_stats(x, a1, b1, w1)),
                "k2_plain_ms": cuda_ms(lambda: dense.h_stats_reference(x, a1, b1, w1)),
            }
            if bf16:  # K2's old body and new in turns, in one run
                t["k2_mma_ms"] = cuda_ms(lambda: dense._launch_k2_mma(x, a1, b1, w1))
                t["k2_ms"] = (t["k2_ms"] + cuda_ms(lambda: dense.h_batch_stats(x, a1, b1, w1))) / 2
                t["k2_mma_ms"] = (t["k2_mma_ms"] + cuda_ms(lambda: dense._launch_k2_mma(x, a1, b1, w1))) / 2
            # on the device alone (the kernel and the wrapper's weight-layout copies and
            # reductions): the wrapper's host time, ~0.1 ms, is inside the single-launch times
            with torch.inference_mode():
                t["k1_device_ms"] = device_ms(lambda: dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2))
                t["k1_view_device_ms"] = device_ms(
                    lambda: dense.fused_dense_layer(xv, a1, b1, w1, a2, b2, w2, out=fv))
                t["k1_device_ms"] = (t["k1_device_ms"] + device_ms(
                    lambda: dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2))) / 2
                t["k1_view_device_ms"] = (t["k1_view_device_ms"] + device_ms(
                    lambda: dense.fused_dense_layer(xv, a1, b1, w1, a2, b2, w2, out=fv))) / 2
            t["k2_device_ms"] = device_ms(lambda: dense.h_batch_stats(x, a1, b1, w1))
            if bf16:
                t["k2_mma_device_ms"] = device_ms(lambda: dense._launch_k2_mma(x, a1, b1, w1))
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "ld": xv.stride(2),
               "k1_max_abs_err": e1, "k2_max_abs_err": e2, "k2_vs_mma_max_abs_err": e_mma, **t,
               **dense_bounds(x, a1, b1, w1, a2, b2, w2)}
        rows.append(row)
        log(json.dumps(row))
        if not (ok1 and ok2 and ok_mma and ok_view and ok_again):
            raise AssertionError(f"kernel disagrees at {shape} {dtype} ld {ld}: K1 vs twin ok={ok1} err={e1}, K2 vs "
                                 f"twin ok={ok2} err={e2}, K2 vs its mma.sync body ok={ok_mma} err={e_mma}, "
                                 f"from a buffer view the same bits ok={ok_view}, K2 twice the same bits "
                                 f"ok={ok_again}")
        del x, xv, fv, f_k, f_p
        torch.cuda.empty_cache()
    return rows, worst, ceiling


def stats_views(b, h, c0, layers, gen):
    """A dense block's concat buffer (b, h, h, c0 + 32·layers) bf16 and the
    views channel_stats reduces in a batch-BN forward: the block input, then
    each layer's 32 new channels."""
    import torch

    ld = c0 + 32 * layers
    buf = (torch.randn((b, h, h, ld), generator=gen, device="cuda") * 1.5 + 0.3).bfloat16()
    return buf, [buf[..., :c0]] + [buf[..., c:c + 32] for c in range(c0, ld, 32)]


def discriminator_bn_inputs():
    """The inputs of D's three BatchNorms in a train step at 4×256² bf16, from
    D's own convs (random weights, seed 0) on a fused batch (K3 of a train
    batch): NCHW channels_last conv outputs 4×128×64×64, 4×256×32×32 and
    4×512×31×31, as NHWC views, the layout batch_stats hands channel_stats."""
    import torch

    from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator
    from fdgan_tpu_torch.nn.layers import BatchNorm
    from fdgan_tpu_torch.ops import freq

    d = NLayerDiscriminator(device="cuda", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    outs = []
    hooks = [d.model[str(int(k) - 1)].register_forward_hook(lambda mod, inp, out: outs.append(out))
             for k, m in d.model.items() if isinstance(m, BatchNorm)]
    b, size, _ = TRAIN_SHAPE
    haze, _ = train_batch(b, size, 100)
    with torch.no_grad():
        d(freq.frequency_fuse(haze.bfloat16()))
    for hk in hooks:
        hk.remove()
    del d
    return [o.permute(0, 2, 3, 1) for o in outs]


def check_stats_grad(x, what):
    """channel_stats' backward (the closed-form VJP) at x against the exact
    VJP in float64 at the same statistics, and against the twin's VJP by
    autograd; tolerances as tests/test_torch_stats.py states them: one bf16
    rounding of the exact value (2^-8) plus fp32's error on b + a·x, and
    against the twin, whose two terms are rounded before they are added,
    2^-8·(|T1| + |T2|) + 2^-7·|dx|. Returns the largest error against the
    exact VJP."""
    import torch

    from fdgan_tpu_torch.ops import stats

    c, n = x.shape[-1], x.numel() // x.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(11)
    cm, cv = torch.randn(c, generator=gen, device="cuda"), torch.randn(c, generator=gen, device="cuda")
    xg, xt = x.detach().clone().requires_grad_(True), x.detach().clone().requires_grad_(True)
    mean, var = stats.channel_stats(xg)
    (mean * cm + var * cv).sum().backward()
    m, v = stats.one_pass_reference(xt)
    (m * cm + v * cv).sum().backward()
    xd, md = x.detach().double(), mean.detach().double()
    exact = cm.double() / n + cv.double() * 2 * (xd - md) / n
    scale = exact.abs().max().item()
    terms = ((cm.double() - 2 * cv.double() * md).abs().max() + (2 * cv.double() * xd).abs().max()).item() / n
    err = (xg.grad.double() - exact).abs().max().item()
    ok = (xg.grad.dtype == x.dtype
          and torch.allclose(xg.grad.double(), exact, rtol=2.0**-8, atol=2.0**-16 * scale)
          and torch.allclose(xg.grad.double(), xt.grad.double(), rtol=2.0**-7, atol=2.0**-8 * terms))
    if not ok:
        raise AssertionError(f"channel_stats' gradient at {what} disagrees: max_abs_err {err} against the exact "
                             f"VJP, {(xg.grad.double() - xt.grad.double()).abs().max().item()} against the twin's")
    return err


def phase_channel_stats():
    """channel_stats against its twin, twice (the same bits), at the views it
    reduces on both paths: the 45 of a batch-BN forward at 8×512² (serving),
    the 45 of one at 4×256² and D's three BatchNorm inputs (training); then a
    ragged shape, the gradient at the ragged shape and at D's widest input,
    and times at one view of each kind of the serving path."""
    import torch

    from fdgan_tpu_torch.ops import stats
    from fdgan_tpu_torch.tools.probes import bound_ms, nbytes
    from fdgan_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst, n_views, timed = 0.0, {"serving": 0, "training": 0, "ragged": 0}, {}

    def check(v, path):
        nonlocal worst
        mean, var = stats.channel_stats(v)
        again = stats.channel_stats(v)
        mr, vr = stats.one_pass_reference(v)
        err = max((mean - mr).abs().max().item(), (var - vr).abs().max().item())
        ok = (torch.allclose(mean, mr, **STATS_MEAN_TOL) and torch.allclose(var, vr, **STATS_VAR_TOL)
              and torch.equal(again[0], mean) and torch.equal(again[1], var))
        if not ok:
            raise AssertionError(f"channel_stats disagrees with its twin at {tuple(v.shape)} ld {v.stride(2)}: "
                                 f"err {err}, same bits twice {torch.equal(again[0], mean)}")
        worst, n_views[path] = max(worst, err), n_views[path] + 1
        return err

    for path, b, scale in (("serving", 8, 1), ("training", TRAIN_SHAPE[0], 2)):
        for h, c0, layers in BLOCKS:
            buf, views = stats_views(b, h // scale, c0, layers, gen)
            for i, v in enumerate(views):
                err = check(v, path)
                if path == "serving" and i <= 1:  # the block input and one 32-channel slice
                    bound, by = bound_ms(3 * v.numel(), nbytes(v) + 2 * v.shape[-1] * 4, tensor_cores=False)
                    row = {"shape": list(v.shape), "ld": v.stride(2), "max_abs_err": err,
                           "ms": cuda_ms(lambda: stats.channel_stats(v)),
                           "device_ms": device_ms(lambda: stats.channel_stats(v)),
                           "plain_ms": cuda_ms(lambda: stats.one_pass_reference(v)),
                           # one PyTorch call on the same view: the fp32 norm reads bf16 x once
                           "library_ms": cuda_ms(lambda: torch.linalg.vector_norm(v, dim=(0, 1, 2),
                                                                                  dtype=torch.float32)),
                           "bound_ms": bound, "bound_by": by}
                    timed[f"{h}_{'input' if i == 0 else 'slice'}"] = row
                    log(json.dumps({"channel_stats": row}))
            del buf, views
            torch.cuda.empty_cache()
    d_inputs = discriminator_bn_inputs()
    for v in d_inputs:
        check(v, "training")
    # a ragged view: 5 channel groups, a pixel count that ends inside a tile
    x = torch.randn((3, 17, 29, 48), generator=gen, device="cuda").bfloat16()[..., 8:48]
    check(x, "ragged")
    grad_err = max(check_stats_grad(x, "a ragged view"), check_stats_grad(d_inputs[-1], "D's 4x31x31x512 input"))
    log(f"channel_stats vs twin: {n_views} views (serving: 8x512^2 forward; training: 4x256^2 forward and D's "
        f"{[tuple(v.shape) for v in d_inputs]}) and a ragged one, max_abs_err {worst:.3e}; gradient against the "
        f"exact VJP max_abs_err {grad_err:.3e}, within the twin's bound")
    if n_views != {"serving": 45, "training": 48, "ragged": 1}:
        raise AssertionError(f"expected 45 serving, 45 + 3 training and 1 ragged view, checked {n_views}")
    return timed, worst


def psnr(a, b) -> float:
    mse = (a.double() - b.double()).square().mean().item()
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)  # range [-1, 1]


def randomise_running_stats(model, seed: int = 1) -> None:
    """Running stats that are not the identity, so running mode applies a
    real affine: mean ~ N(0, 0.1²), var ~ 1 + U(0, 0.1)."""
    import torch

    from fdgan_tpu_torch.nn.layers import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(1.0 + 0.1 * torch.rand(n, generator=gen))


def phase_generator():
    import torch

    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.models.fdgan import FDGAN
    from fdgan_tpu_torch.ops import dense, stats
    from fdgan_tpu_torch.tools.timing import peak_gib

    model = FDGAN(device="cuda", generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    x_np = np.random.default_rng(0).uniform(size=(8, 512, 512, 3)).astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    forwards = {  # fdgan_fast.apply is what the engine and the train step run
        "fast": lambda m, xx, mode, impl: fdgan_fast.apply(m, xx, bn_mode=mode, impl=impl),
        "module": lambda m, xx, mode, impl: m(xx, bn_mode=mode, impl=impl),
    }
    out = {}
    ref32 = {}
    with torch.inference_mode():
        with exact_fp32():
            for mode in ("batch", "running"):
                ys = {}
                for name, fwd in forwards.items():
                    dense.reset_launch_counts()
                    y_k = fwd(model, x, mode, "kernels")
                    torch.cuda.synchronize()
                    launches = (dense.k1_launches, dense.k2_launches)
                    y_p = fwd(model, x, mode, "plain")
                    err = (y_k - y_p).abs().max().item()
                    ok = torch.allclose(y_k, y_p, **GEN_TOL) and bool(torch.isfinite(y_k).all())
                    log(f"generator {name} fp32 {mode}: kernels vs plain max_abs_err {err:.3e} "
                        f"launches K1 {launches[0]} K2 {launches[1]} ok={ok}")
                    want = (42, 42 if mode == "batch" else 0)
                    if not ok or tuple(y_k.shape) != (8, 512, 512, 3):
                        raise AssertionError(f"generator {name} kernel path disagrees in fp32 {mode} mode")
                    if launches != want:
                        raise AssertionError(f"launches per {name} {mode} forward {launches}, expected {want}")
                    out[f"{name}_fp32_{mode}_max_abs_err"] = err
                    ys[name] = y_k
                    if name == "module":
                        ref32[mode] = y_p
                # the fast forward reassociates the transitions: the same function to fp32 rounding
                err = (ys["fast"] - ys["module"]).abs().max().item()
                log(f"generator fp32 {mode}: fast vs module forward max_abs_err {err:.3e}")
                if not torch.allclose(ys["fast"], ys["module"], **GEN_TOL):
                    raise AssertionError(f"the fast forward disagrees with FDGAN.forward in {mode} mode")
                out[f"fp32_{mode}_fast_vs_module_max_abs_err"] = err
                del ys
        model_bf = FDGAN(device="cuda", dtype=torch.bfloat16)
        model_bf.load_state_dict(model.state_dict())
        xb = x.bfloat16()
        for mode in ("batch", "running"):
            for name, fwd in forwards.items():
                dense.reset_launch_counts()
                stats.reset_launch_count()
                y = fwd(model_bf, xb, mode, "kernels")
                torch.cuda.synchronize()
                launches = (dense.k1_launches, dense.k2_launches, stats.launches)
                p_k = psnr(y.float(), ref32[mode])
                p_p = psnr(fwd(model_bf, xb, mode, "plain").float(), ref32[mode])
                log(f"generator {name} bf16 {mode}: PSNR vs fp32 plain: kernels {p_k:.2f} dB, plain {p_p:.2f} dB; "
                    f"launches K1 {launches[0]} K2 {launches[1]} channel_stats {launches[2]}")
                if not p_k >= p_p - 1.0:
                    raise AssertionError(f"bf16 {name} kernel path loses {p_p - p_k:.2f} dB in {mode} mode")
                # batch mode: 3 block inputs and 42 new slices; FDGAN.forward's transitions reduce
                # their concats again (3 more), the fast forward's reuse the blocks' statistics
                want = (42, 42, 45 if name == "fast" else 48) if mode == "batch" else (42, 0, 0)
                if launches != want:
                    raise AssertionError(f"launches per bf16 {name} {mode} forward {launches}, expected {want}")
                out[f"bf16_{name}_{mode}_psnr_kernels_db"], out[f"bf16_{name}_{mode}_psnr_plain_db"] = p_k, p_p
                out[f"bf16_{name}_{mode}_launches"] = launches
        del ref32
        torch.cuda.empty_cache()
        # peak memory of one batch-BN forward, above what was allocated before it
        for name, fwd in forwards.items():
            out[f"bf16_{name}_batch_peak_gib"] = peak_gib(lambda: fwd(model_bf, xb, "batch", "kernels"))
            log(f"generator {name} bf16 batch 8x512^2: peak {out[f'bf16_{name}_batch_peak_gib']:.3f} GiB")
        # img/s at 8×512², bf16, per BN mode, in turns: the kernel path of both forwards and
        # the plain path of the fast forward (fast, module, plain, plain, module, fast)
        for mode in ("running", "batch"):
            times = {"fast": [], "module": [], "plain": []}
            for name in ("fast", "module", "plain", "plain", "module", "fast"):
                fwd, impl = (forwards["fast"], "plain") if name == "plain" else (forwards[name], "kernels")
                times[name].append(cuda_ms(lambda: fwd(model_bf, xb, mode, impl), reps=5, warmup=1))
            for name, ts in times.items():
                ms = sum(ts) / len(ts)
                out[f"bf16_{mode}_{name}_ms"] = ms
                out[f"bf16_{mode}_{name}_img_s"] = 8 * 1000.0 / ms
                out[f"bf16_{mode}_{name}_turns_ms"] = ts
                log(f"generator bf16 {mode} 8x512^2 {name}: {ms:.2f} ms/batch, {8000.0 / ms:.2f} img/s "
                    f"(turns {', '.join(f'{t:.2f}' for t in ts)} ms)")
    return model, out


def phase_serving(model):
    import torch

    from fdgan_tpu_torch.ops import dense, stats
    from fdgan_tpu_torch.serve import InferenceEngine
    from fdgan_tpu_torch.serve_http import BatchingFrontend

    rng = np.random.default_rng(2)
    sizes = [(480, 640), (512, 512), (360, 500), (8, 8)] * 3
    images = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]
    engines = {
        mode: InferenceEngine(model, device="cuda", precision="bf16", bn_mode=mode)
        for mode in ("running", "batch")
    }

    def submit_all(frontend, imgs):
        futs = [None] * len(imgs)

        def worker(k):
            for i in range(k, len(imgs), 4):
                futs[i] = frontend.submit(imgs[i])

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return [f.result(timeout=600) for f in futs]

    fronts = {mode: BatchingFrontend(eng, max_wait=0.05) for mode, eng in engines.items()}
    try:
        # the main path's run: counters from 0, read right after
        dense.reset_launch_counts()
        stats.reset_launch_count()
        t0 = time.perf_counter()
        results = {"running": submit_all(fronts["running"], images),
                   "batch": submit_all(fronts["batch"], images[:4])}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k1": dense.k1_launches, "k2": dense.k2_launches, "channel_stats": stats.launches}
        lat = fronts["running"].latency_stats()
    finally:
        for fe in fronts.values():
            fe.close()
    log(f"serving: {len(images)} + 4 requests in {wall:.2f} s; launches {launches}")
    for mode, eng in engines.items():
        log(f"engine[{mode}].stats {json.dumps(eng.stats)}")
    log(f"frontend[running] latency {json.dumps(lat)}")
    for mode, outs in results.items():
        for img, y in zip(images, outs):
            if y.shape != img.shape or not np.isfinite(y).all():
                raise AssertionError(f"{mode}: bad result {y.shape} for input {img.shape}")
    direct = engines["running"].predict_batch(images)
    diffs = [np.abs(a - b) for a, b in zip(results["running"], direct)]
    max_d = max(float(d.max()) for d in diffs)
    mean_d = float(np.mean([d.mean() for d in diffs]))
    log(f"serving vs predict_batch: max_abs_diff {max_d:.3e} mean_abs_diff {mean_d:.3e}")
    if max_d > SERVE_TOL["atol"] or mean_d > SERVE_TOL["mean"]:
        raise AssertionError("frontend results disagree with predict_batch")
    eng_batches = sum(e.stats["batches"] for e in engines.values())
    if 0 in launches.values():
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    return launches, {"wall_s": wall, "batches_total": eng_batches, **lat}


WARM_SHAPES = [(512, 512), (480, 640)]  # phase 4's warmup: two buckets (512², 512x640) at every rung of the ladder
WARM_AUTO = (384, 384)  # phase 4's auto-warm: a bucket no earlier request has met
# a fresh process's first request at 512² bf16 running BN, cold or after warmup (its time, then a second request's),
# the generator's weights read from a file (argv[2])
FIRST_REQUEST_SCRIPT = r"""
import json, sys, time
import numpy as np
import torch
from fdgan_tpu_torch.serve import InferenceEngine
t0 = time.perf_counter()
engine = InferenceEngine(torch.load(sys.argv[2], weights_only=True), device="cuda", precision="bf16")
if sys.argv[1] == "warm":
    engine.warmup([(512, 512)])
torch.cuda.synchronize()
setup = time.perf_counter() - t0
img = np.random.default_rng(0).integers(0, 256, (512, 512, 3), dtype=np.uint8)
ms = []
for _ in range(2):
    t = time.perf_counter()
    y = engine.predict(img)
    ms.append(1000 * (time.perf_counter() - t))
print(json.dumps({"first_ms": ms[0], "second_ms": ms[1], "setup_s": setup, "compiles": engine.stats["compiles"],
                  "finite": bool(np.isfinite(y).all()), "shape": list(y.shape)}))
"""


def phase_warmup(model):
    """Phase 4's warmup: (1) ``InferenceEngine.warmup`` of WARM_SHAPES over
    the default ladder: ``stats["compiles"]`` equals rungs × shapes, the
    dispatch statistics do not move, and the counters show K1 42 a rung and
    shape (running BN: no K2, no channel_stats); (2) ``auto_warm``: the first
    request of WARM_AUTO's bucket starts a thread that runs the other rungs
    (counted K1 launches), after which a request at the top rung counts no
    compile; (3) the first request at 512² of a fresh process, cold and after
    ``warmup``, in turns (cold, warm, warm, cold), each process alone on the
    card. Returns the phase's numbers and the K1 launches of the warmup."""
    import torch

    from fdgan_tpu_torch.ops import dense, stats
    from fdgan_tpu_torch.serve import InferenceEngine

    t0 = time.perf_counter()
    out = {}
    eng = InferenceEngine(model, device="cuda", precision="bf16")
    rungs = len(eng.batch_sizes)
    dense.reset_launch_counts()
    stats.reset_launch_count()
    t = time.perf_counter()
    eng.warmup(WARM_SHAPES)
    torch.cuda.synchronize()
    launches = {"k1": dense.k1_launches, "k2": dense.k2_launches, "channel_stats": stats.launches}
    out["warmup"] = {"shapes": WARM_SHAPES, "rungs": list(eng.batch_sizes), "seconds": time.perf_counter() - t,
                     "compiles": eng.stats["compiles"], "batches": eng.stats["batches"], "launches": launches}
    log(f"warmup: {json.dumps(out['warmup'])}")
    want = {"k1": 42 * rungs * len(WARM_SHAPES), "k2": 0, "channel_stats": 0}
    if eng.stats["compiles"] != rungs * len(WARM_SHAPES) or eng.stats["batches"] or launches != want:
        raise AssertionError(f"warmup: compiles {eng.stats['compiles']}, batches {eng.stats['batches']}, "
                             f"launches {launches}; expected {rungs * len(WARM_SHAPES)}, 0, {want}")
    del eng

    auto = InferenceEngine(model, device="cuda", precision="bf16", auto_warm=True)
    img = np.random.default_rng(4).integers(0, 256, WARM_AUTO + (3,), dtype=np.uint8)
    dense.reset_launch_counts()
    auto.predict(img)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        with auto._lock:
            if WARM_AUTO in auto._warmed and not auto._warming:
                break
        time.sleep(0.05)
    torch.cuda.synchronize()
    warmed = dense.k1_launches
    ys = auto.predict_batch([img] * auto.batch_sizes[-1])
    out["auto_warm"] = {"bucket": list(WARM_AUTO), "k1_first_and_warm": warmed, "compiles": auto.stats["compiles"],
                        "batches": auto.stats["batches"]}
    log(f"auto-warm: {json.dumps(out['auto_warm'])}")
    if not (warmed == 42 * rungs and auto.stats["compiles"] == 1 and all(np.isfinite(y).all() for y in ys)):
        raise AssertionError(f"auto-warm: {out['auto_warm']}; expected K1 {42 * rungs} and one compile")
    del auto
    torch.cuda.empty_cache()

    # fresh processes, one at a time: a cold start is the process's, not the engine's
    import os

    weights = os.path.join("build", "first_request_netG.pt")
    os.makedirs("build", exist_ok=True)
    torch.save(model.state_dict(), weights)
    turns = {"cold": [], "warm": []}
    for mode in ("cold", "warm", "warm", "cold"):
        res = subprocess.run([sys.executable, "-c", FIRST_REQUEST_SCRIPT, mode, weights], capture_output=True,
                             text=True, timeout=300)
        if res.returncode:
            raise AssertionError(f"first request ({mode}): {res.stdout[-2000:]}{res.stderr[-2000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        if not (row["finite"] and row["shape"] == [512, 512, 3] and row["compiles"] == (1 if mode == "cold" else 4)):
            raise AssertionError(f"first request ({mode}): {row}")
        turns[mode].append(row)
    out["first_request_512"] = {m: {"first_ms": [r["first_ms"] for r in rows],
                                    "second_ms": [r["second_ms"] for r in rows],
                                    "setup_s": [r["setup_s"] for r in rows]} for m, rows in turns.items()}
    os.remove(weights)
    log(f"first request at 512^2 bf16, fresh process: {json.dumps(out['first_request_512'])}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 4 warmup: {out['seconds']:.1f} s")
    return out, launches


def train_batch(b, size, seed, device="cuda"):
    """gt uniform, haze = clip(0.6·gt + 0.3), from a numpy seed."""
    import torch

    gt = np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)
    haze = np.clip(0.6 * gt + 0.3, 0, 1)
    return torch.from_numpy(haze).to(device), torch.from_numpy(gt).to(device)


def reset_all_counts():
    from fdgan_tpu_torch.ops import dense, freq, stats

    dense.reset_launch_counts()
    freq.reset_launch_count()
    stats.reset_launch_count()


def all_counts():
    from fdgan_tpu_torch.ops import dense, freq, stats

    return {"k1": dense.k1_launches, "k2": dense.k2_launches, "k3": freq.k3_launches, "channel_stats": stats.launches}


def phase_k3():
    import torch

    from fdgan_tpu_torch.ops import filters, freq
    from fdgan_tpu_torch.tools.probes import bound_ms, nbytes
    from fdgan_tpu_torch.tools.timing import device_ms

    rows, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for shape in K3_SHAPES:
            x = torch.tensor(np.random.default_rng(3).uniform(size=shape), dtype=dtype, device="cuda")
            with exact_fp32():
                got, want = freq.frequency_fuse(x), filters.frequency_fuse(x)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = tuple(got.shape) == shape[:3] + (9,) and torch.allclose(got.float(), want.float(), **K3_TOL[name])
                # per pixel and channel: two 15-tap passes (a multiply and an add
                # each) and the 9-term Laplacian, all outside the tensor cores
                bound, by = bound_ms(x.numel() * (2 * 30 + 9), nbytes(x, got), tensor_cores=False)
                row = {"shape": list(shape), "dtype": name, "k3_max_abs_err": err, "k3_bit_equal": torch.equal(got, want),
                       "k3_ms": cuda_ms(lambda: freq.frequency_fuse(x)),
                       "k3_plain_ms": cuda_ms(lambda: filters.frequency_fuse(x)),
                       "k3_bound_ms": bound, "k3_bound_by": by}
                if shape in K3_SHAPES[:2]:  # the kernel alone, and its share of the bound
                    row["k3_device_ms"] = device_ms(lambda: freq.frequency_fuse(x), launches=40)
                    row["k3_device_share"] = bound / row["k3_device_ms"]
            rows.append(row)
            worst = max(worst, err)
            log(json.dumps(row))
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain version at {shape} {name}: err {err}")
    return rows, worst


def phase_gradients():
    """Gradients through K1 and K2 (a 2-layer dense block) and K3 against the
    plain path: both backwards are the plain version's VJP, so only K1's fp32
    forward error (≤ 6e-6) separates them."""
    import torch

    from fdgan_tpu_torch.models.densenet import DenseBlock
    from fdgan_tpu_torch.ops import dense, filters, freq

    torch.manual_seed(0)
    block = DenseBlock(64, 2, device="cuda")
    x = torch.tensor(np.random.default_rng(4).uniform(size=(2, 32, 48, 64)), dtype=torch.float32, device="cuda")
    xs = torch.tensor(np.random.default_rng(5).uniform(size=(2, 40, 56, 3)), dtype=torch.float32, device="cuda")
    ct = torch.randn(2, 40, 56, 9, device="cuda")
    grads = {}
    with exact_fp32():
        for impl in ("kernels", "plain"):
            block.zero_grad(set_to_none=True)
            xi, xf = x.clone().requires_grad_(True), xs.clone().requires_grad_(True)
            y, _ = dense.dense_block_fused(list(block.children()), xi, mode="batch", impl=impl)
            y.square().mean().backward()
            fuse = freq.frequency_fuse if impl == "kernels" else filters.frequency_fuse
            (fuse(xf) * ct).sum().backward()
            grads[impl] = [xi.grad] + [p.grad for p in block.parameters()] + [xf.grad]
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(grads["kernels"], grads["plain"]))
    ok = all(torch.allclose(a, b, atol=1e-5, rtol=1e-4) for a, b in zip(grads["kernels"], grads["plain"]))
    log(f"gradients through K1, K2, K3 vs plain: max_abs_err {err:.3e} ok={ok}")
    if not ok:
        raise AssertionError("gradients through the kernels disagree with the plain path")
    return err


def compare_states(a, b):
    """(share of parameters off by > 1e-6, max parameter difference, max
    running-statistic difference) between two train states' G and D."""
    off = n = 0
    worst_p = worst_s = 0.0
    for net in ("g", "d"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        for k, v in sb.items():
            diff = (sa[k] - v).abs()
            if "running" in k:
                worst_s = max(worst_s, diff.max().item())
            else:
                worst_p = max(worst_p, diff.max().item())
                n, off = n + diff.numel(), off + int((diff > 1e-6).sum().item())
    return off / n, worst_p, worst_s


def phase_train_fp32(weights=None, vgg=None, what=""):
    """One fp32 step (TF32 off) from one state and batch, kernels against
    plain. Losses: rtol 1e-4. Parameters: Adam's first step moves each by
    ±lr wherever |g| ≫ ε, so gradient noise around 0 (conv biases under batch
    BN) can differ in sign between the two: ≤ 2·lr everywhere and ≤ 1e-6 on
    all but 0.5 % (tests/test_torch_train.py); running stats atol 1e-5.
    ``weights`` (no perceptual term by default) and ``vgg`` are the step's."""
    import copy

    import torch

    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

    state, tx_g, tx_d = create_train_state(0, device="cuda")
    states = {"kernels": state, "plain": copy.deepcopy(state)}
    haze, gt = train_batch(2, 64, 6)
    metrics = {}
    with exact_fp32():
        for impl, st in states.items():
            _, m = make_train_step(tx_g, tx_d, weights or LossWeights(perceptual=0.0), vgg, impl=impl)(st, haze, gt)
            metrics[impl] = {k: v.item() for k, v in m.items()}
    loss_err = max(abs(v - metrics["plain"][k]) / max(abs(metrics["plain"][k]), 1e-6)
                   for k, v in metrics["kernels"].items())
    off, worst_p, worst_s = compare_states(states["kernels"], states["plain"])
    out = {"loss_max_rel_err": loss_err, "param_share_over_1e-6": off, "param_max_abs_err": worst_p,
           "running_stat_max_abs_err": worst_s, "losses": metrics["kernels"]}
    log(f"train fp32 2x64^2{what} kernels vs plain: {json.dumps(out)}")
    finite = all(np.isfinite(v) for v in metrics["kernels"].values())
    if not (finite and loss_err <= 1e-4 and off < 5e-3 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5):
        raise AssertionError(f"the fp32 train step{what} with the kernels disagrees with the plain step")
    return out


def phase_training():
    """The path: make_train_step at 4×256² bf16, 10 steps per impl in turns
    (plain, kernels, kernels, plain; 5 steps each), after one warm-up step
    each. The launch counters are zeroed just before and read just after."""
    import torch

    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps, make_train_step
    from fdgan_tpu_torch.train.pool import ImagePool

    b, size, _ = TRAIN_SHAPE
    weights = LossWeights(perceptual=0.0)
    runs = {}
    for impl in ("kernels", "plain"):
        state, tx_g, tx_d = create_train_state(0, device="cuda")
        step = make_train_step(tx_g, tx_d, weights, compute_dtype=torch.bfloat16, impl=impl)
        runs[impl] = {"state": state, "tx": (tx_g, tx_d), "step": step, "seconds": 0.0, "losses": [], "steps": 0}
    batches = [train_batch(b, size, 100 + i) for i in range(TRAIN_STEPS)]
    for impl, r in runs.items():  # warm-up: cuDNN's algorithm choice, the allocator
        r["step"](r["state"], *batches[0])
    torch.cuda.synchronize()

    peak = {}
    reset_all_counts()
    for impl in ("plain", "kernels", "kernels", "plain"):
        r = runs[impl]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS // 2):
            _, m = r["step"](r["state"], *batches[(r["steps"] + i) % TRAIN_STEPS])
            r["losses"].append(torch.stack([m["g_total"], m["d_total"], m["g_adv"], m["g_ssim"]]))
        torch.cuda.synchronize()
        r["seconds"] += time.perf_counter() - t0
        r["steps"] += TRAIN_STEPS // 2
        peak[impl] = max(peak.get(impl, 0), torch.cuda.max_memory_allocated())
    launches = all_counts()

    out = {}
    for impl, r in runs.items():
        losses = torch.stack(r["losses"]).float().cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite loss in the {impl} bf16 train steps: {losses}")
        out[impl] = {"steps": r["steps"], "seconds": r["seconds"],
                     "img_s": b * r["steps"] / r["seconds"], "ms_per_step": 1000 * r["seconds"] / r["steps"],
                     "peak_gib": peak[impl] / 2**30, "g_total_first_last": [float(losses[0, 0]), float(losses[-1, 0])],
                     "d_total_first_last": [float(losses[0, 1]), float(losses[-1, 1])]}
        log(f"train bf16 {b}x{size}^2 {impl}: {json.dumps(out[impl])}")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"train launches {launches} per step {per_step}")
    # channel_stats: G's 3 block inputs and 42 slices, and D's 3 BNs in each of its 3 forwards
    if per_step != {"k1": 42, "k2": 42, "k3": 3, "channel_stats": 45 + 3 * 3}:
        raise AssertionError(f"launches per train step {per_step}, expected K1 42, K2 42, K3 3, channel_stats 54")

    # split G/D steps through an ImagePool (misc.py:140-161)
    state = runs["kernels"]["state"]
    g_step, d_step = make_gd_steps(*runs["kernels"]["tx"], weights, compute_dtype=torch.bfloat16)
    pool = ImagePool(pool_size=2, seed=0)
    for i in range(3):
        state, gm, x_hat = g_step(state, *batches[i])
        state, dm = d_step(state, pool.query(x_hat), batches[i][1])
        vals = [gm["g_total"].item(), dm["d_total"].item()]
        if not np.isfinite(vals).all():
            raise AssertionError(f"non-finite loss in split G/D step {i}: {vals}")
    log(f"split G/D steps with ImagePool(2): 3 steps, last g_total {vals[0]:.4f} d_total {vals[1]:.4f}")
    out["launches"], out["launches_per_step"] = launches, per_step
    return out, launches


def phase_probes():
    """Phase 6. Checks first (their launches are not the path's), then the
    path: tools.probes.run() at the probes' full sizes."""
    import torch

    from fdgan_tpu_torch.ops import probes as ops
    from fdgan_tpu_torch.tools import probes as tool

    selfcheck = tool.wgmma_selfcheck()
    log(f"wgmma self-check vs torch.matmul (fp32): max_abs_err {selfcheck:.3e} (tol 1e-3)")
    errs = {}
    for name in tool.PROBES:  # tolerances: tools/probes.py PRODUCT_TOL, CONV1_TOL, COPY_TOL
        by_size = {size: tool.check(name, size) for size in ("full", "ragged")}
        errs[name] = max(by_size.values())
        log(f"{name} vs plain: max_abs_err {json.dumps(by_size)} tol {json.dumps(tool.PROBES[name].tol)}")
    a, b = tool.make_mm("ragged", np.random.default_rng(1), "cuda")
    want = ops.mm_reference(a, b)
    for tile in ops.MM_TILES:
        err = tool.compare(ops.probe_mm(a, b, tile), want, tool.PRODUCT_TOL, f"probe_mm, row tile {tile}")
        log(f"probe_mm row tile {tile} vs plain: max_abs_err {err}")
    del a, b, want
    for size in ("full", "ragged"):
        segs, a1, b1, w1 = tool.make_conv1(size, np.random.default_rng(3), "cuda")
        err = tool.compare(ops.conv1_segments(segs, a1, b1, w1, "wgmma"), ops.conv1_segments(segs, a1, b1, w1, "mma"),
                           tool.CONV1_TOL, f"conv1 wgmma vs mma at {size}")
        log(f"probe_conv1 wgmma vs mma at {size}: max_abs_err {err}")
        del segs, a1, b1, w1
    g, w2 = tool.make_conv2("ragged", np.random.default_rng(2), "cuda")
    taps9 = ops.conv2(g, w2, "taps9")
    for mode in ("packed", "wgmma"):
        err = tool.compare(ops.conv2(g, w2, mode), taps9, tool.PRODUCT_TOL, f"conv2 {mode} vs taps9")
        log(f"probe_conv2 {mode} vs taps9: max_abs_err {err}")
    del g, w2, taps9
    torch.cuda.empty_cache()
    log(json.dumps({"wgmma_rates": tool.wgmma_rates()}))

    ops.reset_launch_counts()
    rows = tool.run("cuda", "full", on_row=lambda row: log(json.dumps(row)))
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    for line in tool.answers(rows):
        log(json.dumps(line))
    for row in rows:
        if row["name"].startswith("probe_scale_copy"):
            log(f"{row['name']} in turns: {row['ms']:.4f} ms {row['ms_spread']}, {row['library']} "
                f"{row['library_ms']:.4f} ms {row['library_ms_spread']}: {tool.turn_verdict(row)} the library")
    log(f"probe launches {launches}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle or len(rows) != len(tool.PROBES):
        raise AssertionError(f"probe kernels that the path did not launch: {idle}")
    return {row["name"]: row for row in rows}, errs, launches


DEMO_SIZES = [(1024, 1024), (1024, 1024), (1200, 1600), (1021, 1533)]  # batch 1 each
DEMO_TILE = dict(tile=512, halo=128)
# tests/test_tiling_fdgan.py's bounds on the JAX route's tiled-vs-untiled error (held on the CPU at
# 64², halo 16); reported beside the card's, not gated
JAX_TILING_BOUNDS = {"median": 1e-3, "mean": 5e-3}


def phase_demo():
    """Phase 7: the demo's core over in-memory pairs. Returns the phase's
    numbers and the launches of the path's runs (K1..channel_stats, and the
    probes', which the demo never runs)."""
    import os
    import tempfile

    import torch

    from fdgan_tpu_torch.cli._common import maybe_profile
    from fdgan_tpu_torch.cli.demo import dehaze
    from fdgan_tpu_torch.data.h5 import DataLoader
    from fdgan_tpu_torch.dist.tiling import _tile_starts
    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.models.fdgan import FDGAN
    from fdgan_tpu_torch.ops import metrics
    from fdgan_tpu_torch.ops import probes as probe_ops
    from fdgan_tpu_torch.serve import InferenceEngine
    from fdgan_tpu_torch.tools.timing import peak_gib
    from fdgan_tpu_torch.utils.images import normalize_to_uint8

    model = FDGAN(device="cuda", generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    rng = np.random.default_rng(0)
    pairs = []
    for h, w in DEMO_SIZES:
        gt = rng.uniform(size=(h, w, 3)).astype(np.float32)
        pairs.append((np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32), gt))
    big = pairs[2:3]  # 1200×1600

    def run(items, **kw):
        """The demo's core over a loader of ``items``: (images, ms per image)."""
        out = list(dehaze(model, DataLoader(items, batch_size=1), device="cuda", **kw))
        if [i for i, _, _ in out] != list(range(len(items))):
            raise AssertionError(f"the demo yielded indices {[i for i, _, _ in out]}")
        return [y for _, _, y in out], [1000.0 * s for _, s, _ in out]

    runs = {"fp32": (pairs, dict(precision="fp32")), "bf16": (pairs, dict(precision="bf16")),
            "tiled": (big, dict(precision="fp32", bn_mode="running", **DEMO_TILE))}
    n_tiles = len(_tile_starts(1200, 512, 128)) * len(_tile_starts(1600, 512, 128))
    n = len(pairs)
    want = {"fp32": {"k1": 42 * n, "k2": 42 * n, "k3": 0, "channel_stats": 0},
            "bf16": {"k1": 42 * n, "k2": 42 * n, "k3": 0, "channel_stats": 45 * n},
            "tiled": {"k1": 42 * n_tiles, "k2": 0, "k3": 0, "channel_stats": 0}}
    # the path: counters from 0 just before, read just after
    ys, per_run = {}, {}
    reset_all_counts()
    probe_ops.reset_launch_counts()
    for name, (items, kw) in runs.items():
        before = all_counts()
        ys[name], _ = run(items, **kw)
        per_run[name] = {k: v - before[k] for k, v in all_counts().items()}
    torch.cuda.synchronize()
    launches, probe_launches = all_counts(), dict(probe_ops.launches)
    log(f"demo launches per run {json.dumps(per_run)} (tiles of 1200x1600: {n_tiles}); probes {probe_launches}")
    for name, got in per_run.items():
        if got != want[name]:
            raise AssertionError(f"demo {name}: launches {got}, expected {want[name]}")

    out = {"launches": launches, "launches_per_run": per_run, "tiles": n_tiles}
    plain = {name: run(items, impl="plain", **kw)[0] for name, (items, kw) in runs.items()}
    # 1. fp32 batch BN, the demo's default: kernels against plain, and their 8-bit PNG levels
    worst, worst_u8, u8 = 0.0, 0, []
    for (haze, _), y_k, y_p in zip(pairs, ys["fp32"], plain["fp32"]):
        err = float(np.abs(y_k - y_p).max())
        u_k, u_p = normalize_to_uint8(y_k), normalize_to_uint8(y_p)
        d_u8 = int(np.abs(u_k.astype(int) - u_p.astype(int)).max())
        ok = (y_k.shape == haze.shape and np.isfinite(y_k).all()
              and np.allclose(y_k, y_p, **GEN_TOL) and d_u8 <= 1)
        log(f"demo fp32 batch {haze.shape[:2]}: kernels vs plain max_abs_err {err:.3e}, "
            f"8-bit levels apart {d_u8} ok={ok}")
        if not ok:
            raise AssertionError(f"demo fp32 kernels disagree with plain at {haze.shape}")
        worst, worst_u8 = max(worst, err), max(worst_u8, d_u8)
        u8.append((u_k, u_p))
    out.update(fp32_max_abs_err=worst, fp32_max_u8_levels=worst_u8)
    # 2. bf16 batch BN against the fp32 output, kernels and plain
    for (haze, _), y_k, y_p, ref in zip(pairs, ys["bf16"], plain["bf16"], plain["fp32"]):
        ref_t = torch.from_numpy(ref)
        p_k, p_p = psnr(torch.from_numpy(y_k), ref_t), psnr(torch.from_numpy(y_p), ref_t)
        log(f"demo bf16 batch {haze.shape[:2]}: PSNR vs fp32 plain: kernels {p_k:.2f} dB, plain {p_p:.2f} dB")
        if not (y_k.shape == haze.shape and p_k >= p_p - 1.0):
            raise AssertionError(f"demo bf16 kernels lose {p_p - p_k:.2f} dB at {haze.shape}")
        out.setdefault("bf16_psnr_kernels_db", []).append(p_k)
        out.setdefault("bf16_psnr_plain_db", []).append(p_p)
    # 4. the tiled route: against its plain version, the engine's tiled route, and the untiled forward
    y_t, y_tp = ys["tiled"][0], plain["tiled"][0]
    err_t = float(np.abs(y_t - y_tp).max())
    if not (y_t.shape == big[0][0].shape and np.allclose(y_t, y_tp, **GEN_TOL)):
        raise AssertionError(f"demo tiled kernels disagree with plain: max_abs_err {err_t}")
    engine = InferenceEngine(model, device="cuda", precision="fp32", bn_mode="running", **DEMO_TILE)
    y_e = engine.predict(big[0][0])
    err_e = float(np.abs(y_e - y_t).max())
    log(f"demo tiled 1200x1600 (tile 512, halo 128, running BN, fp32): kernels vs plain max_abs_err {err_t:.3e}; "
        f"engine vs demo {err_e:.3e}; engine.stats {json.dumps(engine.stats)}")
    if err_e > 1e-6 or engine.stats["batches"] != 1:
        raise AssertionError(f"the engine's tiled route disagrees with the demo's: {err_e}")
    del engine
    y_u = run(big, precision="fp32", bn_mode="running")[0][0]
    d = np.abs(y_t - y_u)
    out["tiled_vs_untiled"] = {"median": float(np.median(d)), "mean": float(d.mean()), "max": float(d.max()),
                               "psnr_db": psnr(torch.from_numpy(y_t), torch.from_numpy(y_u)),
                               "jax_suite_bounds": JAX_TILING_BOUNDS}
    out.update(tiled_max_abs_err=err_t, tiled_engine_max_abs_err=err_e)
    log(f"demo tiled vs untiled (running BN, fp32; not gated): {json.dumps(out['tiled_vs_untiled'])}")
    # 5. the metrics of PSNRSSIM.py on the 8-bit outputs, kernels against plain
    scores = []
    for u_k, u_p in u8:
        with np.errstate(divide="ignore"):
            p = metrics.psnr(u_k / 255.0, u_p / 255.0)
        scores.append((p, metrics.mssim_channels(u_k, u_p)))
    log(f"demo ops.metrics kernels vs plain (8-bit): PSNR {[round(p, 2) for p, _ in scores]} dB, "
        f"SSIM {[round(q, 6) for _, q in scores]}")
    # at most one level apart: MSE <= 1/255^2
    if not all(p >= 20 * np.log10(255.0) and q >= 0.99 for p, q in scores):
        raise AssertionError(f"ops.metrics on the kernels' and plain outputs: {scores}")
    out["metrics_psnr_ssim"] = scores
    # 6. one 1024² image per precision under the demo's profiler: the trace must name K1's and K2's kernels;
    # the device's busy time per image is the sum of its kernels and copies (one stream: no overlap)
    for prec in ("fp32", "bf16"):
        with tempfile.TemporaryDirectory() as tmp:
            with maybe_profile(tmp):
                ms = run(pairs[:1], precision=prec)[1][0]
            with open(os.path.join(tmp, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        # fp32: the 3xTF32 kernels; bf16: the bf16 ones (K2's name is not a part of its mma.sync body's)
        k1, k2 = (f"{k}_{'tf32x3' if prec == 'fp32' else 'bf16'}_kernel" for k in ("dense_layer", "h_stats"))
        on_device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        named = sum(1 for e in on_device if k1 in e.get("name", ""))
        named2 = sum(1 for e in on_device if k2 in e.get("name", ""))
        busy = sum(e.get("dur", 0) for e in on_device) / 1000.0
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in on_device:
            # the port's kernels sit in an anonymous namespace: "(anonymous namespace)::dense_layer_tf32x3_kernel(...)"
            row = by_name[e.get("name", "").replace("(anonymous namespace)::", "").split("(")[0][:80]]
            row[0] += e.get("dur", 0) / 1000.0
            row[1] += 1
        top = sorted(([n, ms_, c] for n, (ms_, c) in by_name.items()), key=lambda r: -r[1])[:8]
        out[f"{prec}_batch_1024x1024_profiled"] = {"ms": ms, "device_busy_ms": busy, "device_events": len(on_device),
                                                   "k1_events": named, "k2_events": named2, "top_ms_count": top}
        log(f"demo profile {prec} 1024x1024: {ms:.2f} ms (profiled), device busy {busy:.2f} ms in "
            f"{len(on_device)} events, {named} named {k1}, {named2} named {k2}; largest (ms, count): "
            + "; ".join(f"{n} {t:.2f} x{c}" for n, t, c in top))
        if (named, named2) != (42, 42):
            raise AssertionError(f"the profiler's trace of the demo names {k1} {named} times and {k2} {named2} "
                                 f"times, expected 42 each")
    # times: ms per image in turns (kernels, plain, plain, kernels), after the runs above
    sizes = {"1024x1024": [0, 1], "1200x1600": [2], "1021x1533": [3]}
    for prec in ("fp32", "bf16"):
        turns = {"kernels": [], "plain": []}
        for impl in ("kernels", "plain", "plain", "kernels"):
            turns[impl].append(run(pairs, precision=prec, impl=impl)[1])
        for impl, ts in turns.items():
            for size, idx in sizes.items():
                out[f"{prec}_batch_{impl}_{size}_ms"] = float(np.mean([t[i] for t in ts for i in idx]))
            out[f"{prec}_batch_{impl}_turns_ms"] = ts
        log(f"demo {prec} batch BN ms per image (kernels | plain): " + ", ".join(
            f"{size} {out[f'{prec}_batch_kernels_{size}_ms']:.2f} | {out[f'{prec}_batch_plain_{size}_ms']:.2f}"
            for size in sizes))
    out["tiled_kernels_1200x1600_ms"] = run(big, **runs["tiled"][1])[1][0]
    out["untiled_running_kernels_1200x1600_ms"] = run(big, precision="fp32", bn_mode="running")[1][0]
    x = torch.from_numpy(big[0][0][None]).cuda()
    with torch.inference_mode(), exact_fp32():
        out["fp32_batch_1200x1600_peak_gib"] = peak_gib(lambda: fdgan_fast.apply(model, x, bn_mode="batch"))
    log(f"demo tiled 1200x1600 {out['tiled_kernels_1200x1600_ms']:.2f} ms (untiled running "
        f"{out['untiled_running_kernels_1200x1600_ms']:.2f}); fp32 batch-BN 1200x1600 forward peak "
        f"{out['fp32_batch_1200x1600_peak_gib']:.3f} GiB")
    return out, launches, probe_launches


CLI_TRAIN = dict(batch=8, size=256, batches=4, epochs=2, val=2)  # the CLI's defaults: batch 8, 256², --poolSize 50
LOOP_SHAPE = (4, 256, 10)  # batch, size, steps: phase 5's bare step, through the CLI's loop
REMAT_SHAPE = (2, 1024)  # the memory levers' cell: bf16, one warm step and one timed step each
REMAT_MODES = {"none": dict(remat=False), "remat": dict(remat=True), "stages": dict(remat="stages"),
               "accum2": dict(accum_steps=2)}
# launches per bf16 train step: G's forward, plus each checkpointed layer core's recompute (K2, K1) under
# remat, plus each encoder stage's recompute under "stages" (45 channel_stats, and the layer cores
# once more inside it); accum 2 runs G's forward (and D's in G's loss) once per microbatch
REMAT_LAUNCHES = {"none": {"k1": 42, "k2": 42, "k3": 3, "channel_stats": 54},
                  "remat": {"k1": 84, "k2": 84, "k3": 3, "channel_stats": 54},
                  "stages": {"k1": 126, "k2": 126, "k3": 3, "channel_stats": 99},
                  "accum2": {"k1": 84, "k2": 84, "k3": 4, "channel_stats": 102}}


def pairs(n, size, seed):
    """n (haze, gt) pairs: gt uniform, haze = clip(0.6·gt + 0.3), numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.uniform(size=(size, size, 3)).astype(np.float32)
        out.append((np.clip(0.6 * gt + 0.3, 0, 1).astype(np.float32), gt))
    return out


@contextlib.contextmanager
def patched(module, name, wrap):
    """module.name replaced by wrap(original) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def run_cli(args, loader, val_loader=None):
    """cli.train.train over in-memory loaders, on the card; returns (state,
    its standard output, the records of exp/train_log.jsonl)."""
    import io
    import os

    from fdgan_tpu_torch.cli import train as cli

    opt = cli.build_parser().parse_args(args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = cli.train(opt, loader, val_loader, "cuda")
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith("Namespace("):
            log(f"  | {line}")
    with open(os.path.join(opt.exp, "train_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return state, out, records


def same_as_file(state, path) -> bool:
    """Every tensor of the live state equal, bit for bit, to the file's."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    same = state.step == blob["step"] and state.d_updates == blob["d_updates"]
    for net in ("g", "d"):
        live = getattr(state, net).state_dict()
        same &= live.keys() == blob[net].keys() and all(torch.equal(live[k].cpu(), v) for k, v in blob[net].items())
        opt = getattr(state, f"{net}_opt").state_dict()["state"]
        saved = blob[f"{net}_opt"]["state"]
        same &= opt.keys() == saved.keys() and all(
            torch.equal(opt[i][k].cpu(), v) for i, entry in saved.items() for k, v in entry.items())
    return bool(same)


def phase_train_cli(step_img_s: float):
    """Phase 8: the training CLI's core, cli.train.train, over in-memory pairs.
    Returns the phase's numbers and the launches of part 1's train steps."""
    import os
    import shutil

    import torch

    from fdgan_tpu_torch.cli import train as cli
    from fdgan_tpu_torch.cli._common import load_generator
    from fdgan_tpu_torch.data.h5 import DataLoader
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.models.vgg16 import VGG16
    from fdgan_tpu_torch.serve import InferenceEngine
    from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

    t0 = time.perf_counter()
    root = os.path.join("build", "train_cli")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    # 1. the CLI's defaults in bf16: 8×256², --poolSize 50, two epochs of 4 batches, keepBest on 2 val images,
    #    then one more epoch resumed from the exp dir
    c = CLI_TRAIN
    train_pairs, val_pairs = pairs(c["batch"] * c["batches"], c["size"], 0), pairs(c["val"], c["size"], 1)
    loader = DataLoader(train_pairs, batch_size=c["batch"], shuffle=True, seed=0)
    val_loader = DataLoader(val_pairs, batch_size=1)
    exp = os.path.join(root, "defaults")
    args = ["--exp", exp, "--precision", "bf16", "--lambdaPerceptual", "0", "--evalIter", "4", "--keepBest",
            "--logEvery", "2", "--batchSize", str(c["batch"]), "--imageSize", str(c["size"])]
    evals = {"calls": 0, "images": 0, "launches": collections.Counter()}
    io_ms = {"save": [], "load": [], "resumed_equals_file": []}

    def counted(fn):
        def wrapped(*args):
            before = all_counts()
            res = fn(*args)
            torch.cuda.synchronize()
            evals["launches"].update({k: v - before[k] for k, v in all_counts().items()})
            evals["calls"] += 1
            evals["images"] += len(val_pairs)
            return res
        return wrapped

    def count_device_eval(orig):  # the val set stacks: the CLI evaluates on the device (train/loop.make_device_eval)
        def wrapped(val, device, impl="kernels"):
            fn = orig(val, device, impl)
            return None if fn is None else counted(fn)
        return wrapped

    def timed_save(orig):
        def wrapped(path, state, step=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = orig(path, state, step)
            io_ms["save"].append(1000 * (time.perf_counter() - t))
            io_ms["mb"] = os.path.getsize(res) / 1e6
            return res
        return wrapped

    def timed_load(orig):
        def wrapped(path, state):
            t = time.perf_counter()
            res = orig(path, state)
            torch.cuda.synchronize()
            io_ms["load"].append(1000 * (time.perf_counter() - t))
            io_ms["resumed_equals_file"].append(same_as_file(state, path))
            return res
        return wrapped

    reset_all_counts()  # the path's runs: counters from 0 just before, read just after
    with patched(cli, "evaluate", counted), patched(cli, "device_eval", count_device_eval), \
            patched(cli, "save_checkpoint", timed_save), patched(cli, "load_checkpoint", timed_load):
        state, _, records = run_cli(args + ["--epochs", str(c["epochs"])], loader, val_loader)
        steps_first = state.step
        state2, stdout2, records = run_cli(args + ["--epochs", "1"], loader, val_loader)
    torch.cuda.synchronize()
    launches = all_counts()
    steps = state2.step
    train_launches = {k: v - evals["launches"][k] for k, v in launches.items()}
    per_step = {k: v / steps for k, v in train_launches.items()}
    per_val = {k: evals["launches"][k] / evals["images"] for k in launches}
    want_resume = f"resumed from {os.path.join(exp, f'ckpt_{steps_first}.pt')} at step {steps_first}"
    losses = [r[k] for r in records for k in ("g_total", "d_total") if k in r]
    val = [(r["step"], r["val_psnr"], r["val_ssim"]) for r in records if "val_psnr" in r]
    best_path = os.path.join(exp, "netG_best.pth")
    with open(best_path + ".json") as f:
        best = json.load(f)
    engine = InferenceEngine(load_generator(best_path, device="cuda"), device="cuda", precision="bf16")
    served = engine.predict(val_pairs[0][0])
    out.update(steps=[steps_first, steps], launches=launches, launches_per_step=per_step,
               launches_per_val_image=per_val, evals=evals["calls"], val=val, best=best,
               save_ms=io_ms["save"], load_ms=io_ms["load"], ckpt_mb=io_ms["mb"],
               resumed_equals_file=io_ms["resumed_equals_file"],
               imgs_per_sec=[r["imgs_per_sec"] for r in records if "imgs_per_sec" in r])
    log(f"train cli 8x256^2 bf16 pool 50: steps {steps_first} + {steps - steps_first}, launches per step "
        f"{per_step}, per val image {per_val}; save {io_ms['save']} ms, load {io_ms['load']} ms, "
        f"{io_ms['mb']:.1f} MB; best {best}; val (step, PSNR, SSIM) {val}")
    checks = {
        "resumed": want_resume in stdout2 and io_ms["resumed_equals_file"] == [True],
        "finite": bool(losses) and bool(np.isfinite(losses).all()) and np.isfinite([v[1:] for v in val]).all(),
        "per_step": per_step == REMAT_LAUNCHES["none"],
        "per_val": per_val == {"k1": 42, "k2": 42, "k3": 0, "channel_stats": 0},
        "best_serves": served.shape == val_pairs[0][0].shape and bool(np.isfinite(served).all()),
        "checkpoints": sorted(os.listdir(exp)) == sorted([f"ckpt_{steps_first // 2}.pt", f"ckpt_{steps_first}.pt",
                                                          f"ckpt_{steps}.pt", "netG_best.pth",
                                                          "netG_best.pth.json", "train_log.jsonl"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"train cli: failed checks {[k for k, v in checks.items() if not v]}; "
                             f"expected {want_resume!r}")
    del state, state2, engine
    torch.cuda.empty_cache()

    # 2. the loop against the step: 4×256², bf16, no pool, 10 steps, logged every 5: the second window
    b, size, n = LOOP_SHAPE
    loop_pairs = pairs(b * n, size, 2)
    exp = os.path.join(root, "loop")
    _, _, records = run_cli(["--exp", exp, "--precision", "bf16", "--lambdaPerceptual", "0", "--poolSize", "0",
                             "--epochs", "1", "--logEvery", "5", "--batchSize", str(b), "--imageSize", str(size)],
                            DataLoader(loop_pairs, batch_size=b, shuffle=True, seed=0))
    windows = [r["imgs_per_sec"] for r in records if "imgs_per_sec" in r]
    out.update(loop_img_s_windows=windows, loop_img_s=windows[-1], step_img_s=step_img_s,
               loop_over_step=windows[-1] / step_img_s)
    log(f"train cli loop 4x256^2 bf16: {windows[-1]:.2f} img/s (windows {windows}) against phase 5's bare "
        f"step {step_img_s:.2f} img/s: {windows[-1] / step_img_s:.3f}x")

    # 3. the perceptual term: a VGG16 .pth from seed 0 in the reference's names, 6 steps logged every 3
    vgg_path = os.path.join(root, "vgg16_seed0.pth")
    torch.save(VGG16(generator=torch.Generator().manual_seed(0)).state_dict(), vgg_path)
    per = {}
    for name, extra in (("without", ["--lambdaPerceptual", "0"]),
                        ("with", ["--lambdaPerceptual", "1", "--vggWeights", vgg_path])):
        _, _, records = run_cli(["--exp", os.path.join(root, f"perceptual_{name}"), "--precision", "bf16",
                                 "--poolSize", "0", "--epochs", "1", "--logEvery", "3", "--batchSize", str(b),
                                 "--imageSize", str(size)] + extra,
                                DataLoader(loop_pairs[:6 * b], batch_size=b, shuffle=True, seed=0))
        per[name] = {"ms_per_step": 1000.0 * b / records[-1]["imgs_per_sec"],
                     "perceptual": [r.get("g_perceptual") for r in records]}
    if not (per["with"]["perceptual"][-1] is not None and np.isfinite(per["with"]["perceptual"]).all()):
        raise AssertionError(f"the perceptual term did not run: {per}")
    out["perceptual"] = per
    log(f"train cli 4x256^2 bf16 ms per step: without the perceptual term {per['without']['ms_per_step']:.2f}, "
        f"with {per['with']['ms_per_step']:.2f}; perceptual {per['with']['perceptual']}")
    shutil.rmtree(root, ignore_errors=True)

    # 4. remat and accumulation: 2×1024² bf16, one warm step and one timed step each
    b, size = REMAT_SHAPE
    haze, gt = train_batch(b, size, 7)
    weights = LossWeights(perceptual=0.0)
    levers = {}
    for name, kw in REMAT_MODES.items():
        state, tx_g, tx_d = create_train_state(0, device="cuda")
        step = make_train_step(tx_g, tx_d, weights, compute_dtype=torch.bfloat16, **kw)
        step(state, haze, gt)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        t = time.perf_counter()
        _, m = step(state, haze, gt)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t)
        counts = all_counts()
        levers[name] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "peak_above_state_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                        "launches": counts, "g_total": m["g_total"].item()}
        log(f"train {b}x{size}^2 bf16 {name}: {json.dumps(levers[name])}")
        if counts != REMAT_LAUNCHES[name] or not np.isfinite(levers[name]["g_total"]):
            raise AssertionError(f"{name}: launches {counts}, expected {REMAT_LAUNCHES[name]}; "
                                 f"g_total {levers[name]['g_total']}")
        del state, step
        torch.cuda.empty_cache()
    out["levers_2x1024"] = levers
    # what one dense layer's backward holds at block 1's widest input (C = 224) at this size: its twin's
    # fp32 recompute of t, h and g and their VJP, above the layer's inputs and output
    from fdgan_tpu_torch.ops import dense
    from fdgan_tpu_torch.tools.timing import peak_gib

    args = [a.requires_grad_(True) for a in layer_inputs((b, size, size, 224), torch.bfloat16,
                                                          torch.Generator(device="cuda").manual_seed(8))]
    f = dense.fused_dense_layer(*args)
    out["dense_layer_backward_peak_gib"] = peak_gib(lambda: f.backward(torch.ones_like(f)))
    log(f"one dense layer's backward at {b}x{size}^2x224 bf16: peak {out['dense_layer_backward_peak_gib']:.2f} GiB")
    del args, f
    torch.cuda.empty_cache()
    # the remat modes in fp32 (TF32 off) at 2×64²: the same step as without remat
    haze, gt = train_batch(2, 64, 6)
    runs = {}
    with exact_fp32():
        for name in ("none", "remat", "stages"):
            state, tx_g, tx_d = create_train_state(0, device="cuda")
            _, m = make_train_step(tx_g, tx_d, weights, **REMAT_MODES[name])(state, haze, gt)
            runs[name] = (state, {k: v.item() for k, v in m.items()})
    for name in ("remat", "stages"):
        loss_err = max(abs(v - runs["none"][1][k]) / max(abs(runs["none"][1][k]), 1e-6)
                       for k, v in runs[name][1].items())
        off, worst_p, worst_s = compare_states(runs[name][0], runs["none"][0])
        out[f"fp32_{name}_vs_none"] = {"loss_max_rel_err": loss_err, "param_share_over_1e-6": off,
                                       "param_max_abs_err": worst_p, "running_stat_max_abs_err": worst_s}
        log(f"train fp32 2x64^2 {name} vs no remat: {json.dumps(out[f'fp32_{name}_vs_none'])}")
        if not (loss_err <= 1e-4 and off < 5e-3 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5):
            raise AssertionError(f"remat {name} changes the fp32 step")
    del runs
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 8: {out['seconds']:.1f} s")
    return out, train_launches


ZOO_ROOT = "build/zoo"
# the reference's dead members: built, in the state dict, never run (dehaze22.py:665,687; dehaze1113.py:497)
ZOO_DEAD = ("tran_est", "batch1", "batchnorm1")
# (family, B, H): step 3's models, each at batch BN and running BN, fp32 and bf16
ZOO_OTHERS = [("dense", 1, 512), ("dense2", 1, 512), ("unetg", 1, 512), ("unetg2", 1, 512), ("unetg2", 1, 256),
              ("patchd", 4, 256), ("begand", 4, 64)]
# K1 and K2 at densenet_dehaze's first layers of blocks 3 and 4 at 4×512², C = 400 and 456
# (16 and 8 modulo 32), from contiguous x and from the block's concat buffer (ld C0 + 16·32)
ZOO_KERNEL_SHAPES = [(4, 128, 128, 400), (4, 64, 64, 456)]
ZOO_TRAIN = (4, 256)  # the contextual term's step: phase 5's cell
ZOO_CX_STEPS = 20  # steps in each of the term's four timed turns


def zoo_stats_launches(model) -> int:
    """channel_stats launches of one bf16 batch-BN forward of ``model``, from
    its module tree: a dense block reduces its input and each layer's 32 new
    channels (1 + L; norm2's statistics are K2's), every other BatchNorm that
    runs its input once. A BN does not run in a dead member or in a block
    built with use_bn=False."""
    from fdgan_tpu_torch.models.densenet import DenseBlock
    from fdgan_tpu_torch.nn.layers import BatchNorm

    n, blocks = 0, []
    for name, m in model.named_modules():
        if set(name.split(".")) & set(ZOO_DEAD) or any(name.startswith(b) for b in blocks):
            continue
        if isinstance(m, DenseBlock):
            n += 1 + len(list(m.children()))
            blocks.append(name + ".")
        elif isinstance(m, BatchNorm):
            n += int(getattr(model.get_submodule(name.rpartition(".")[0]), "use_bn", True))
    return n


def zoo_model(family, prepare=None):
    """A registry family's model on the card: seed-0 torch-style weights and
    random running statistics, written as the reference's .pth (DataParallel
    prefix, doubled blockUNet keys), converted to a JAX params .msgpack by
    cli.convert.main, loaded from it by cli._common.load_model; the .msgpack
    converted back to a .pth must hold the first .pth's tensors, bit for bit.
    Returns (model, {seconds, MB})."""
    import io
    import os

    import torch

    from fdgan_tpu_torch.cli import convert
    from fdgan_tpu_torch.cli._common import load_model
    from fdgan_tpu_torch.io.torch_import import export_state_dict, model_registry

    t0 = time.perf_counter()
    fam = model_registry()[family]
    model = fam.build(device="cpu", generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    if prepare is not None:
        prepare(model)
    src, mp, back = (os.path.join(ZOO_ROOT, f"{family}{ext}") for ext in (".pth", ".msgpack", "_back.pth"))
    torch.save(export_state_dict(model.state_dict(), "module.", fam.duplicated), src)
    with contextlib.redirect_stdout(io.StringIO()):
        convert.main(["--src", src, "--dst", mp, "--model", family])
        convert.main(["--src", mp, "--dst", back, "--model", family])
    a, b = torch.load(src, weights_only=True), torch.load(back, weights_only=True)
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError(f"{family}: .pth -> .msgpack -> .pth changed the tensors")
    loaded = load_model(mp, family, device="cuda")
    live = model.state_dict()
    if not all(torch.equal(v.cpu(), live[k]) for k, v in loaded.state_dict().items()):
        raise AssertionError(f"{family}: the model loaded from the .msgpack differs from the one written")
    return loaded, {"seconds": time.perf_counter() - t0, "msgpack_mb": os.path.getsize(mp) / 1e6}


def zoo_forward(model, x, mode, impl, stats_out=None):
    """The model's outputs as a tuple (BeganD has no BN and no impl)."""
    from fdgan_tpu_torch.models.discriminators import BeganD

    y = model(x) if isinstance(model, BeganD) else model(x, bn_mode=mode, impl=impl, stats_out=stats_out)
    return y if isinstance(y, tuple) else (y,)


@contextlib.contextmanager
def checked_channel_stats(record):
    """Every channel_stats launch of a forward inside the block, held against
    its twin on the same input at STATS_MEAN_TOL / STATS_VAR_TOL (as
    tests/test_torch_cuda.py::test_channel_stats_matches_twin): the dense
    blocks' segments (ops.dense) and every other BN's input through
    nn.layers.batch_stats, the zero-padding of a C that is not a multiple of
    8 included. The twins launch nothing. ``record`` gets the number of
    launches checked, the worst errors and the shapes seen."""
    import torch

    from fdgan_tpu_torch.nn import layers
    from fdgan_tpu_torch.ops import dense, stats

    record.update(calls=0, mean_max_abs_err=0.0, var_max_abs_err=0.0, shapes=set())

    def hold(x_nhwc, got, want):
        (m, v), (mr, vr) = got, want
        record["calls"] += 1
        record["shapes"].add(tuple(x_nhwc.shape))
        record["mean_max_abs_err"] = max(record["mean_max_abs_err"], (m - mr).abs().max().item())
        record["var_max_abs_err"] = max(record["var_max_abs_err"], (v - vr).abs().max().item())
        if not (torch.allclose(m, mr, **STATS_MEAN_TOL) and torch.allclose(v, vr, **STATS_VAR_TOL)):
            raise AssertionError(f"channel_stats disagrees with its twin at {tuple(x_nhwc.shape)}: mean "
                                 f"{(m - mr).abs().max().item():.3e}, var {(v - vr).abs().max().item():.3e}")

    def wrap_batch_stats(orig):
        def batch_stats(x, impl="kernels"):
            got = orig(x, impl)
            if impl == "kernels" and x.dtype == torch.bfloat16:
                hold(x.permute(0, 2, 3, 1), got, orig(x, "plain"))
            return got
        return batch_stats

    def wrap_channel_stats(orig):
        def channel_stats(x):
            got = orig(x)
            if x.dtype == torch.bfloat16:
                hold(x, got, stats.one_pass_reference(x))
            return got
        return channel_stats

    with patched(layers, "batch_stats", wrap_batch_stats), patched(dense, "channel_stats", wrap_channel_stats):
        yield


def zoo_check(name, model, shape, k1, totals, seed=0):
    """One model at ``shape`` under inference_mode: fp32 (TF32 off) kernels
    against plain within GEN_TOL for every output, in batch and running BN;
    bf16 PSNR of the first output against fp32 plain, no more than 1 dB
    below the plain bf16 path's; the launches of each kernel-path forward
    exactly K1 ``k1``, K2 ``k1`` in batch BN and 0 in running BN, and
    channel_stats ``zoo_stats_launches`` in bf16 batch BN, 0 otherwise. In
    bf16 batch BN every channel_stats launch is held against its twin on
    its own input (``checked_channel_stats``), and both paths record the
    statistics of the same BNs (``stats_out`` keys). Adds each forward's
    launches to ``totals``."""
    import torch

    b, h = shape
    x = torch.from_numpy(np.random.default_rng(seed).uniform(size=(b, h, h, 3)).astype(np.float32)).cuda()
    n_stats = zoo_stats_launches(model)
    out, ref32 = {"shape": [b, h, h, 3]}, {}

    def counted(fwd):
        before = all_counts()
        y = fwd()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in all_counts().items()}
        totals.update(got)
        return y, got

    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            for mode in ("batch", "running"):
                watch = dtype == torch.bfloat16 and mode == "batch"
                held, st_k, st_p = {}, {}, {}
                with exact_fp32() if dtype == torch.float32 else contextlib.nullcontext():
                    with checked_channel_stats(held) if watch else contextlib.nullcontext():
                        y_k, got = counted(lambda: zoo_forward(model, xd, mode, "kernels", st_k))
                    y_p = zoo_forward(model, xd, mode, "plain", st_p)
                if watch:
                    if held["calls"] != n_stats or st_k.keys() != st_p.keys():
                        raise AssertionError(f"{name} bf16 batch: {held['calls']} channel_stats launches checked "
                                             f"of {n_stats}; stats_out keys equal {st_k.keys() == st_p.keys()}")
                    held["shapes"] = sorted(held["shapes"], key=lambda t: (t[1] * t[2], t[3]))[:4]
                    out["bf16_batch_channel_stats_vs_twin"] = held | {"bn_keys": len(st_k)}
                want = {"k1": k1, "k2": k1 if mode == "batch" else 0, "k3": 0,
                        "channel_stats": n_stats if (dtype == torch.bfloat16 and mode == "batch") else 0}
                if got != want:
                    raise AssertionError(f"{name} {dtype} {mode}: launches per forward {got}, expected {want}")
                if not all(bool(torch.isfinite(t).all()) for t in y_k):
                    raise AssertionError(f"{name} {dtype} {mode}: non-finite output")
                tag = f"{'fp32' if dtype == torch.float32 else 'bf16'}_{mode}"
                if dtype == torch.float32:
                    errs = [(a - p).abs().max().item() for a, p in zip(y_k, y_p)]
                    ok = all(torch.allclose(a, p, **GEN_TOL) for a, p in zip(y_k, y_p))
                    out[f"{tag}_max_abs_err"] = errs
                    ref32[mode] = y_p[0]
                    if not ok:
                        raise AssertionError(f"{name} fp32 {mode}: kernels vs plain max_abs_err {errs}")
                else:
                    p_k, p_p = psnr(y_k[0].float(), ref32[mode]), psnr(y_p[0].float(), ref32[mode])
                    out[f"{tag}_psnr_db"] = [p_k, p_p]
                    if not p_k >= p_p - 1.0:
                        raise AssertionError(f"{name} bf16 {mode}: kernels {p_k:.2f} dB, plain {p_p:.2f} dB")
                out[f"{tag}_launches"] = got
                del y_k, y_p
    log(f"zoo {name} {b}x{h}^2: {json.dumps(out)}")
    return out


def zoo_turns(model, shape, seed=0):
    """ms per bf16 batch-BN forward of the model in bf16 (as cli/demo
    --precision bf16 loads one), in turns (kernels, plain, plain, kernels;
    CUDA events, 10 forwards after 2), and the kernel path's peak memory."""
    import copy

    import torch

    from fdgan_tpu_torch.tools.timing import peak_gib

    model = copy.deepcopy(model).to(torch.bfloat16)
    b, h = shape
    x = torch.from_numpy(np.random.default_rng(seed).uniform(size=(b, h, h, 3)).astype(np.float32)).cuda().bfloat16()
    times = {"kernels": [], "plain": []}
    with torch.inference_mode():
        for impl in ("kernels", "plain", "plain", "kernels"):
            times[impl].append(cuda_ms(lambda: zoo_forward(model, x, "batch", impl)))
        peak = peak_gib(lambda: zoo_forward(model, x, "batch", "kernels"))
    torch.cuda.empty_cache()
    return {"bf16_batch_ms": {k: sum(v) / len(v) for k, v in times.items()}, "bf16_batch_turns_ms": times,
            "bf16_batch_peak_gib": peak}


def zoo_kernels_at_ragged_c():
    """K1 and K2 against their twins at C = 400 and 456, fp32 (TF32 off) and
    bf16, from contiguous x and from the concat buffer's channel slice (the
    same bits), with their times and bounds at bf16."""
    import torch

    from fdgan_tpu_torch.ops import dense
    from fdgan_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for shape in ZOO_KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, a1, b1, w1, a2, b2, w2 = layer_inputs(shape, dtype, gen)
            xv, fv = buffer_view(x, shape[-1] + 16 * 32)
            with exact_fp32():
                f_k = dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2)
                f_p = dense.layer_reference(x, a1, b1, w1, a2, b2, w2)
                m_k, v_k = dense.h_batch_stats(x, a1, b1, w1)
                m_p, v_p = dense.h_stats_reference(x, a1, b1, w1)
                with torch.inference_mode():
                    dense.fused_dense_layer(xv, a1, b1, w1, a2, b2, w2, out=fv)
                m_v, v_v = dense.h_batch_stats(xv, a1, b1, w1)
            torch.cuda.synchronize()
            tol = K1_TOL_F32 if dtype == torch.float32 else K1_TOL_BF16
            e1 = (f_k.float() - f_p.float()).abs().max().item()
            e2 = max((m_k - m_p).abs().max().item(), (v_k - v_p).abs().max().item())
            ok = (torch.allclose(f_k.float(), f_p.float(), **tol) and torch.allclose(m_k, m_p, **K2_MEAN_TOL)
                  and torch.allclose(v_k, v_p, **K2_VAR_TOL))
            same = torch.equal(fv, f_k) and torch.equal(m_v, m_k) and torch.equal(v_v, v_k)
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "ld": xv.stride(2),
                   "k1_max_abs_err": e1, "k2_max_abs_err": e2, "view_same_bits": same}
            if dtype == torch.bfloat16:
                row.update(dense_bounds(x, a1, b1, w1, a2, b2, w2))
                row.update({"k1_ms": cuda_ms(lambda: dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2)),
                            "k1_plain_ms": cuda_ms(lambda: dense.layer_reference(x, a1, b1, w1, a2, b2, w2)),
                            "k2_ms": cuda_ms(lambda: dense.h_batch_stats(x, a1, b1, w1)),
                            "k2_plain_ms": cuda_ms(lambda: dense.h_stats_reference(x, a1, b1, w1)),
                            "k2_device_ms": device_ms(lambda: dense.h_batch_stats(x, a1, b1, w1))})
                with torch.inference_mode():
                    row["k1_device_ms"] = device_ms(lambda: dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2))
            rows.append(row)
            log(json.dumps({"zoo_kernel": row}))
            if not (ok and same):
                raise AssertionError(f"K1/K2 disagree at {shape} {dtype}: ok={ok} err K1 {e1} K2 {e2}, "
                                     f"buffer view same bits {same}")
    return rows


def zoo_remat_grads(model):
    """densenet_dehaze's gradients with remat (a non-reentrant checkpoint per
    dense block and transition) against without, fp32 (TF32 off), 2×64²,
    batch BN, at phase 5's gradient tolerance (atol 1e-5, rtol 1e-4)."""
    import torch

    x = torch.from_numpy(np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)).cuda()
    grads = {}
    with exact_fp32():
        for remat in (False, True):
            model.zero_grad(set_to_none=True)
            model(x, bn_mode="batch", remat=remat).square().mean().backward()
            grads[remat] = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    model.zero_grad(set_to_none=True)
    err = max((a - b).abs().max().item() for a, b in zip(grads[True], grads[False]))
    ok = len(grads[True]) == len(grads[False]) and all(
        torch.allclose(a, b, atol=1e-5, rtol=1e-4) for a, b in zip(grads[True], grads[False]))
    log(f"zoo densenet_dehaze remat vs none, fp32 2x64^2 gradients: max_abs_err {err:.3e} ok={ok}")
    if not ok:
        raise AssertionError("densenet_dehaze's remat changes its gradients")
    return err


def zoo_contextual(totals):
    """The contextual term: the bf16 train step at 4×256² with a seed-0
    VGG16 .pth, without and with --lambdaCX 1 in turns (without, with, with,
    without; ZOO_CX_STEPS steps each after a warm one), launches per step as
    phase 5's;
    one fp32 2×64² step with the term, kernels against plain at phase 5's
    criteria; then cli.train.train with --lambdaCX 1 at the CLI's defaults
    (8×256², --poolSize 50, bf16) for one epoch of 2 batches."""
    import os

    import torch

    from fdgan_tpu_torch.data.h5 import DataLoader
    from fdgan_tpu_torch.io.torch_import import load_vgg16
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.models.vgg16 import VGG16
    from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

    vgg_path = os.path.join(ZOO_ROOT, "vgg16.pth")
    torch.save(VGG16(generator=torch.Generator().manual_seed(0)).state_dict(), vgg_path)
    vgg = load_vgg16(vgg_path, device="cuda")
    b, size = ZOO_TRAIN
    haze, gt = train_batch(b, size, 300)
    runs = {}
    for name, weights in (("without", LossWeights(perceptual=0.0)),
                          ("with", LossWeights(perceptual=0.0, contextual=1.0))):
        state, tx_g, tx_d = create_train_state(0, device="cuda")
        step = make_train_step(tx_g, tx_d, weights, vgg, compute_dtype=torch.bfloat16)
        step(state, haze, gt)
        runs[name] = {"state": state, "step": step, "ms": [], "metrics": None}
    torch.cuda.synchronize()
    for name in ("without", "with", "with", "without"):
        r = runs[name]
        before = all_counts()
        t0 = time.perf_counter()
        for _ in range(ZOO_CX_STEPS):
            _, r["metrics"] = r["step"](r["state"], haze, gt)
        torch.cuda.synchronize()
        r["ms"].append(1000 * (time.perf_counter() - t0) / ZOO_CX_STEPS)
        diff = {k: v - before[k] for k, v in all_counts().items()}
        totals.update(diff)
        got = {k: v / ZOO_CX_STEPS for k, v in diff.items()}
        if got != REMAT_LAUNCHES["none"]:
            raise AssertionError(f"contextual step ({name}): launches per step {got}")
    out = {name: {"ms_per_step": sum(r["ms"]) / 2, "turns_ms": r["ms"],
                  "losses": {k: v.item() for k, v in r["metrics"].items()}} for name, r in runs.items()}
    if not (np.isfinite(list(out["with"]["losses"].values())).all() and out["with"]["losses"]["g_contextual"] > 0):
        raise AssertionError(f"the contextual step's losses: {out['with']['losses']}")
    log(f"zoo contextual term 4x256^2 bf16 ms per step: without {out['without']['ms_per_step']:.2f}, with "
        f"{out['with']['ms_per_step']:.2f}; g_contextual {out['with']['losses']['g_contextual']:.4f}")
    del runs
    torch.cuda.empty_cache()
    before = all_counts()
    out["fp32"] = phase_train_fp32(LossWeights(perceptual=0.0, contextual=1.0), vgg, " with --lambdaCX 1")
    totals.update({k: v - before[k] for k, v in all_counts().items()})
    # the CLI at its defaults with --lambdaCX 1: 2 batches of 8×256², the pool of 50
    exp = os.path.join(ZOO_ROOT, "cli_cx")
    c = CLI_TRAIN
    before = all_counts()
    _, _, records = run_cli(["--exp", exp, "--precision", "bf16", "--lambdaCX", "1", "--vggWeights", vgg_path,
                             "--epochs", "1", "--logEvery", "1", "--batchSize", str(c["batch"]),
                             "--imageSize", str(c["size"])],
                            DataLoader(pairs(2 * c["batch"], c["size"], 5), batch_size=c["batch"], shuffle=True, seed=0))
    got = {k: v - before[k] for k, v in all_counts().items()}
    totals.update(got)
    steps = [r for r in records if "g_total" in r]
    cx = [r.get("g_contextual") for r in steps]
    out["cli"] = {"steps": len(steps), "g_contextual": cx, "imgs_per_sec": [r["imgs_per_sec"] for r in steps],
                  "launches": got}
    log(f"zoo cli.train --lambdaCX 1 (8x256^2 bf16, --poolSize 50): {json.dumps(out['cli'])}")
    if len(steps) != 2 or None in cx or not np.isfinite(cx).all() or got != {k: 2 * v for k, v in
                                                                            REMAT_LAUNCHES["none"].items()}:
        raise AssertionError(f"cli.train --lambdaCX 1: {out['cli']}")
    return out


def phase_zoo():
    """Phase 9: the model zoo behind cli/convert on the card. Returns the
    phase's numbers and the launches of its path (every counted forward and
    step above; the kernel checks at C = 400 and 456 come after)."""
    import os
    import shutil

    import torch

    t0 = time.perf_counter()
    shutil.rmtree(ZOO_ROOT, ignore_errors=True)
    os.makedirs(ZOO_ROOT)
    totals = collections.Counter({k: 0 for k in all_counts()})
    out = {"models": {}}

    def transmission_in_range(m):
        # J = (I − A)/(|t| + 1e-10) + A: at random weights t crosses 0, where the division turns fp32
        # rounding into any difference at all; a bias of 1 puts t = tanh(·) in the transmission's range
        with torch.no_grad():
            m.tran_dense.refine3.bias.fill_(1.0)

    # 1. DCPDN's full generator at 512², batch 1 and 4
    model, io_info = zoo_model("dehaze", transmission_in_range)
    out["models"]["dehaze"] = {"convert": io_info}
    for b in (1, 4):
        out["models"]["dehaze"][f"b{b}"] = zoo_check("dehaze", model, (b, 512), 42, totals)
    timed = zoo_turns(model, (4, 512))
    out["models"]["dehaze"].update(timed)
    log(f"zoo dehaze 4x512^2 bf16 batch BN: {json.dumps(timed)}")
    del model
    torch.cuda.empty_cache()
    # 2. densenet_dehaze at 4×512² (no registry family: seed-0 weights made here)
    from fdgan_tpu_torch.models.densenet_dehaze import DenseNetDehaze

    model = DenseNetDehaze(device="cuda", generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    out["models"]["densenet_dehaze"] = {"b4": zoo_check("densenet_dehaze", model, (4, 512), 64, totals)}
    timed = zoo_turns(model, (4, 512))
    out["models"]["densenet_dehaze"].update(timed)
    log(f"zoo densenet_dehaze 4x512^2 bf16 batch BN: {json.dumps(timed)}")
    before = all_counts()
    out["densenet_dehaze_remat_grad_max_abs_err"] = zoo_remat_grads(model)
    totals.update({k: v - before[k] for k, v in all_counts().items()})
    del model
    torch.cuda.empty_cache()
    # 3. the other families
    for family, b, h in ZOO_OTHERS:
        model, io_info = zoo_model(family)
        k1 = 42 if family in ("dense", "dense2") else 0
        out["models"][f"{family}_{b}x{h}"] = {"convert": io_info,
                                              "check": zoo_check(family, model, (b, h), k1, totals)}
        del model
        torch.cuda.empty_cache()
    # 4. the contextual term
    out["contextual"] = zoo_contextual(totals)
    launches = dict(totals)
    log(f"zoo path launches {launches}")
    # K1 and K2 at the C the path gave them that no earlier phase did
    out["kernels_ragged_c"] = zoo_kernels_at_ragged_c()
    shutil.rmtree(ZOO_ROOT, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9: {out['seconds']:.1f} s")
    return out, launches


DP_TURN_STEPS = 5  # (a): steps per turn of the bare and the data-parallel step, 4×256² bf16, two turns each
DP_FP32 = (2, 64)  # (a)'s bit-for-bit step and (b)'s global batch: phase 5's fp32 step, one row per rank in (b)
DP_RUNS = {"fp32": "float32", "fp32_remat": "float32", "bf16": "bfloat16",  # (b): tools.dp_step's RUNS
           "bf16_local_stats": "bfloat16"}  # the negative control: per-rank statistics, which must fail bf16's gate
# (b)'s bf16 gate on the gradients handed to Adam (G's and D's, each relative L2 against one fp32 process's on
# the whole batch): the data-parallel step's error no more than DP_BF16_GRAD_FACTOR times one bf16 process's
DP_BF16_GRAD_FACTOR = 1.1  # on the H100, two ranks read 0.997× (G) and 0.980× (D), per-rank statistics 1.32×, 1.24×
DP_CLI = dict(batch=8, size=256, batches=2)  # (c): the CLI's defaults, one epoch of 2 batches
DP_TIMEOUT = 300  # seconds for (b)'s two ranks; a rank that hangs fails the phase
DP_TIMED_STEPS = 10  # --dp-ranks: bf16 steps a side, data-parallel and bare, at TRAIN_SHAPE a rank
# statistics combined over the ranks in one step's forwards: G's 3 block inputs, 42 new slices, 42 K2
# outputs; D's 3 BNs in each of its 3 forwards; each with its all-reduce in the backward. Remat recomputes
# the 42 K2 outputs, and combines them again, in the backward
DP_COLLECTIVES = {"fp32": {"forward": 96, "backward": 96, "grads": 2, "metrics": 2},
                  "fp32_remat": {"forward": 138, "backward": 96, "grads": 2, "metrics": 2},
                  "bf16": {"forward": 96, "backward": 96, "grads": 2, "metrics": 2},
                  "bf16_local_stats": {"forward": 0, "backward": 0, "grads": 2, "metrics": 2}}


def dist_counts():
    from fdgan_tpu_torch.dist import mesh
    from fdgan_tpu_torch.dist import stats as dist_stats

    return dict(dist_stats.collectives) | dict(mesh.counts)


def reset_dist_counts():
    from fdgan_tpu_torch.dist import mesh
    from fdgan_tpu_torch.dist import stats as dist_stats

    dist_stats.reset_counts()
    mesh.reset_counts()


def same_train_state(a, b) -> bool:
    """G, D, both Adams and the counts, bit for bit."""
    import torch

    same = (a.step, a.d_updates) == (b.step, b.d_updates)
    for net in ("g", "d"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        same &= all(torch.equal(v, sb[k]) for k, v in sa.items())
        oa, ob = getattr(a, f"{net}_opt").state_dict()["state"], getattr(b, f"{net}_opt").state_dict()["state"]
        same &= oa.keys() == ob.keys() and all(torch.equal(v, ob[i][k]) for i, e in oa.items() for k, v in e.items())
    return bool(same)


def run_ranks(blob_path, out_dir, nprocs, backend, timed_steps=0):
    """``python -m fdgan_tpu_torch.tools.dp_step`` as each of ``nprocs``
    ranks over ``backend``, under DP_TIMEOUT; returns each rank's output."""
    import os

    import torch

    from fdgan_tpu_torch.dist import mesh

    try:
        mesh.run_local_ranks(lambda pid: [
            sys.executable, "-m", "fdgan_tpu_torch.tools.dp_step", "--input", blob_path,
            "--out", os.path.join(out_dir, f"rank{pid}.pt"), "--device", "cuda", "--backend", backend,
            "--time", str(timed_steps)], nprocs, DP_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        raise AssertionError(f"dp: {e}")
    return [torch.load(os.path.join(out_dir, f"rank{pid}.pt"), weights_only=True) for pid in range(nprocs)]


def phase_dp():
    """Phase 10: the data-parallel train step (``FDGAN_TPU_DIST``) on the
    card. (a) World size 1 over NCCL, joined through
    ``dist.mesh.maybe_init_distributed`` with explicit coordinates: the
    data-parallel step at 4×256² bf16 in turns with phase 5's bare step
    (bare, dp, dp, bare), its launches per step (phase 5's) and its
    collectives (none); one fp32 2×64² step equal bit for bit to the step
    without a group. (c) ``cli.train.train`` in that group, one epoch of 2
    batches at the CLI's defaults: process 0's log and checkpoint; then the
    state written as a JAX ``TrainState`` (``save_jax_checkpoint``), from
    which the CLI resumes, its loaded state bit for bit the file's. (b) Two
    ranks on this one card over gloo (NCCL takes one rank per device), each
    a process of ``tools.dp_step`` on one row of a 2×64² batch through the
    kernels: fp32, fp32 with remat, bf16, and bf16 with per-rank statistics
    (the control). fp32 against the single-process kernel step on the whole
    batch at phase 5's criteria, and the step's generator output within
    GEN_TOL; bf16 against the fp32 step, measured by the single-process bf16
    step: the PSNR of the step's generator output no more than 1 dB below,
    the gradients handed to Adam within DP_BF16_GRAD_FACTOR of its error;
    the control must fail that bf16 gate; every rank's launches and
    collectives exact. Returns the phase's numbers and the path's launches
    by dtype (bf16, fp32)."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from fdgan_tpu_torch.cli import train as cli
    from fdgan_tpu_torch.data.h5 import DataLoader
    from fdgan_tpu_torch.dist import mesh
    from fdgan_tpu_torch.io.checkpoint import jax_train_state_leaves, save_jax_checkpoint
    from fdgan_tpu_torch.io.msgpack import unpack_leaves
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import Transform, create_train_state, make_train_step

    t0 = time.perf_counter()
    root = os.path.join("build", "dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    weights = LossWeights(perceptual=0.0)
    launches = {"bf16": collections.Counter(), "fp32": collections.Counter()}
    out = {}

    def counted(dtype, fn):
        before = all_counts()
        res = fn()
        torch.cuda.synchronize()
        launches[dtype].update({k: v - before[k] for k, v in all_counts().items()})
        return res

    env = {"FDGAN_TPU_DIST": "1", "FDGAN_TPU_DIST_COORD": f"localhost:{mesh.free_port()}",
           "FDGAN_TPU_DIST_NPROCS": "1", "FDGAN_TPU_DIST_PID": "0"}
    os.environ.update(env)
    try:
        mesh.maybe_init_distributed("cuda")
        if not (dist.is_initialized() and dist.get_backend() == "nccl" and mesh.world_size() == 1):
            raise AssertionError("dp: maybe_init_distributed did not join a one-rank NCCL group")
        group = mesh.process_group()

        # (a) the data-parallel step at world size 1 against the bare step, bf16 4×256², in turns
        b, size, _ = TRAIN_SHAPE
        batches = [train_batch(b, size, 100 + i) for i in range(2 * DP_TURN_STEPS)]
        runs = {}
        for name, grp in (("bare", None), ("dp", group)):
            state, tx_g, tx_d = create_train_state(0, device="cuda")
            step = make_train_step(tx_g, tx_d, weights, compute_dtype=torch.bfloat16, group=grp)
            step(state, *batches[0])  # warm-up
            runs[name] = {"state": state, "step": step, "seconds": 0.0, "steps": 0}
        torch.cuda.synchronize()
        dp_launches = collections.Counter()
        reset_dist_counts()
        for name in ("bare", "dp", "dp", "bare"):
            r = runs[name]
            before = all_counts()
            t = time.perf_counter()
            for i in range(DP_TURN_STEPS):
                r["step"](r["state"], *batches[r["steps"] + i])
            torch.cuda.synchronize()
            r["seconds"] += time.perf_counter() - t
            r["steps"] += DP_TURN_STEPS
            if name == "dp":
                dp_launches.update({k: v - before[k] for k, v in all_counts().items()})
        launches["bf16"].update(dp_launches)
        collectives_world1 = dist_counts()
        per_step = {k: v / runs["dp"]["steps"] for k, v in dp_launches.items()}
        ms = {name: 1000 * r["seconds"] / r["steps"] for name, r in runs.items()}
        out["world1_bf16_4x256"] = {"ms_per_step": ms["dp"], "bare_ms_per_step": ms["bare"],
                                    "dp_over_bare": ms["dp"] / ms["bare"], "launches_per_step": per_step,
                                    "collectives": collectives_world1}
        log(f"dp world 1 (nccl) bf16 {b}x{size}^2: {json.dumps(out['world1_bf16_4x256'])}")
        if per_step != REMAT_LAUNCHES["none"] or any(collectives_world1.values()):
            raise AssertionError(f"dp world 1: launches per step {per_step} (expected {REMAT_LAUNCHES['none']}), "
                                 f"collectives {collectives_world1} (expected none)")
        del runs, batches
        torch.cuda.empty_cache()

        # (a) one fp32 step in the group of one against the step without a group: the same bits. Two steps
        # without a group differ in G's gradients run to run unless torch takes its deterministic
        # implementations (PERF.md §6): the comparison runs under them, and holds the step without a
        # group against itself too
        haze, gt = train_batch(*DP_FP32, 6)
        states = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with exact_fp32(), torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for name, grp in (("single", None), ("dp", group), ("single_again", None)):
                    state, tx_g, tx_d = create_train_state(0, device="cuda")
                    step = make_train_step(tx_g, tx_d, weights, group=grp)
                    _, m = counted("fp32", lambda: step(state, haze, gt)) if name == "dp" else step(state, haze, gt)
                    states[name] = (state, m)
        finally:
            torch.use_deterministic_algorithms(False)
        single, single_metrics = states["single"]
        bits = {name: same_train_state(st, single) and all(torch.equal(v, single_metrics[k]) for k, v in m.items())
                for name, (st, m) in states.items() if name != "single"}
        out["world1_fp32_bit_for_bit"] = bits
        out["world1_fp32_nondeterministic_ops"] = sorted({str(w.message)[:200] for w in caught})
        log(f"dp world 1 fp32 {DP_FP32[0]}x{DP_FP32[1]}^2 bit for bit against the step without a group: {bits}; "
            f"warnings {out['world1_fp32_nondeterministic_ops']}")
        if not all(bits.values()):
            raise AssertionError(f"dp world 1: the fp32 step differs from the step without a group ({bits})")
        del states, single

        # (c) cli.train.train in the group of one: 2 steps, then a resume from the state as a JAX TrainState
        c = DP_CLI
        cli_pairs = pairs(c["batch"] * c["batches"], c["size"], 3)
        exp, exp_jax = os.path.join(root, "cli"), os.path.join(root, "cli_jax")
        args = ["--precision", "bf16", "--lambdaPerceptual", "0", "--logEvery", "1", "--batchSize", str(c["batch"]),
                "--imageSize", str(c["size"]), "--epochs", "1"]
        resumed = []

        def check_load(orig):
            def wrapped(path, state, tx_g, tx_d):
                res = orig(path, state, tx_g, tx_d)
                with open(path, "rb") as f:
                    file = unpack_leaves(f.read())
                live = jax_train_state_leaves(state, tx_g, tx_d)
                resumed.append(len(file) == len(live) and all(
                    torch.equal(t.detach().cpu().contiguous(), leaf) for (_, t), leaf in zip(live, file)))
                return res
            return wrapped

        state, _, records = counted("bf16", lambda: run_cli(
            ["--exp", exp] + args, DataLoader(cli_pairs, batch_size=c["batch"], shuffle=True, seed=0)))
        written = sorted(os.listdir(exp))
        jax_file = save_jax_checkpoint(exp_jax, state, Transform(lambda count: 2e-4), Transform(lambda count: 2e-4),
                                       step=state.step)
        with patched(cli, "load_jax_checkpoint", check_load):
            state2, stdout2, records2 = counted("bf16", lambda: run_cli(
                ["--exp", exp_jax] + args, DataLoader(cli_pairs, batch_size=c["batch"], shuffle=True, seed=0)))
        steps = [r["step"] for r in records if "g_total" in r] + [r["step"] for r in records2 if "g_total" in r]
        out["cli"] = {"steps": steps, "written": written, "jax_file_mb": os.path.getsize(jax_file) / 1e6,
                      "resumed_equals_file": resumed, "imgs_per_sec": [r["imgs_per_sec"] for r in records + records2
                                                                        if "imgs_per_sec" in r]}
        log(f"dp world 1 cli.train 8x256^2 bf16: {json.dumps(out['cli'])}")
        want_resume = f"resumed from {jax_file} at step {c['batches']}"
        if not (written == ["ckpt_2.pt", "train_log.jsonl"] and steps == [1, 2, 3, 4] and resumed == [True]
                and want_resume in stdout2 and state2.step == 2 * c["batches"]):
            raise AssertionError(f"dp world 1 cli.train: {out['cli']}; expected {want_resume!r}")
        del state, state2
    finally:
        for k in env:
            os.environ.pop(k, None)
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on this card over gloo, one row each, against the single-process kernel step
    out["two_ranks"], rank_launches, _ = phase_dp_ranks(2, "gloo", root)
    for dtype, counts in rank_launches.items():
        launches[dtype].update(counts)
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: dict(v) for k, v in launches.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 10: {out['seconds']:.1f} s")
    return out, launches


def phase_dp_ranks(nprocs: int, backend: str, root: str, timed_steps: int = 0):
    """``nprocs`` ranks of ``tools.dp_step`` over ``backend`` (on one card
    each where there are as many, else all on this one), each on one row of
    an nprocs×64² batch, against one process's kernel step on the whole
    batch (``tools.dp_step.run_step`` without a group): fp32 and fp32 with
    remat at phase 5's criteria and the step's generator output within
    GEN_TOL; bf16 by the PSNR criterion on the step's generator output and
    by the gradients handed to Adam (DP_BF16_GRAD_FACTOR), both against the
    fp32 process's and measured by one bf16 process's; the control with
    per-rank statistics must fail that bf16 gate; every rank's launches and
    collectives exact. With ``timed_steps``, each rank then times that many
    bf16 steps at 4×256² a rank, data-parallel against the bare step, in
    turns, and profiles one of each. Returns (the checks per run, the
    launches by dtype, each rank's times)."""
    import os

    import torch

    from fdgan_tpu_torch.tools import dp_step

    launches = {"bf16": collections.Counter(), "fp32": collections.Counter()}
    haze, gt = train_batch(nprocs, DP_FP32[1], 6, device="cpu")
    blob = {"haze": haze, "gt": gt}
    if timed_steps:
        b, size, _ = TRAIN_SHAPE
        blob["timed_haze"], blob["timed_gt"] = train_batch(nprocs * b, size, 100, device="cpu")
    path = os.path.join(root, "batch.pt")
    torch.save(blob, path)
    ranks = run_ranks(path, root, nprocs, backend, timed_steps)
    if timed_steps:  # before the checks, which may fail
        log(f"dp {nprocs} ranks ({backend}) bf16 {TRAIN_SHAPE[0]}x{TRAIN_SHAPE[1]}^2 a rank, timed: "
            f"{json.dumps([rk['timed'] for rk in ranks])}")
    # one process on the whole batch: the step's state, metrics, generator output and gradients
    refs = {dtype: dp_step.run_step(blob, "cuda", compute_dtype=getattr(torch, dtype))
            for dtype in ("float32", "bfloat16")}
    ref = refs["float32"]

    def grad_err(grads, net):  # relative L2 over all of a net's gradients, against the fp32 process's
        want = torch.cat([v.double().flatten() for _, v in sorted(ref["grads"][net].items())])
        got = torch.cat([grads[net][k].double().flatten() for k, _ in sorted(ref["grads"][net].items())])
        return ((got - want).norm() / want.norm()).item()

    bf16_single = {"psnr": psnr(refs["bfloat16"]["x_hat"], ref["x_hat"]),
                   "grad_err": {net: grad_err(refs["bfloat16"]["grads"], net) for net in ("g", "d")}}
    checks = {}
    for run, dtype in DP_RUNS.items():
        rs = [rk["runs"][run] for rk in ranks]
        r0 = rs[0]
        out_dp = torch.cat([r["x_hat"] for r in rs])  # the step's generator output, rank by rank
        res = {"grad_rel_l2_err": {net: grad_err(r0["grads"], net) for net in ("g", "d")}}
        if dtype == "float32":
            loss_err = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-6) for k, v in ref["metrics"].items())
            off = n = 0
            worst_p = worst_s = 0.0
            for net in ("g", "d"):
                for k, v in r0[net].items():
                    diff = (v - ref[net][k]).abs()
                    if "running" in k:
                        worst_s = max(worst_s, diff.max().item())
                    else:
                        worst_p = max(worst_p, diff.max().item())
                        n, off = n + diff.numel(), off + int((diff > 1e-6).sum().item())
            res |= {"loss_max_rel_err": loss_err, "param_share_over_1e-6": off / n, "param_max_abs_err": worst_p,
                    "running_stat_max_abs_err": worst_s,
                    "output_max_abs_err": (out_dp - ref["x_hat"]).abs().max().item()}
            ok = (loss_err <= 1e-4 and off / n < 5e-3 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5
                  and torch.allclose(out_dp, ref["x_hat"], **GEN_TOL))
        else:
            # against the fp32 process: the PSNR of the step's generator output no more than 1 dB below one bf16
            # process's, and the gradients' error no more than DP_BF16_GRAD_FACTOR times one bf16 process's
            res |= {"psnr_dp": psnr(out_dp, ref["x_hat"]), "psnr_single": bf16_single["psnr"],
                    "grad_rel_l2_err_single": bf16_single["grad_err"]}
            gate = bool(res["psnr_dp"] >= bf16_single["psnr"] - 1.0
                        and all(res["grad_rel_l2_err"][net] <= DP_BF16_GRAD_FACTOR * bf16_single["grad_err"][net]
                                for net in ("g", "d")))
            res["bf16_gate"] = gate
            finite = bool(np.isfinite(list(r0["metrics"].values())).all())
            ok = finite and (not gate if run == "bf16_local_stats" else gate)  # the control must fail it
        want = dict(REMAT_LAUNCHES["remat" if run.endswith("remat") else "none"])
        if dtype == "float32":
            want["channel_stats"] = 0  # channel_stats is bf16 only
        res |= {"launches": [r["launches"] for r in rs], "collectives": r0["collectives"],
                "ranks_same_state": all(torch.equal(r0[net][k], r[net][k]) for r in rs[1:] for net in ("g", "d")
                                        for k in r0[net]),
                "rows": [r["rows"] for r in rs]}
        # the control's ranks each fold their own statistics into the running ones: their states differ there
        ok &= ((res["ranks_same_state"] or run == "bf16_local_stats") and res["rows"] == [1] * nprocs
               and all(r["launches"] == want and r["collectives"] == DP_COLLECTIVES[run] for r in rs))
        for r in rs:
            launches["fp32" if dtype == "float32" else "bf16"].update(r["launches"])
        checks[run] = res
        log(f"dp {nprocs} ranks ({backend}, {torch.cuda.device_count()} card(s)) {run} {nprocs}x{DP_FP32[1]}^2 "
            f"against one process: {json.dumps(res)} ok={ok}")
        if not ok:
            raise AssertionError(f"dp {nprocs} ranks {run}: {res}; launches expected {want}, collectives "
                                 f"{DP_COLLECTIVES[run]}")
    return checks, launches, [rk.get("timed") for rk in ranks]


def dp_ranks_main() -> int:
    """``python3 chip_smoke.py --dp-ranks``: only phase 10's ranks, one per
    card of this machine over NCCL, and their bf16 step timed against the
    bare step (DP_TIMED_STEPS a side). Prints one JSON line, then the last
    line as the full run does."""
    import os
    import shutil

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"--dp-ranks needs two cards or more, found {n}")
    phase_device()
    root = os.path.join("build", "dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    checks, launches, timed = phase_dp_ranks(n, "nccl", root, DP_TIMED_STEPS)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"dp_ranks": {"ranks": n, "checks": checks, "timed": timed,
                                   "launches": {k: dict(v) for k, v in launches.items()}}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


MESH_TIMEOUT = 300  # seconds for one launch of phase 11's ranks; a rank that hangs fails the phase
MESH_IMAGES = (2, 256, 256)  # phase 11: 2 images of 256² a batch (bucket 64; H 128 a rank on a spatial pair)
# phase 11's runs: (name, [n_data, n_spatial], precision, BN mode); 2 gloo ranks of this card, then 4
MESH_RUNS = {2: [("1x2_fp32_running", [1, 2], "fp32", "running"), ("2x1_fp32_running", [2, 1], "fp32", "running"),
                 ("1x2_fp32_batch", [1, 2], "fp32", "batch"), ("1x2_bf16_batch", [1, 2], "bf16", "batch"),
                 ("1x2_bf16_running", [1, 2], "bf16", "running")],
             4: [("2x2_fp32_running", [2, 2], "fp32", "running"), ("2x2_bf16_batch", [2, 2], "bf16", "batch")]}
MESH_RUNNING_TOL = dict(atol=1e-5, rtol=0)  # fp32 running BN against one process: JAX's tests/test_serve.py:265
MESH_BATCH_TOL = dict(atol=2e-4, rtol=1e-3)  # fp32 batch BN against one process: JAX's tests/test_dist.py:205
MESH_EXCHANGES = 42 + 7  # a forward's halo exchanges on a spatial rank: each dense layer's, 7 convs with a 3×3 kernel
MESH_STATS_ALLREDUCES = 3 + 42 + 42  # batch BN: the blocks' inputs, each layer's new channels, each layer's K2
MESH_TIMED = 10  # --mesh-ranks: forwards a turn, mesh and one card


def mesh_ranks_cells(n):
    """--mesh-ranks on n cards: (name, mesh, images (B, H, W)), bf16 running BN."""
    return [(f"1x{n}_bf16_running_2048", [1, n], (1, 2048, 2048)),  # the latency lever: one large image, n cards
            (f"{n}x1_bf16_running_512", [n, 1], (8 * n, 512, 512))]  # the throughput lever: 8 of 512² a card


def mesh_weights():
    """The generator's seed-0 weights with random running statistics, on the CPU."""
    import torch

    from fdgan_tpu_torch.models.fdgan import FDGAN

    model = FDGAN(generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    return model.state_dict()


def mesh_per_forward(precision, bn_mode, n_spatial, backend):
    """What a rank's forward of the mesh must launch and exchange."""
    batch = bn_mode == "batch"
    exchanges = MESH_EXCHANGES if n_spatial > 1 else 0
    return {"k1": 42, "k2": 42 if batch else 0, "channel_stats": 45 if batch and precision == "bf16" else 0,
            "exchanges": exchanges, "host_staged": exchanges if backend == "gloo" else 0,
            "stats_allreduces": MESH_STATS_ALLREDUCES if batch else 0}


def run_mesh_ranks(weights, runs, nprocs, backend, root):
    """``python -m fdgan_tpu_torch.tools.mesh_serve`` as each of ``nprocs``
    ranks over ``backend`` on ``runs``, under MESH_TIMEOUT; returns each
    run's per-rank results by name."""
    import os

    import torch

    from fdgan_tpu_torch.dist import mesh

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"mesh{nprocs}.pt")
    torch.save({"weights": weights, "runs": runs}, path)
    try:
        mesh.run_local_ranks([sys.executable, "-m", "fdgan_tpu_torch.tools.mesh_serve", "--input", path, "--out",
                              root, "--device", "cuda", "--backend", backend], nprocs, MESH_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        raise AssertionError(f"mesh: {e}")
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(nprocs)]
    return {run["name"]: [rk[i] for rk in ranks] for i, run in enumerate(runs)}


def check_mesh_ranks(name, rks, precision, bn_mode, n_spatial, backend, launches):
    """Every rank ran each forward with exactly the launches, exchanges and
    statistics' all-reduces of its place, and (with H sharded) held each of
    its 42 halo'd K1 launches of the first forward against the twin. Adds
    the launches to ``launches`` (by dtype)."""
    want = mesh_per_forward(precision, bn_mode, n_spatial, backend)
    for rk in rks:
        for fwd in rk["forwards"]:
            got = {k: fwd[k] for k in want}
            if got != want:
                raise AssertionError(f"mesh {name} rank at {rk['coordinate']}: a forward ran {got}, expected {want}")
            launches[precision].update({k: fwd[k] for k in ("k1", "k2", "channel_stats")})
        if n_spatial > 1 and rk["k1_check"].get("calls") != 42:
            raise AssertionError(f"mesh {name} rank at {rk['coordinate']}: {rk['k1_check'].get('calls')} halo'd K1 "
                                 "launches checked, expected 42")
    return {"forwards_per_rank": [len(rk["forwards"]) for rk in rks], "per_forward": want,
            "exchange_bytes_per_forward": [rk["forwards"][0]["exchange_bytes"] for rk in rks],
            "k1_halo_max_abs_err": max((rk["k1_check"].get("max_abs_err", 0.0) for rk in rks), default=0.0),
            "k1_halo_shapes": rks[0]["k1_check"].get("shapes", [])}


def seam_gate(got, ref, n_spatial):
    """tests/test_dist.py:208-249's seam gate: the rows beside each seam no
    worse than 5× the interior's. Returns (seam max, interior max, ok)."""
    h = got.shape[1]
    seams = sorted({r for b in range(1, n_spatial) for r in (b * h // n_spatial - 1, b * h // n_spatial)})
    interior = [r for r in range(h) if r not in seams]
    err = (got - ref).abs()
    seam_max, interior_max = err[:, seams].max().item(), err[:, interior].max().item()
    return seam_max, interior_max, seam_max <= max(5.0 * interior_max, 1e-5)


MESH_CLI_SCRIPT = r"""
import sys
import numpy as np
from fdgan_tpu_torch.cli import _common, serve
from fdgan_tpu_torch.utils import images
# the card's machine has no PIL: the folder holds .npy arrays under .png names
images.load_rgb_image = lambda path, *a, **k: np.load(path).astype(np.float32)
_common.save_image_normalized = lambda arr, path: np.save(path + ".npy", arr)
serve.main(sys.argv[1:])
"""


# K1 with halo rows, on the card alone: (shape, dtype, shard rows); the image split into shards of whole 8-row
# tiles, each run with its neighbours' rows (ops.dense.halo_buffer), against K1 on the whole image (the same
# bits: the tiles fall alike and each pixel sums its products in the same order) and the twin (the tolerances)
MESH_K1_CASES = [((8, 512, 512, 64), "bfloat16", [256, 256]), ((8, 128, 128, 992), "bfloat16", [64, 40, 24]),
                 ((2, 120, 200, 96), "bfloat16", [56, 64]), ((1, 1024, 1024, 64), "float32", [512, 512]),
                 ((1, 256, 256, 992), "float32", [128, 64, 64])]


def mesh_k1_halo():
    """MESH_K1_CASES: returns the checks, with the first shard's K1 on the
    device alone with its halo row and without (``halo_device_ms``,
    ``shard_device_ms``); raises on a disagreement."""
    import torch

    from fdgan_tpu_torch.ops import dense
    from fdgan_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for shape, dtype, shards in MESH_K1_CASES:
        args = layer_inputs(shape, getattr(torch, dtype), gen)
        x, rest = args[0], args[1:]
        b, h, w, c = shape
        with torch.inference_mode(), exact_fp32():
            whole = dense.fused_dense_layer(x, *rest)
            twin = dense.layer_reference(x, *rest)
            parts, start, timed = [], 0, {}
            for n in shards:
                xs, top, bottom = dense.halo_buffer(b, n, w, c, device="cuda", dtype=x.dtype)
                xs.copy_(x[:, start:start + n])
                if start > 0:
                    top.copy_(x[:, start - 1:start])
                if start + n < h:
                    bottom.copy_(x[:, start + n:start + n + 1])
                halo = (top if start > 0 else None, bottom if start + n < h else None)
                parts.append(dense.fused_dense_layer(xs, *rest, halo=halo))
                if not timed:  # the first shard, its bottom row from the next
                    timed = {"halo_device_ms": device_ms(lambda: dense.fused_dense_layer(xs, *rest, halo=halo)),
                             "shard_device_ms": device_ms(lambda: dense.fused_dense_layer(xs, *rest))}
                start += n
            got = torch.cat(parts, dim=1)
        tol = K1_TOL_F32 if dtype == "float32" else K1_TOL_BF16
        row = {"shape": list(shape), "dtype": dtype, "shards": shards, "same_bits_as_whole": bool(torch.equal(got, whole)),
               "max_abs_err": (got.float() - twin.float()).abs().max().item()} | timed
        rows.append(row)
        log(f"mesh K1 with halo rows {json.dumps(row)}")
        if not (row["same_bits_as_whole"] and torch.allclose(got.float(), twin.float(), **tol)):
            raise AssertionError(f"K1 with halo rows: {row}")
    return rows


def phase_mesh():
    """Phase 11: the serving mesh (``InferenceEngine(mesh=..., spatial=...)``,
    ``dist.halo_exchange``) on this card: ranks of
    ``tools.mesh_serve`` over gloo (NCCL takes one rank per device), 2 and
    then 4, on MESH_IMAGES through the 1×2, 2×1 and 2×2 meshes of
    MESH_RUNS, against the engine in this one process on the same weights
    and images: fp32 running BN within MESH_RUNNING_TOL, fp32 batch BN
    within MESH_BATCH_TOL with the seam gate, bf16 by the PSNR criterion (against
    the fp32 engine, no more than 1 dB below the one-process bf16 engine's);
    each rank's forward with exactly its launches, exchanges and statistics'
    all-reduces; with H sharded, every halo'd K1 launch of the first forward
    held against its twin on its own input. Then ``cli/serve
    --spatialShards 2`` on 2 ranks against one process (fp32). Returns the
    phase's numbers and the path's launches by dtype."""
    import os
    import shutil

    import torch

    from fdgan_tpu_torch.dist import mesh
    from fdgan_tpu_torch.models.fdgan import FDGAN
    from fdgan_tpu_torch.serve import InferenceEngine

    t0 = time.perf_counter()
    root = os.path.join("build", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    weights = mesh_weights()
    b, h, w = MESH_IMAGES
    imgs = np.random.default_rng(7).uniform(size=(b, h, w, 3)).astype(np.float32)
    in_dir, out_dir = os.path.join(root, "cli_in"), os.path.join(root, "cli_out")
    os.makedirs(in_dir)
    raw = np.random.default_rng(8).integers(0, 256, size=(3, 192, 256, 3)).astype(np.float32)
    for i, img in enumerate(raw):
        with open(os.path.join(in_dir, f"{i}.png"), "wb") as f:
            np.save(f, img)
    cli_args = ["--inDir", in_dir, "--outDir", out_dir, "--spatialShards", "2", "--precision", "fp32", "--maxBatch",
                "2", "--device", "cuda", "--backend", "gloo"]

    def ranks(nprocs):
        t = time.perf_counter()
        runs = [{"name": name, "mesh": dims, "precision": prec, "bn_mode": bn, "bucket": 64, "batch_sizes": [b],
                 "images": torch.from_numpy(imgs), "check_k1": K1_TOL_F32 if prec == "fp32" else K1_TOL_BF16}
                for name, dims, prec, bn in MESH_RUNS[nprocs]]
        res = run_mesh_ranks(weights, runs, nprocs, "gloo", os.path.join(root, f"ranks{nprocs}"))
        return res, time.perf_counter() - t

    def cli():
        t = time.perf_counter()
        try:
            logs = mesh.run_local_ranks([sys.executable, "-c", MESH_CLI_SCRIPT] + cli_args, 2, MESH_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            raise AssertionError(f"mesh cli: {e}")
        return logs, time.perf_counter() - t

    # K1 with halo rows first, alone on the card: its times would read the ranks' work beside them
    out = {"k1_halo": mesh_k1_halo(), "checks": {}}
    # the three launches of ranks (2, 4 and the CLI's 2) run at once, beside this process's own work: their
    # processes' start-up (~10 s each, CUDA and the kernels' library) would otherwise take most of the phase
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        launched = {nprocs: pool.submit(ranks, nprocs) for nprocs in MESH_RUNS}
        cli_run = pool.submit(cli)
        singles = {}
        for precision in ("fp32", "bf16"):
            for bn in ("running", "batch"):
                eng = InferenceEngine(weights, device="cuda", precision=precision, bn_mode=bn, bucket=64,
                                      batch_sizes=(b,))
                singles[precision, bn] = torch.from_numpy(np.stack(eng.predict_batch(list(imgs))))
                del eng
        # the CLI's weights without --netG: FDGAN's seed-0 init
        eng = InferenceEngine(FDGAN(generator=torch.Generator().manual_seed(0)), device="cuda", precision="fp32",
                              bucket=64, batch_sizes=(1, 2))
        cli_ref = eng.predict_batch([img / 255.0 for img in raw])
        del eng
        results = {nprocs: f.result() for nprocs, f in launched.items()}
        cli_logs, cli_seconds = cli_run.result()
    launches = {"bf16": collections.Counter(), "fp32": collections.Counter()}
    for nprocs, specs in MESH_RUNS.items():
        res_n, seconds = results[nprocs]
        out[f"launch_{nprocs}_ranks_s"] = seconds
        for name, dims, prec, bn in specs:
            rks = res_n[name]
            res = check_mesh_ranks(name, rks, prec, bn, dims[1], "gloo", launches)
            got, ref = rks[0]["outputs"], singles[prec, bn]
            res["max_abs_err"] = (got - ref).abs().max().item()
            if prec == "fp32" and bn == "running":
                ok = torch.allclose(got, ref, **MESH_RUNNING_TOL)
            elif prec == "fp32":
                res["seam_max_abs_err"], res["interior_max_abs_err"], seams_ok = seam_gate(got, ref, dims[1])
                ok = torch.allclose(got, ref, **MESH_BATCH_TOL) and seams_ok
            else:
                res["psnr_mesh_db"] = psnr(got, singles["fp32", bn])
                res["psnr_single_db"] = psnr(ref, singles["fp32", bn])
                ok = res["psnr_mesh_db"] >= res["psnr_single_db"] - 1.0
            ok = ok and bool(torch.isfinite(got).all()) and tuple(got.shape) == (b, h, w, 3)
            out["checks"][name] = res
            log(f"mesh {name} ({nprocs} gloo ranks on this card) {b}x{h}x{w} against one process: "
                f"{json.dumps(res)} ok={ok}")
            if not ok:
                raise AssertionError(f"mesh {name}: {res}")
    # cli/serve --spatialShards 2 on 2 ranks against one process, fp32, running BN
    cli_err = max(np.abs(np.load(os.path.join(out_dir, f"{i}.png.npy")) - r).max() for i, r in enumerate(cli_ref))
    out["cli"] = {"max_abs_err": float(cli_err), "launch_s": cli_seconds,
                  "rank0_tail": cli_logs[0].strip().splitlines()[-1][:200]}
    log(f"mesh cli.serve --spatialShards 2 (2 gloo ranks) 3x192x256 fp32 against one process: {json.dumps(out['cli'])}")
    if not cli_err <= MESH_RUNNING_TOL["atol"]:
        raise AssertionError(f"mesh cli.serve: outputs differ from one process by {cli_err:.3e}")
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: dict(v) for k, v in launches.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {out['seconds']:.1f} s")
    return out, launches


def mesh_ranks_main() -> int:
    """``python3 chip_smoke.py --mesh-ranks``: only the mesh, one rank per
    card of this machine over NCCL, on ``mesh_ranks_cells`` (bf16 running BN):
    each rank's launches and exchanges exact, the spatial rank's halo'd K1
    launches against their twins, the mesh against one card in turns
    (MESH_TIMED forwards a turn, single, mesh, mesh, single), one forward of
    the 1×N mesh under torch.profiler on rank 0. Prints one JSON line, then
    the last line as the full run does."""
    import os
    import shutil

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"--mesh-ranks needs two cards or more, found {n}")
    phase_device()
    root = os.path.join("build", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(9)
    runs = []
    for name, dims, (b, h, w) in mesh_ranks_cells(n):
        runs.append({"name": name, "mesh": dims, "precision": "bf16", "bn_mode": "running", "bucket": 64,
                     "batch_sizes": [b], "images": torch.from_numpy(rng.uniform(size=(b, h, w, 3)).astype(np.float32)),
                     "check_k1": K1_TOL_BF16, "time": MESH_TIMED, "profile": dims[1] > 1})
    results = run_mesh_ranks(mesh_weights(), runs, n, "nccl", root)
    shutil.rmtree(root, ignore_errors=True)
    launches = {"bf16": collections.Counter(), "fp32": collections.Counter()}
    cells = {}
    for run in runs:
        rks = results[run["name"]]
        cells[run["name"]] = check_mesh_ranks(run["name"], rks, "bf16", "running", run["mesh"][1], "nccl", launches)
        cells[run["name"]] |= {"turns": rks[0]["turns"], "profile": rks[0].get("profile"),
                               "finite": bool(torch.isfinite(rks[0]["outputs"]).all())}
        log(f"mesh {run['name']} ({n} NCCL ranks, one a card): {json.dumps(cells[run['name']])}")
        if not cells[run["name"]]["finite"]:
            raise AssertionError(f"mesh {run['name']}: non-finite outputs")
    print(json.dumps({"mesh_ranks": {"ranks": n, "cells": cells,
                                     "launches": {k: dict(v) for k, v in launches.items()}}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


SP_TIMEOUT = 300  # seconds for one launch of phase 12's ranks; a rank that hangs fails the phase
SP_IMAGES = (2, 256)  # phase 12: 2 images of 256² a batch (H 128 a rank on a spatial pair)
# phase 12's runs: (name, [n_data, n_spatial], precision); 2 gloo ranks of this card, then 4; remat off
SP_RUNS = {2: [("1x2_fp32", [1, 2], "fp32"), ("1x2_bf16", [1, 2], "bf16")],
           4: [("2x2_fp32", [2, 2], "fp32"), ("2x2_bf16", [2, 2], "bf16")]}
# a spatial rank's step without remat: phase 5's launches (channel_stats is bf16 only), and the
# collectives. Exchanges: G's forward 42 (a dense block's input and each layer's new channels but the
# last's) + 7 (its 3x3 convs), its backward 48 (not the first conv's: the input needs no gradient); D in
# G's step 6 (K3's halo and 5 convs) and 6; D's step 2 x 6 forward and 2 x 4 backward (neither K3's nor the
# first conv's input needs a gradient); SSIM 1 and 1. The global means' count all-reduces: pixel, SSIM,
# G's BCE, D's two BCEs, d_real and d_fake. The statistics' all-reduces: phase 10's DP_COLLECTIVES
SP_PER_STEP = {"k1": 42, "k2": 42, "k3": 3, "exchanges": 49 + 48 + 12 + 2 + 12 + 8, "counts": 7,
               "stats_forward": 96, "stats_backward": 96, "grads": 2, "metrics": 2, "gathers": 0, "max_reduces": 0}
# the gradient vectors against one process's step: tests/test_torch_train_spatial.py's gate for the port's
# step on the whole batch (relative L2 and cosine over all of a net's gradients)
SP_GRAD_GATE = dict(rel=5e-3, cos=0.99999)
# --sp-ranks' step under remat="stages": phase 8's REMAT_LAUNCHES["stages"], and the collectives of the CPU
# run of tools.sp_step (the recompute of each encoder stage re-issues its exchanges and statistics)
SP_PER_STEP_STAGES = {"k1": 126, "k2": 126, "k3": 3, "channel_stats": 99, "exchanges": 176, "host_staged": 0,
                      "counts": 7, "stats_forward": 225, "stats_backward": 96, "grads": 2, "metrics": 2, "gathers": 0,
                      "max_reduces": 0}
# K3 with halo rows on the card alone: (shape, dtype, band rows); each band with its neighbours' 7 rows a side,
# against K3 on the whole image (the same bits: the body reads the rows the whole image's reads)
SP_K3_CASES = [((8, 512, 512, 3), "bfloat16", [256, 256]), ((4, 256, 256, 3), "bfloat16", [96, 88, 72]),
               ((2, 256, 256, 3), "float32", [128, 128]), ((2, 120, 200, 3), "float32", [64, 56]),
               ((1, 2048, 2048, 3), "bfloat16", [512, 512, 512, 512])]
# phase 12's contextual term: one fp32 step at 2×64² with CX (weight 1) on a seed-0 VGG16, no remat, through the
# 1x2 and 2x2 meshes against one process on the whole batch; the band-local control (each band's term alone)
SP_CX = (2, 64)
SP_CX_RUNS = {2: [("1x2_fp32_cx", [1, 2], None), ("1x2_fp32_cx_local", [1, 2], "band_local_cx")],
              4: [("2x2_fp32_cx", [2, 2], None)]}
SP_CX_PER_STEP = {"k1": 42, "k2": 42, "k3": 3, "channel_stats": 0, "gathers": 1, "max_reduces": 2}
# CX alone on bands of two feature maps of relu3_3's size for 2 images of 256² (N = 4096 positions, C = 256)
SP_CX_FEATURES = [2, 64, 64, 256]
SP_CX_ALONE_REL = 1e-5  # the shares' sum and the stitched gradients against the whole maps' (relative)
SP_TIMED = 4  # --sp-ranks: steps a turn, mesh and one card
SP_RANKS_IMAGE = (1, 2048)  # --sp-ranks: one 2048² bf16 image, --rematStages, one rank a card
SP_RANKS_CX_IMAGE = (1, 512)  # --sp-ranks: one 512² bf16 image with the contextual term (relu3_3: N = 16384)


def sp_k3_halo():
    """SP_K3_CASES: every band's K3 launch with halo rows the same bits as
    K3 on the whole image and within K3_TOL of its twin; the kernel on the
    device alone on the middle 256 rows of the 8×512² bf16 image, with its
    7 rows a side and without (``halo_device_ms``, ``shard_device_ms``).
    Raises on a disagreement."""
    import torch

    from fdgan_tpu_torch.ops import filters, freq
    from fdgan_tpu_torch.tools.timing import device_ms

    rows = []
    for shape, dtype, bands in SP_K3_CASES:
        x = torch.tensor(np.random.default_rng(13).uniform(size=shape), dtype=getattr(torch, dtype), device="cuda")
        h = shape[1]
        with torch.inference_mode(), exact_fp32():
            whole = freq.frequency_fuse(x)
            parts, start, err, close = [], 0, 0.0, True
            for n in bands:
                halo = (x[:, start - 7:start] if start else None, x[:, start + n:start + n + 7] if start + n < h else None)
                xs = x[:, start:start + n].contiguous()
                got = freq.frequency_fuse(xs, halo=halo)
                twin = filters.frequency_fuse(xs, halo=halo)
                err = max(err, (got.float() - twin.float()).abs().max().item())
                close &= torch.allclose(got.float(), twin.float(), **K3_TOL[dtype])
                parts.append(got)
                start += n
            same = bool(torch.equal(torch.cat(parts, dim=1), whole))
            row = {"shape": list(shape), "dtype": dtype, "bands": bands, "same_bits_as_whole": same,
                   "max_abs_err": err, "within_twin_tol": bool(close)}
            if shape == SP_K3_CASES[0][0]:
                xs = x[:, 128:384].contiguous()
                halo = (x[:, 121:128].contiguous(), x[:, 384:391].contiguous())  # as the exchange delivers them
                row |= {"halo_device_ms": device_ms(lambda: freq.frequency_fuse(xs, halo=halo), launches=40),
                        "shard_device_ms": device_ms(lambda: freq.frequency_fuse(xs), launches=40)}
        rows.append(row)
        log(f"sp K3 with halo rows {json.dumps(row)}")
        if not (same and close):
            raise AssertionError(f"K3 with halo rows: {row}")
    return rows


def run_sp_ranks(blob, nprocs, backend, root):
    """``python -m fdgan_tpu_torch.tools.sp_step`` as each of ``nprocs``
    ranks over ``backend`` on ``blob``'s runs, under SP_TIMEOUT; returns
    each run's per-rank results by name."""
    import os

    import torch

    from fdgan_tpu_torch.dist import mesh

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "in.pt")
    torch.save(blob, path)
    try:
        mesh.run_local_ranks([sys.executable, "-m", "fdgan_tpu_torch.tools.sp_step", "--input", path, "--out", root,
                              "--device", "cuda", "--backend", backend], nprocs, SP_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        raise AssertionError(f"sp: {e}")
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(nprocs)]
    return {run["name"]: [rk[i] for rk in ranks] for i, run in enumerate(blob["runs"])}


def stitch(rks, shape):
    """The generator's output of a mesh's ranks put together: rank (d, s)
    holds batch rows d·B/n_data on and H band s (``dist.mesh.mesh_block``)."""
    import torch

    from fdgan_tpu_torch.dist import mesh

    n_data, n_spatial = rks[0]["mesh"]
    out = torch.empty(shape)
    local = shape[0] // n_data
    for rk in rks:
        d, s = rk["coordinate"]
        a, b = mesh.spatial_rows(shape[1], n_spatial)[s]
        out[d * local:(d + 1) * local, a:b] = rk["x_hat"]
    return out


def grad_gate(got, want):
    """(relative L2 error, cosine) over all of a net's gradients, by name."""
    import torch

    g = torch.cat([got[k].double().flatten() for k in sorted(want)])
    w = torch.cat([want[k].double().flatten() for k in sorted(want)])
    return (g - w).norm().item() / w.norm().item(), (g @ w).item() / (g.norm() * w.norm()).item()


def phase_sp():
    """Phase 12: training with H sharded (``make_train_step(mesh=)``). K3
    with halo rows on bands of SP_K3_CASES, alone on the card. Then ranks of
    ``tools.sp_step`` over gloo on this one card (NCCL takes one rank per
    device), 2 and then 4, one step on SP_IMAGES through the 1×2 and 2×2
    meshes of SP_RUNS, against one process's step on the whole batch (the
    same seed-0 state): fp32 at phase 5's train-step criteria (losses,
    parameters after Adam within 2·lr, running statistics, the step's
    generator output within GEN_TOL; the share of parameters over 1e-6 is
    reported, the gradient vectors held at SP_GRAD_GATE instead); bf16 by the
    PSNR criterion on the step's output and by the gradients (each against
    one fp32 process's, measured by one bf16 process's, DP_BF16_GRAD_FACTOR),
    as phase 10; every rank's launches and collectives exactly SP_PER_STEP;
    every K3 launch with halo rows held against its twin on its own input.
    Returns the phase's numbers and the path's launches by dtype."""
    import os
    import shutil

    import torch

    from fdgan_tpu_torch.cli._common import fp32_exact
    from fdgan_tpu_torch.tools import sp_step

    t0 = time.perf_counter()
    root = os.path.join("build", "sp")
    shutil.rmtree(root, ignore_errors=True)
    b, size = SP_IMAGES
    haze, gt = train_batch(b, size, 21, device="cpu")
    out = {"k3_halo": sp_k3_halo(), "checks": {}}

    cx_haze, cx_gt = train_batch(*SP_CX, 23, device="cpu")

    def ranks(nprocs):
        t = time.perf_counter()
        runs = [{"name": name, "mesh": dims, "precision": prec, "remat": False,
                 "check_k3": K3_TOL["float32" if prec == "fp32" else "bfloat16"]} for name, dims, prec in SP_RUNS[nprocs]]
        runs += [{"name": name, "mesh": dims, "precision": "fp32", "remat": False, "haze": cx_haze, "gt": cx_gt,
                  "contextual": 0, "control": control, "cx_features": None if control else SP_CX_FEATURES,
                  "check_k3": K3_TOL["float32"]} for name, dims, control in SP_CX_RUNS[nprocs]]
        res = run_sp_ranks({"haze": haze, "gt": gt, "runs": runs}, nprocs, "gloo", os.path.join(root, f"ranks{nprocs}"))
        return res, time.perf_counter() - t

    def single(precision):  # one process's step on the whole batch, what the ranks' step is held against
        dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        grads = {}
        state, tx_g, tx_d = sp_step._state("cuda", grads)
        with fp32_exact(precision, "cuda"):  # TF32 off for an fp32 step
            metrics, x_hat = sp_step._stepper(tx_g, tx_d, dtype, False, None)(state, haze.cuda(), gt.cuda())
        torch.cuda.synchronize()
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "x_hat": x_hat.float().cpu(), "grads": grads,
                "g": {k: v.cpu() for k, v in state.g.state_dict().items()},
                "d": {k: v.cpu() for k, v in state.d.state_dict().items()}}

    def single_cx():
        """One process's fp32 step with the contextual term on the whole
        batch, and the term alone on the whole feature maps (its value,
        gradients and peak memory above what was allocated before)."""
        from fdgan_tpu_torch.losses.contextual import contextual_loss
        from fdgan_tpu_torch.models.vgg16 import VGG16

        grads = {}
        state, tx_g, tx_d = sp_step._state("cuda", grads)
        vgg = VGG16(device="cuda", generator=torch.Generator().manual_seed(0))
        with fp32_exact("fp32", "cuda"):
            metrics, x_hat = sp_step._stepper(tx_g, tx_d, torch.float32, False, None, vgg)(state, cx_haze.cuda(),
                                                                                          cx_gt.cuda())
            img, tgt = (t.requires_grad_(True) for t in sp_step.cx_features(SP_CX_FEATURES, "cuda"))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            whole = contextual_loss(img, tgt)
            whole.backward()
            torch.cuda.synchronize()
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "x_hat": x_hat.float().cpu(), "grads": grads,
                "g": {k: v.cpu() for k, v in state.g.state_dict().items()},
                "d": {k: v.cpu() for k, v in state.d.state_dict().items()},
                "alone": {"loss": whole.item(), "di": img.grad.cpu(), "dt": tgt.grad.cpu(),
                          "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}}

    # both launches of ranks run at once, beside this process's references: their start-up would otherwise
    # take most of the phase
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = {nprocs: pool.submit(ranks, nprocs) for nprocs in SP_RUNS}
        refs = {prec: single(prec) for prec in ("fp32", "bf16")}
        ref_cx = single_cx()
        results = {nprocs: f.result() for nprocs, f in launched.items()}
    ref = refs["fp32"]
    bf16_single = {"psnr": psnr(refs["bf16"]["x_hat"], ref["x_hat"]),
                   "grad_err": {net: grad_gate(refs["bf16"]["grads"][net], ref["grads"][net])[0] for net in "gd"}}
    launches = {"bf16": collections.Counter(), "fp32": collections.Counter()}
    for nprocs, specs in SP_RUNS.items():
        res_n, seconds = results[nprocs]
        out[f"launch_{nprocs}_ranks_s"] = seconds
        for name, dims, prec in specs:
            rks = res_n[name]
            r0 = rks[0]
            got = stitch(rks, (b, size, size, 3))
            res = {"grad_gate": {net: grad_gate(r0["grads"][net], ref["grads"][net]) for net in "gd"},
                   "peak_gib": [rk["peak_gib"] for rk in rks], "rows": [rk["rows"] for rk in rks],
                   "k3_halo_checked": [rk["k3_check"].get("calls") for rk in rks],
                   "k3_halo_max_abs_err": max(rk["k3_check"].get("max_abs_err", 0.0) for rk in rks)}
            if prec == "fp32":
                loss_err = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-6) for k, v in ref["metrics"].items())
                off = n = 0
                worst_p = worst_s = 0.0
                for net in ("g", "d"):
                    for k, v in r0[net].items():
                        diff = (v - ref[net][k]).abs()
                        if "running" in k:
                            worst_s = max(worst_s, diff.max().item())
                        else:
                            worst_p = max(worst_p, diff.max().item())
                            n, off = n + diff.numel(), off + int((diff > 1e-6).sum().item())
                res |= {"loss_max_rel_err": loss_err, "param_share_over_1e-6": off / n, "param_max_abs_err": worst_p,
                        "running_stat_max_abs_err": worst_s, "output_max_abs_err": (got - ref["x_hat"]).abs().max().item()}
                # the parameters' share over 1e-6 is reported, not gated: Adam's first step is ~sign(g)·lr, and
                # the bands' sums in another order flip the sign of G's near-zero gradients (1.3 % of the
                # parameters on the H100 against 0.5 % for the data-parallel step); the gradient vectors are
                # held instead, as JAX's tests/test_dist.py::test_train_step_sp_grad_parity holds its own
                ok = (loss_err <= 1e-4 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5
                      and torch.allclose(got, ref["x_hat"], **GEN_TOL)
                      and all(rel < SP_GRAD_GATE["rel"] and cos > SP_GRAD_GATE["cos"]
                              for rel, cos in res["grad_gate"].values()))
            else:
                res |= {"psnr_sp": psnr(got, ref["x_hat"]), "psnr_single": bf16_single["psnr"],
                        "grad_rel_l2_err_single": bf16_single["grad_err"]}
                ok = bool(res["psnr_sp"] >= bf16_single["psnr"] - 1.0
                          and all(res["grad_gate"][net][0] <= DP_BF16_GRAD_FACTOR * bf16_single["grad_err"][net]
                                  for net in "gd"))
            want = dict(SP_PER_STEP, channel_stats=54 if prec == "bf16" else 0, host_staged=SP_PER_STEP["exchanges"])
            res["per_step"] = [rk["per_step"] for rk in rks]
            ok &= (bool(np.isfinite(list(r0["metrics"].values())).all()) and tuple(got.shape) == (b, size, size, 3)
                   and all(rk["per_step"] == want and rk["k3_check"].get("calls") == 3 for rk in rks))
            for rk in rks:
                launches[prec].update({k: rk["per_step"][k] for k in ("k1", "k2", "k3", "channel_stats")})
            out["checks"][name] = res
            log(f"sp {name} ({nprocs} gloo ranks on this card) {b}x{size}^2 against one process: {json.dumps(res)} "
                f"ok={ok}")
            if not ok:
                raise AssertionError(f"sp {name}: {res}; per step expected {want}")
    launches["cx"] = collections.Counter()
    for nprocs, specs in SP_CX_RUNS.items():
        for name, dims, control in specs:
            rks = results[nprocs][0][name]
            res = sp_cx_check(rks, ref_cx, control)
            if control is None:
                for rk in rks:
                    launches["cx"].update({k: rk["per_step"][k] for k in ("k1", "k2", "k3", "channel_stats")})
            out["checks"][name] = res
            log(f"sp {name} ({nprocs} gloo ranks on this card) {SP_CX[0]}x{SP_CX[1]}^2 with the contextual term "
                f"against one process: {json.dumps(res)}")
    out["cx_alone_whole_peak_gib"] = ref_cx["alone"]["peak_gib"]
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: dict(v) for k, v in launches.items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12: {out['seconds']:.1f} s")
    return out, launches


def sp_cx_check(rks, ref, control):
    """One contextual-term run of phase 12 against one process's step with
    the term on the whole batch (``ref``): at phase 12's fp32 criteria, every
    rank's kernels' launches, gathers and max reductions SP_CX_PER_STEP and
    its halo'd K3 launches checked; the CX alone on bands: each spatial
    group's shares add up to the whole maps' term and its gradients stitch
    to the whole's (SP_CX_ALONE_REL), and the widest tensor a rank saves for
    the backward spans its band's rows by all N target positions, never N
    by N. The band-local control must fail the losses' criterion instead.
    Raises on a failure; returns the numbers."""
    import torch

    r0 = rks[0]
    shape = tuple(ref["x_hat"].shape)
    got = stitch(rks, shape)
    loss_err = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-6) for k, v in ref["metrics"].items())
    res = {"loss_max_rel_err": loss_err, "g_contextual": [r0["metrics"]["g_contextual"], ref["metrics"]["g_contextual"]],
           "per_step": [{k: rk["per_step"][k] for k in ("k1", "k2", "k3", "channel_stats", "gathers", "max_reduces",
                                                          "exchanges", "counts")} for rk in rks],
           "peak_gib": [rk["peak_gib"] for rk in rks]}
    if control is not None:
        if loss_err <= 1e-4:
            raise AssertionError(f"sp {r0['name']}: the band-local control passes the losses' criterion: {res}")
        return res
    worst_p = worst_s = 0.0
    for net in ("g", "d"):
        for k, v in r0[net].items():
            diff = (v - ref[net][k]).abs().max().item()
            worst_s, worst_p = (max(worst_s, diff), worst_p) if "running" in k else (worst_s, max(worst_p, diff))
    res |= {"param_max_abs_err": worst_p, "running_stat_max_abs_err": worst_s,
            "output_max_abs_err": (got - ref["x_hat"]).abs().max().item(),
            "grad_gate": {net: grad_gate(r0["grads"][net], ref["grads"][net]) for net in "gd"},
            "k3_halo_checked": [rk["k3_check"].get("calls") for rk in rks]}
    ok = (loss_err <= 1e-4 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5
          and torch.allclose(got, ref["x_hat"], **GEN_TOL)
          and all(rel < SP_GRAD_GATE["rel"] and cos > SP_GRAD_GATE["cos"] for rel, cos in res["grad_gate"].values())
          and all({k: rk["per_step"][k] for k in SP_CX_PER_STEP} == SP_CX_PER_STEP and rk["k3_check"].get("calls") == 3
                  for rk in rks))
    # CX alone: every spatial group (the ranks of one data index) against the whole maps
    b, h, w, c = SP_CX_FEATURES
    n = h * w
    alone = ref["alone"]
    groups = collections.defaultdict(list)
    for rk in rks:
        groups[rk["coordinate"][0]].append(rk)
    sums, rels, rows = [], [], []
    for members in groups.values():
        members.sort(key=lambda rk: rk["coordinate"][1])
        sums.append(sum(rk["cx_alone"]["share"] for rk in members))
        for key in ("di", "dt"):
            part = torch.cat([rk["cx_alone"][key] for rk in members], dim=1)
            rels.append(((part - alone[key]).norm() / alone[key].norm()).item())
        for rk in members:
            a, z = rk["cx_alone"]["rows"]
            spanning = [sv for sv in rk["cx_alone"]["saved"] if sv[-1] == n]
            rows.append({"band_rows": (z - a) * w, "widest_rows": max(sv[-2] for sv in spanning),
                         "largest_numel": max(int(np.prod(sv)) for sv in rk["cx_alone"]["saved"]),
                         "peak_gib": rk["cx_alone"]["peak_gib"],
                         "n_by_n": any(sv[-2:] == [n, n] for sv in rk["cx_alone"]["saved"])})
    res["cx_alone"] = {"shares_sum": sums, "whole": alone["loss"], "grad_rel_l2": rels, "ranks": rows,
                       "whole_peak_gib": alone["peak_gib"]}
    ok &= (all(abs(x - alone["loss"]) <= SP_CX_ALONE_REL * abs(alone["loss"]) for x in sums)
           and all(r <= SP_CX_ALONE_REL for r in rels)
           and all(r["widest_rows"] == r["band_rows"] and r["largest_numel"] == b * r["band_rows"] * n
                   and not r["n_by_n"] for r in rows))
    if not ok:
        raise AssertionError(f"sp {r0['name']}: {res}; per step expected {SP_CX_PER_STEP}")
    return res


def sp_cx_memory_one_card() -> dict:
    """``--sp-ranks`` on one card: the SP_RANKS_CX_IMAGE cell (bf16, the
    contextual term on a seed-0 VGG16, no remat) as 2 and then 4 gloo ranks
    of the card, each rank's peak memory over its step (times not claimed:
    the ranks share the card and gloo stages through the host), against one
    process's step on the whole image (ms, peak, peak above the state), and
    that step without the term. Every rank's kernels' launches, gathers and
    max reductions exact. Raises on a failure; returns the numbers."""
    import os
    import shutil

    import torch

    from fdgan_tpu_torch.models.vgg16 import VGG16
    from fdgan_tpu_torch.tools import sp_step

    b, size = SP_RANKS_CX_IMAGE
    haze, gt = train_batch(b, size, 24, device="cpu")
    cell = {}
    for cx in (False, True):
        state, tx_g, tx_d = sp_step._state("cuda")
        vgg = VGG16(device="cuda", generator=torch.Generator().manual_seed(0)) if cx else None
        step = sp_step._stepper(tx_g, tx_d, torch.bfloat16, False, None, vgg)
        step(state, haze.cuda(), gt.cuda())  # warm: cuDNN's choices, the allocator
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        metrics, _ = step(state, haze.cuda(), gt.cuda())
        torch.cuda.synchronize()
        cell["one_process" + ("_cx" if cx else "")] = {
            "ms": 1000 * (time.perf_counter() - t), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_above_state_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "g_contextual": metrics["g_contextual"].item() if cx else None}
        del state, step, vgg
        torch.cuda.empty_cache()
    want = SP_CX_PER_STEP | {"channel_stats": 54}
    for n in (2, 4):
        name = f"1x{n}_bf16_{size}_contextual"
        root = os.path.join("build", f"sp_cx_{n}")
        shutil.rmtree(root, ignore_errors=True)
        runs = [{"name": name, "mesh": [1, n], "precision": "bf16", "remat": False, "haze": haze, "gt": gt,
                 "contextual": 0}]
        rks = run_sp_ranks({"haze": haze, "gt": gt, "runs": runs}, n, "gloo", root)[name]
        shutil.rmtree(root, ignore_errors=True)
        cell[name] = {"peak_gib": [rk["peak_gib"] for rk in rks], "g_contextual": rks[0]["metrics"]["g_contextual"],
                      "per_step": [{k: rk["per_step"][k] for k in want} for rk in rks]}
        if not (all(p == want for p in cell[name]["per_step"]) and np.isfinite(list(rks[0]["metrics"].values())).all()):
            raise AssertionError(f"sp {name}: {cell[name]}; expected per step {want}")
    log(f"sp contextual term at {b}x{size}^2 bf16 on one card: {json.dumps(cell)}")
    return cell


def sp_ranks_main() -> int:
    """``python3 chip_smoke.py --sp-ranks``: one rank of ``tools.sp_step`` per
    card over NCCL, one SP_RANKS_IMAGE bf16 image with --rematStages on the
    1×N mesh: each rank's launches and collectives, its peak memory and ms
    per step against one card's step on the whole image, in turns
    (SP_TIMED steps a turn), rank 0's step under torch.profiler (device
    busy, idle share, NCCL); then one SP_RANKS_CX_IMAGE bf16 image with the
    contextual term (a seed-0 VGG16, no remat) the same way, its gathers and
    max reductions exact. With one card: the contextual cell's memory as
    gloo ranks of the card (:func:`sp_cx_memory_one_card`). With one card it prints that and skips. Prints
    one JSON line, then the last line as the full run does."""
    import os
    import shutil

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        phase_device()
        cell = sp_cx_memory_one_card()
        print(json.dumps({"sp_ranks": {"ranks": n, "one_card_cx_memory": cell}}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
        return 0
    phase_device()
    root = os.path.join("build", "sp")
    shutil.rmtree(root, ignore_errors=True)
    b, size = SP_RANKS_IMAGE
    haze, gt = train_batch(b, size, 22, device="cpu")
    name = f"1x{n}_bf16_{size}_rematStages"
    cx_b, cx_size = SP_RANKS_CX_IMAGE
    cx_haze, cx_gt = train_batch(cx_b, cx_size, 24, device="cpu")
    cx_name = f"1x{n}_bf16_{cx_size}_contextual"
    runs = [{"name": name, "mesh": [1, n], "precision": "bf16", "remat": "stages", "time": SP_TIMED, "profile": True},
            {"name": cx_name, "mesh": [1, n], "precision": "bf16", "remat": False, "haze": cx_haze, "gt": cx_gt,
             "contextual": 0, "time": SP_TIMED}]
    res = run_sp_ranks({"haze": haze, "gt": gt, "runs": runs}, n, "nccl", root)
    shutil.rmtree(root, ignore_errors=True)
    cells = {}
    for run_name, want in ((name, SP_PER_STEP_STAGES), (cx_name, SP_CX_PER_STEP | {"channel_stats": 54})):
        rks = res[run_name]
        cell = {"per_step": [rk["per_step"] for rk in rks], "peak_gib": [rk["peak_gib"] for rk in rks],
                "turns": [rk["turns"] for rk in rks], "rows": [rk["rows"] for rk in rks], "metrics": rks[0]["metrics"]}
        if "profile" in rks[0]:
            cell["profile"] = rks[0]["profile"]
        log(f"sp {run_name} ({n} NCCL ranks, one a card): {json.dumps(cell)}")
        if not (all({k: rk["per_step"][k] for k in want} == want for rk in rks)
                and np.isfinite(list(rks[0]["metrics"].values())).all()):
            raise AssertionError(f"sp {run_name}: {cell}; expected per step {want}")
        cells[run_name] = cell
    print(json.dumps({"sp_ranks": {"ranks": n, "cells": cells}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


# phase 13: the export path. The ExportedProgram at the engine's default (8x512^2 bf16 running BN) and the demo's
# (1x1024^2 fp32 batch BN), and at 2x256^2 bf16 batch BN, where all three ops run; one AOTInductor package
# (1x512^2 bf16 running BN, uint8 in and out: export_native_bundle) in Python and through aoti_runner --ops
EXPORT_PROGRAMS = [("serve", (8, 512), "bf16", "running"), ("demo", (1, 1024), "fp32", "batch"),
                   ("bf16_batch", (2, 256), "bf16", "batch")]
EXPORT_BUNDLE = 512
EXPORT_PER_FORWARD = {"running": {"k1": 42, "k2": 0}, "batch": {"k1": 42, "k2": 42}}
EXPORT_TURNS = 10  # forwards a turn in the timed turns
EXPORT_LOOPS = 10  # aoti_runner --loops, and requests through the package in Python


def plain_operands(x, a1, b1, w1, a2=None, b2=None, w2=None, tw1=False):
    """The twins' operands from an fdgan:: op's: the affines cut back to C
    and the weights out of the kernels' layouts (ops/dense.py: w1_planes,
    w1_tw1_planes when ``tw1``, the bf16 W2 permutation, the fp32 tf32 big
    and small planes, whose sum holds W to ~2^-22)."""
    import torch

    c = x.shape[-1]
    f32 = x.dtype == torch.float32
    if f32:
        w1p = w1.permute(1, 0, 4, 2, 3).reshape(2, 32 * w1.shape[0], -1).sum(0)[:c]
    elif tw1:
        g, n = w1.shape[0] // 8, w1.shape[1]
        w1p = w1.reshape(g, 4, 2, n, 4, 2).permute(0, 4, 1, 2, 5, 3).reshape(64 * g, n)[:c]
    else:
        w1p = w1.permute(0, 2, 1).reshape(-1, w1.shape[1])[:c]
    out = [x, a1[:c], b1[:c], w1p]
    if w2 is not None:
        w2p = (w2.reshape(3, 4, 2, 8, 3, 32, 4).permute(2, 0, 4, 1, 6, 3, 5).reshape(2, 3, 3, 128, 32).sum(0) if f32
               else w2.permute(0, 1, 3, 2))
        out += [a2, b2, w2p]
    return out


@contextlib.contextmanager
def checked_op_launches(record):
    """Every launch of the fdgan:: ops' CUDA implementations inside the block
    (K1, K2, channel_stats, as an exported program or a package in this
    process calls them) held against its twin on its own input: K1 at
    K1_TOL_F32 / K1_TOL_BF16, K2 at K2_MEAN_TOL / K2_VAR_TOL (as phase 2),
    channel_stats at STATS_MEAN_TOL / STATS_VAR_TOL.
    ``record`` gets the launches checked and the worst errors."""
    import torch

    from fdgan_tpu_torch.ops import dense, stats

    record.update(k1=0, k2=0, channel_stats=0, k1_max_abs_err=0.0, k2_max_abs_err=0.0, stats_max_abs_err=0.0)

    def hold(name, got, want, tols):
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        record[name] += 1
        key = {"k1": "k1", "k2": "k2", "channel_stats": "stats"}[name] + "_max_abs_err"
        record[key] = max(record[key], err)
        if not all(torch.allclose(g.float(), w.float(), **t) for g, w, t in zip(got, want, tols)):
            raise AssertionError(f"{name} disagrees with its twin in an exported program: {err:.3e}")

    def wrap_k1(orig):
        def launch(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo):
            orig(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo)
            with exact_fp32():
                twin = dense.layer_reference(*plain_operands(x, a1, b1, w1, a2, b2, w2))
            hold("k1", (out,), (twin,), (K1_TOL_F32 if x.dtype == torch.float32 else K1_TOL_BF16,))
        return launch

    def wrap_k2(orig):
        def launch(x, a1, b1, w1, ld):
            got = orig(x, a1, b1, w1, ld)
            twin = dense.h_stats_reference(*plain_operands(x, a1, b1, w1, tw1=True))
            hold("k2", got, twin, (K2_MEAN_TOL, K2_VAR_TOL))
            return got
        return launch

    def wrap_stats(orig):
        def launch(x, ld=None):
            got = orig(x, ld)
            hold("channel_stats", got, stats.one_pass_reference(x), (STATS_MEAN_TOL, STATS_VAR_TOL))
            return got
        return launch

    with patched(dense, "_launch_k1", wrap_k1), patched(dense, "_launch_k2", wrap_k2), \
            patched(stats, "_launch", wrap_stats):
        yield


def kernel_counts(fn):
    """fn() once under the CLIs' profiler (``cli._common.maybe_profile``,
    host and device, as phase 7 counts the demo's kernels): the trace's
    device kernels named as K1's, K2's and channel_stats' kernels."""
    import tempfile

    import torch

    from fdgan_tpu_torch.cli._common import maybe_profile

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with maybe_profile(tmp):
            fn()
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in names) for k in ("dense_layer_bf16_kernel", "dense_layer_tf32x3_kernel",
                                                   "h_stats_bf16_kernel", "h_stats_tf32x3_kernel",
                                                   "channel_stats_kernel")}


def export_turns(fns, x, turns=2):
    """ms per call of each fn(x) in turns (a, b, ..., ..., b, a), CUDA events
    around EXPORT_TURNS calls after 2; each fn's turns and their mean."""
    from fdgan_tpu_torch.tools.timing import events_ms

    names = list(fns)
    order = names + names[::-1] if turns == 2 else names
    times = {n: [] for n in names}
    for n in order:
        times[n].append(events_ms(lambda: fns[n](x), reps=EXPORT_TURNS))
    return {n: {"ms": statistics.mean(t), "turns": t} for n, t in times.items()}


def export_profiles(fns, x):
    """One fn(x) of each under torch.profiler (tools.timing.busy_profile):
    its wall ms, the device's busy ms, idle share and kernels."""
    from fdgan_tpu_torch.tools.timing import busy_profile

    keep = ("wall_ms", "device_busy_ms", "idle_share", "device_events")
    return {n: {k: v for k, v in busy_profile(lambda: fn(x)).items() if k in keep} for n, fn in fns.items()}


def http_request(port, method, path, body=None, headers=None, timeout=120):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request(method, path, body=body, headers=headers or {})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, dict(r.getheaders()), data


def arity_two_bundle(base, size):
    """A package of the bundle's .sig whose program returns two outputs
    (255 − x and x), for ADVICE r5 fault 2: a reload must refuse it."""
    import torch

    from fdgan_tpu_torch.io.export import signature_lines
    from fdgan_tpu_torch.ops.build import cxx

    class Two(torch.nn.Module):
        def forward(self, x):
            return 255 - x, x

    x = torch.zeros((1, size, size, 3), dtype=torch.uint8, device="cuda")
    exported = torch.export.export(Two(), (x,), strict=False)
    torch._inductor.aoti_compile_and_package(exported, package_path=base + ".pt2",
                                             inductor_configs={"cpp.cxx": (None, cxx())})
    with open(base + ".sig", "w") as f:
        f.write(f"u8 1 {size} {size} 3\nu8 1 {size} {size} 3\n")
    return base


def runner_http(base, img, python_bytes, two_base):
    """aoti_runner --serve over the bundle: /healthz, /dehaze (the package's
    bytes in Python), /stats, a reload of a package of two outputs (refused,
    reported, the old one serving: ADVICE r5 fault 2), a .sig mismatch
    (409), Content-Length: 0 (the current bundle re-promoted). Returns the
    numbers; raises on any disagreement."""
    import socket

    from fdgan_tpu_torch.ops import build

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([str(build.aoti_runner()), base, "--ops", str(build.torch_ops_library()), "--serve",
                             str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"aoti_runner --serve exited: {proc.stdout.read()}")
            try:
                if http_request(port, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("aoti_runner --serve never came up")
                time.sleep(0.2)
        out["startup_s"] = time.perf_counter() - t0
        lat = []
        for _ in range(EXPORT_LOOPS):
            t = time.perf_counter()
            status, headers, data = http_request(port, "POST", "/dehaze", img.tobytes())
            lat.append(1000 * (time.perf_counter() - t))
            if status != 200 or data != python_bytes.tobytes():
                raise AssertionError(f"/dehaze: {status}, the package's bytes in Python: {data == python_bytes.tobytes()}")
        if (headers["X-Image-Shape"], headers["X-Image-Dtype"]) != (f"{EXPORT_BUNDLE}x{EXPORT_BUNDLE}x3", "uint8"):
            raise AssertionError(f"/dehaze headers {headers}")
        out["request_ms"] = {"median": statistics.median(lat), "all": lat}

        def wait_idle():
            t = time.perf_counter()
            while True:
                st = json.loads(http_request(port, "GET", "/stats")[2])
                if not st["reloading"]:
                    return st
                if time.perf_counter() - t > 300:
                    raise AssertionError("a reload never finished")
                time.sleep(0.2)

        status, _, data = http_request(port, "POST", "/reload", two_base.encode())
        if status != 202:
            raise AssertionError(f"reload of the two-output package: {status} {data}")
        st = wait_idle()
        if st["weights_version"] != 0 or "outputs" not in st["last_reload_error"] or st["bundle"] != base:
            raise AssertionError(f"the two-output package was not refused: {st}")
        out["fault2_error"] = st["last_reload_error"][:200]
        if http_request(port, "POST", "/dehaze", img.tobytes())[2] != python_bytes.tobytes():
            raise AssertionError("the old package stopped serving after a refused reload")
        with open(base + "_other.sig", "w") as f:
            f.write("u8 1 8 8 3\nu8 1 8 8 3\n")
        status, _, _ = http_request(port, "POST", "/reload", (base + "_other").encode())
        if status != 409:
            raise AssertionError(f"a .sig mismatch gave {status}, not 409")
        status, _, _ = http_request(port, "POST", "/reload", b"")
        st = wait_idle()
        if status != 202 or json.loads(http_request(port, "GET", "/healthz")[2])["weights_version"] != 1:
            raise AssertionError(f"re-promotion: {status} {st}")
        if http_request(port, "POST", "/dehaze", img.tobytes())[2] != python_bytes.tobytes():
            raise AssertionError("the re-promoted package gives other bytes")
        st = json.loads(http_request(port, "GET", "/stats")[2])
        out["stats"] = {k: st[k] for k in ("served", "mean_inference_s", "weights_version", "launches", "device")}
        # every forward: the startup check, the warm-up, the served requests, the reload check
        forwards = 2 + st["served"] + 1
        if st["launches"]["dense_layer"] != 42 * forwards or st["launches"]["h_stats"] or st["launches"]["channel_stats"]:
            raise AssertionError(f"the runner's launches {st['launches']} over {forwards} forwards")
    finally:
        proc.kill()
        proc.wait()
    return out


def phase_export():
    """Phase 13: the export path (``io.export``, ``native/``). Returns the
    phase's numbers and the launches of a forward through it by kernel."""
    import torch

    from fdgan_tpu_torch.io.export import ArtifactRunner, export_forward, export_native_bundle, load_exported, save_exported
    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.models.fdgan import FDGAN
    from fdgan_tpu_torch.ops import build
    from fdgan_tpu_torch.serve import InferenceEngine
    from fdgan_tpu_torch.tools import check_native

    t_phase = time.perf_counter()
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    model = model.cuda().eval()
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(13)
    out, launches = {"programs": {}}, {}
    os.makedirs("build/export", exist_ok=True)
    for name, (b, s), precision, mode in EXPORT_PROGRAMS:
        t0 = time.perf_counter()
        with exact_fp32():
            ep = export_forward(model, image_size=s, batch=b, precision=precision, bn_mode=mode, device="cuda")
        t1 = time.perf_counter()
        path = f"build/export/{name}.pt2"
        mb = save_exported(path, ep) / 1e6
        t2 = time.perf_counter()
        ep = load_exported(path)  # the loaded program runs below
        t3 = time.perf_counter()
        fn = ep.module()
        x = torch.rand((b, s, s, 3), device="cuda", generator=gen)
        row = {"shape": [b, s, s], "precision": precision, "bn_mode": mode, "export_s": t1 - t0, "save_s": t2 - t1,
               "load_s": t3 - t2, "mb": mb}
        with torch.inference_mode(), exact_fp32():
            eager = fdgan_fast.apply(model if precision == "fp32" else bf16,
                                     x if precision == "fp32" else x.bfloat16(), bn_mode=mode).float()
            reset_all_counts()
            rec = {}
            with checked_op_launches(rec):
                got = fn(x)
            torch.cuda.synchronize()
            row["launches"] = all_counts()
            row["checked"] = rec
            want = {"k1": 42, "k2": 42 if mode == "batch" else 0, "k3": 0,
                    "channel_stats": 45 if (mode, precision) == ("batch", "bf16") else 0}
            if row["launches"] != want or {k: rec[k] for k in ("k1", "k2", "channel_stats")} != {
                    k: want[k] for k in ("k1", "k2", "channel_stats")}:
                raise AssertionError(f"export {name}: launches {row['launches']}, checked {rec}, want {want}")
            row["max_abs_err_vs_eager"] = (got - eager).abs().max().item()
            if precision == "fp32":
                if not torch.allclose(got, eager, **GEN_TOL):
                    raise AssertionError(f"export {name}: the fp32 program against the eager forward: {row}")
            else:
                ref = fdgan_fast.apply(model, x, bn_mode=mode)  # fp32, the kernels, TF32 off
                row["psnr"], row["eager_psnr"] = psnr(got, ref), psnr(eager, ref)
                if row["psnr"] < row["eager_psnr"] - 1.0:
                    raise AssertionError(f"export {name}: the bf16 program's PSNR: {row}")
            if name == "serve":
                fns = {"eager": lambda t: fdgan_fast.apply(bf16, t.bfloat16(), bn_mode=mode), "exported": fn}
                row["turns"] = export_turns(fns, x)
                row["profile"] = export_profiles(fns, x)
        log(f"export {name} {json.dumps(row)}")
        out["programs"][name] = row
        launches[f"{precision}_{mode}"] = row["launches"]
        del ep, fn
        torch.cuda.empty_cache()

    # the package: export_native_bundle at 1x512^2 bf16 running BN, uint8
    base = "build/export/fdgan_512"
    bundle = export_native_bundle(model, base, image_size=EXPORT_BUNDLE, batch=1, precision="bf16",
                                  bn_mode="running", io="uint8", device="cuda")
    out["bundle"] = {"seconds": bundle["seconds"], "mb": {k: os.path.getsize(bundle[k]) / 1e6 for k in ("pt2", "ep")},
                     "sig": open(bundle["sig"]).read().split("\n")[:2]}
    t0 = time.perf_counter()
    package = torch._inductor.aoti_load_package(bundle["pt2"])
    out["bundle"]["load_s"] = time.perf_counter() - t0
    img = check_native.sample_image(EXPORT_BUNDLE)
    xu = torch.from_numpy(img[None]).cuda()
    with torch.inference_mode():
        reset_all_counts()
        rec, result = {}, []
        with checked_op_launches(rec):  # the profiled forward is the checked one: each K1 ran and was right
            names = kernel_counts(lambda: result.append(package(xu)[0]))
        pkg_launches = all_counts()
        python_bytes = result[0].cpu().numpy()
    if pkg_launches["k1"] != 42 or rec["k1"] != 42:
        raise AssertionError(f"the package in Python: launches {pkg_launches}, checked {rec}")
    # reported, not gated: in a process that has profiled before, the trace has lacked 3-5 of the 42 K1
    # kernels of a package's forward whose 42 launches the counters and the twin checks saw
    out["bundle"].update(python_launches=pkg_launches, checked=rec, profiler_kernels=names)
    log(f"export package: K1 launches {pkg_launches['k1']}, checked {rec['k1']}, named in the profiler's trace "
        f"{names['dense_layer_bf16_kernel']}")
    native = check_native.run_native(base, img, loops=EXPORT_LOOPS)
    if not np.array_equal(native["output"], python_bytes):
        raise AssertionError("aoti_runner --ops gives other bytes than the package in Python")
    if native["launches"] != {"dense_layer": 42 * (EXPORT_LOOPS + 1), "h_stats": 0, "channel_stats": 0}:
        raise AssertionError(f"aoti_runner's launches {native['launches']} over {EXPORT_LOOPS} + 1 forwards")
    bare = subprocess.run([str(build.aoti_runner()), base], capture_output=True, text=True, timeout=600)
    if bare.returncode == 0 or "--ops" not in bare.stderr:
        raise AssertionError(f"the CUDA package without --ops: rc {bare.returncode}, {bare.stderr[-500:]}")
    program = ArtifactRunner(bundle["ep"])([img])[0]
    engine = InferenceEngine(model, device="cuda", precision="bf16", bn_mode="running", batch_sizes=(1,),
                             input="uint8", output="uint8")
    try:
        eager_bytes = engine.predict(img)
    finally:
        engine.close()
    levels = {k: int(np.abs(v.astype(np.int16) - eager_bytes.astype(np.int16)).max())
              for k, v in (("package", python_bytes), ("runner", native["output"]), ("program", program))}
    out["bundle"]["levels_vs_eager"] = levels
    if max(levels.values()) > 1:
        raise AssertionError(f"an artifact's output is more than one level from the eager engine's: {levels}")

    def eager_u8(t):
        y = fdgan_fast.apply(bf16, (t.float() / 255.0).bfloat16(), bn_mode="running")
        return torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0.0, 255.0).to(torch.uint8)

    ep_fn = load_exported(bundle["ep"]).module()
    with torch.inference_mode():
        fns = {"eager": eager_u8, "exported": ep_fn, "package": package}
        out["bundle"]["turns"] = export_turns(fns, xu)
        out["bundle"]["profile"] = export_profiles(fns, xu)
        req = []
        for _ in range(EXPORT_LOOPS):  # a request as the runner serves one: upload, run, fetch
            t = time.perf_counter()
            package(torch.from_numpy(img[None]).cuda())[0].cpu()
            req.append(1000 * (time.perf_counter() - t))
    out["bundle"]["python_request_ms"] = {"median": statistics.median(req), "all": req}
    out["bundle"]["runner_request_ms"] = {"median": 1000 * statistics.median(native["seconds"]),
                                         "all": [1000 * s for s in native["seconds"]]}
    two = arity_two_bundle("build/export/two_outputs", EXPORT_BUNDLE)
    out["bundle"]["http"] = runner_http(base, img, python_bytes, two)
    del package, ep_fn
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13: {out['seconds']:.1f} s")
    return out, launches


# phase 14: the device-resident loop at phase 5's cell (4×256² bf16, no perceptual term), K steps a chunk over
# DEVICE_LOOP_BATCHES staged batches; the pool loop over DEVICE_POOL's chunks; the device eval on DEVICE_EVAL's
# fp32 val images; cli/train --deviceSteps at DEVICE_CLI
DEVICE_LOOP = (4, 256, 10)
DEVICE_LOOP_BATCHES = 5
DEVICE_POOL = (50, 3)
DEVICE_EVAL = (4, 256)
DEVICE_EVAL_RTOL = 1e-4  # the device eval against the host eval: JAX's tests/test_train.py:232 gate
DEVICE_CLI = dict(batch=4, size=256, batches=5, epochs=2, k=10)


@contextlib.contextmanager
def no_host_sync():
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block: an
    operation that makes the host wait on the device raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def host_state(state) -> dict:
    """Copies on the host of every tensor a checkpoint file holds of
    ``state``, and its counts."""
    out = {net: {k: v.detach().cpu().clone() for k, v in getattr(state, net).state_dict().items()} for net in "gd"}
    for net in ("g_opt", "d_opt"):
        out[net] = {i: {k: v.detach().cpu().clone() for k, v in e.items()}
                    for i, e in getattr(state, net).state_dict()["state"].items()}
    out["step"], out["d_updates"] = state.step, state.d_updates
    return out


def file_is(path, want: dict) -> bool:
    """The checkpoint file at ``path`` holds exactly ``want`` (host_state's)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    same = (blob["step"], blob["d_updates"]) == (want["step"], want["d_updates"])
    for net in ("g", "d"):
        same &= blob[net].keys() == want[net].keys() and all(torch.equal(blob[net][k], v) for k, v in want[net].items())
    for net in ("g_opt", "d_opt"):
        saved = blob[net]["state"]
        same &= saved.keys() == want[net].keys() and all(
            torch.equal(saved[i][k], v) for i, e in want[net].items() for k, v in e.items())
    return bool(same)


def phase_device_loop():
    """Phase 14: device-resident training (``train/loop.py``'s device loops,
    ``make_device_eval``, ``io/checkpoint.AsyncCheckpointer``, ``cli/train
    --deviceSteps``) at phase 5's cell. (1) The path: one chunk of
    ``make_device_loop`` (K steps) under sync debug mode "error", the
    counters zeroed just before and read just after (launches per step K1
    42, K2 42, K3 3, channel_stats 54), against K streaming steps on the same
    batches (each uploaded from the host as the CLI's loop does) at phase
    5's criteria, both under torch's deterministic algorithms; (2) the pool
    loop, DEVICE_POOL's chunks, under "error" too; (3) img/s of a chunk in
    turns with phase 8's streaming loop (the CLI's loop body: an upload a
    step, the metrics read every 5 steps); (4) ``make_device_eval`` against
    the host ``cli.train.evaluate`` on DEVICE_EVAL's fp32 val images; (5) an
    ``AsyncCheckpointer`` save during a chunk, whose file is the state at
    ``save()``, the ms the loop loses to it against a blocking save; (6)
    ``cli.train.train --deviceSteps`` over in-memory loaders. Returns the
    phase's numbers and the launches of (1)."""
    import os
    import shutil

    import torch

    from fdgan_tpu_torch.cli import train as cli
    from fdgan_tpu_torch.data.h5 import DataLoader
    from fdgan_tpu_torch.io.checkpoint import AsyncCheckpointer, save_checkpoint
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import (create_train_state, make_device_eval, make_device_loop,
                                            make_device_pool_loop, make_gd_steps, make_train_step)
    from fdgan_tpu_torch.train.pool import device_pool_init

    t0 = time.perf_counter()
    root = os.path.join("build", "device_loop")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    b, size, k = DEVICE_LOOP
    nb = DEVICE_LOOP_BATCHES
    data = pairs(b * nb, size, 40)
    haze_np = np.stack([np.stack([h for h, _ in data[i * b:(i + 1) * b]]) for i in range(nb)])
    gt_np = np.stack([np.stack([g for _, g in data[i * b:(i + 1) * b]]) for i in range(nb)])
    # staged as the CLI stages a bf16 run: cast on the host, uploaded once
    haze_all = torch.from_numpy(haze_np).to(torch.bfloat16).cuda()
    gt_all = torch.from_numpy(gt_np).to(torch.bfloat16).cuda()
    seq = torch.from_numpy(cli.index_sequence(nb, 8 * k // nb, k, 0)).cuda()
    host_seq = seq.cpu().numpy()
    weights = LossWeights(perceptual=0.0)

    def upload(i):  # the streaming loop's batch: fp32 from the host, as the CLI's loop uploads it
        return (torch.from_numpy(np.ascontiguousarray(haze_np[i], np.float32)).cuda(),
                torch.from_numpy(np.ascontiguousarray(gt_np[i], np.float32)).cuda())

    # (1) the path: a chunk with no host sync against K streaming steps, from one state each
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sides = {}
        for side in ("device", "stream"):
            state, tx_g, tx_d = create_train_state(0, device="cuda")
            step = make_train_step(tx_g, tx_d, weights, compute_dtype=torch.bfloat16)
            state, _ = step(state, *upload(0))  # one step each first: cuDNN's choices, the allocator
            sides[side] = [state, step]
        run = make_device_loop(sides["device"][1], k)
        reset_all_counts()
        with no_host_sync():
            sides["device"][0], ms = run(sides["device"][0], haze_all, gt_all, seq[:k])
        torch.cuda.synchronize()
        launches = all_counts()
        stream = []
        for i in host_seq[:k]:
            sides["stream"][0], m = sides["stream"][1](sides["stream"][0], *upload(i))
            stream.append(m)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    got = {key: v.float().cpu().numpy() for key, v in ms.items()}
    want = {key: torch.stack([m[key] for m in stream]).float().cpu().numpy() for key in ms}
    loss_err = max(float(np.max(np.abs(got[key] - want[key]) / np.maximum(np.abs(want[key]), 1e-6))) for key in got)
    off, worst_p, worst_s = compare_states(sides["device"][0], sides["stream"][0])
    per_step = {key: v / k for key, v in launches.items()}
    out["chunk_vs_stream"] = {"steps": k, "loss_max_rel_err": loss_err,
                              "bit_equal": all(np.array_equal(got[key], want[key]) for key in got),
                              "param_share_over_1e-6": off, "param_max_abs_err": worst_p,
                              "running_stat_max_abs_err": worst_s, "launches_per_step": per_step,
                              "g_total": got["g_total"].tolist()}
    log(f"device loop {b}x{size}^2 bf16 K={k}, no host sync: {json.dumps(out['chunk_vs_stream'])}")
    finite = all(np.isfinite(v).all() for v in got.values())
    if not (finite and loss_err <= 1e-4 and off < 5e-3 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5
            and per_step == REMAT_LAUNCHES["none"]):
        raise AssertionError(f"the device loop's chunk disagrees with the streaming steps: {out['chunk_vs_stream']}")

    # (2) the pool loop: a warm step, then DEVICE_POOL's chunks with no host sync
    pool_size, chunks = DEVICE_POOL
    state, tx_g, tx_d = create_train_state(0, device="cuda")
    g_step, d_step = make_gd_steps(tx_g, tx_d, weights, compute_dtype=torch.bfloat16)
    buf, n_filled = device_pool_init(pool_size, haze_all.shape[1:], torch.bfloat16, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    state, buf, n_filled, _ = make_device_pool_loop(g_step, d_step, 1)(state, buf, n_filled, haze_all, gt_all,
                                                                        seq[:1], gen)
    run_pool = make_device_pool_loop(g_step, d_step, k)
    reset_all_counts()
    pool_g = []
    with no_host_sync():
        for c in range(chunks):
            state, buf, n_filled, m = run_pool(state, buf, n_filled, haze_all, gt_all, seq[c * k:(c + 1) * k], gen)
            pool_g.append(m["g_total"])
    torch.cuda.synchronize()
    pool_launches = {key: v / (chunks * k) for key, v in all_counts().items()}
    out["pool"] = {"pool_size": pool_size, "chunks": chunks, "n_filled": int(n_filled),
                   "g_total": torch.cat(pool_g).float().cpu().tolist(), "launches_per_step": pool_launches}
    log(f"device pool loop: {json.dumps(out['pool'])}")
    if not (int(n_filled) == 1 + chunks * k and np.isfinite(out["pool"]["g_total"]).all()
            and pool_launches == REMAT_LAUNCHES["none"]):
        raise AssertionError(f"the device pool loop: {out['pool']}")
    del state, buf, g_step, d_step
    torch.cuda.empty_cache()

    # (3) img/s: a chunk against phase 8's streaming loop, in turns (device, stream, stream, device)
    def device_turn(state, c):
        state, m = run(state, haze_all, gt_all, seq[c * k:(c + 1) * k])
        torch.stack([v.float() for v in m.values()]).cpu()  # the chunk's one fetch
        return state

    def stream_turn(state, c):
        step = sides["stream"][1]
        for i in host_seq[c * k:(c + 1) * k]:
            state, m = step(state, *upload(i))
            if state.step % 5 == 0:
                _ = {key: float(v) for key, v in m.items()}
        return state

    spent = {"device": [], "stream": []}
    for c, side in enumerate(("device", "stream", "stream", "device"), start=1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sides[side][0] = (device_turn if side == "device" else stream_turn)(sides[side][0], c)
        torch.cuda.synchronize()
        spent[side].append(time.perf_counter() - t)
    out["img_s"] = {side: [b * k / sec for sec in secs] for side, secs in spent.items()}
    out["device_over_stream"] = sum(spent["stream"]) / sum(spent["device"])
    log(f"device loop img/s in turns against the streaming loop: {json.dumps(out['img_s'])}, "
        f"{out['device_over_stream']:.3f}x")

    # (4) the device eval against the host eval
    val = pairs(DEVICE_EVAL[0], DEVICE_EVAL[1], 41)
    g = sides["device"][0].g
    evaluate = make_device_eval(np.stack([h[None] for h, _ in val]), np.stack([y[None] for _, y in val]), "cuda")
    reset_all_counts()
    t = time.perf_counter()
    dev = evaluate(g)
    dev_ms = 1000 * (time.perf_counter() - t)
    eval_launches = {key: v / len(val) for key, v in all_counts().items()}
    t = time.perf_counter()
    host = cli.evaluate(g, DataLoader(val, batch_size=1), "cuda")
    host_ms = 1000 * (time.perf_counter() - t)
    rel = [abs(a - h) / abs(h) for a, h in zip(dev, host)]
    out["eval"] = {"images": len(val), "device": list(dev), "host": list(host), "rel_err": rel, "device_ms": dev_ms,
                   "host_ms": host_ms, "launches_per_image": eval_launches}
    log(f"device eval {DEVICE_EVAL[0]}x{DEVICE_EVAL[1]}^2 fp32 against the host eval: {json.dumps(out['eval'])}")
    if not (max(rel) <= DEVICE_EVAL_RTOL and eval_launches == {"k1": 42, "k2": 42, "k3": 0, "channel_stats": 0}):
        raise AssertionError(f"the device eval: {out['eval']}")

    # (5) an async save during a chunk: the file is the state at save(); the loop's loss against a blocking save
    state = sides["device"][0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = device_turn(state, 5)
    alone = time.perf_counter() - t
    want = host_state(state)
    saver = AsyncCheckpointer()
    torch.cuda.synchronize()
    t = time.perf_counter()
    saver.save(os.path.join(root, "async"), state, step=state.step)
    call = time.perf_counter() - t
    state = device_turn(state, 6)
    with_save = time.perf_counter() - t
    t = time.perf_counter()
    saver.wait()
    tail = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_checkpoint(os.path.join(root, "blocking"), state, step=state.step)
    torch.cuda.synchronize()
    blocking = time.perf_counter() - t
    same = file_is(os.path.join(root, "async", f"ckpt_{want['step']}.pt"), want)
    out["async_ckpt"] = {"file_is_state_at_save": same, "save_call_ms": 1000 * call, "chunk_ms": 1000 * alone,
                         "chunk_with_save_ms": 1000 * with_save, "stall_ms": 1000 * (with_save - alone),
                         "wait_after_ms": 1000 * tail, "blocking_save_ms": 1000 * blocking,
                         "mb": os.path.getsize(os.path.join(root, "blocking", f"ckpt_{state.step}.pt")) / 1e6}
    log(f"async checkpoint during a chunk: {json.dumps(out['async_ckpt'])}")
    if not same:
        raise AssertionError("the async checkpoint's file is not the state at save()")
    del sides, state, run
    torch.cuda.empty_cache()

    # (6) cli/train --deviceSteps over in-memory loaders
    c = DEVICE_CLI
    exp = os.path.join(root, "cli")
    train_pairs, val_pairs = pairs(c["batch"] * c["batches"], c["size"], 42), pairs(2, c["size"], 43)
    args = ["--exp", exp, "--precision", "bf16", "--lambdaPerceptual", "0", "--deviceSteps", str(c["k"]),
            "--poolSize", "50", "--epochs", str(c["epochs"]), "--batchSize", str(c["batch"]), "--imageSize",
            str(c["size"]), "--logEvery", "5", "--evalIter", str(c["k"])]
    state, stdout, records = run_cli(args, DataLoader(train_pairs, batch_size=c["batch"], shuffle=True, seed=0),
                                     DataLoader(val_pairs, batch_size=1))
    steps = c["batches"] * c["epochs"]
    logged = [(r["step"], r["g_total"]) for r in records if "g_total" in r]
    val_steps = [r["step"] for r in records if "val_psnr" in r]
    out["cli"] = {"steps": state.step, "logged": logged, "val_steps": val_steps,
                  "img_s": [r["imgs_per_sec"] for r in records if "imgs_per_sec" in r], "files": sorted(os.listdir(exp))}
    log(f"cli.train --deviceSteps {c['k']}: {json.dumps(out['cli'])}")
    checks = {"steps": state.step == steps and [s for s, _ in logged] == list(range(5, steps + 1, 5)),
              "finite": bool(np.isfinite([v for _, v in logged]).all()),
              "staged": f"staging {c['batches']} batches" in stdout and "snapshot queued" in stdout,
              "evals": val_steps == [0, steps],
              "checkpoint": out["cli"]["files"] == [f"ckpt_{steps}.pt", "train_log.jsonl"]
              and same_as_file(state, os.path.join(exp, f"ckpt_{steps}.pt"))}
    if not all(checks.values()):
        raise AssertionError(f"cli.train --deviceSteps: failed checks {[n for n, v in checks.items() if not v]}")
    del state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14: {out['seconds']:.1f} s")
    return out, launches


# DehazeFormer-B's attending stages at the bulk cell's launch shape (8x460x620):
# (B, H, W, C, heads, attending blocks a forward)
WATTN_STAGES = [(8, 460, 620, 24, 2, 4), (8, 230, 310, 48, 4, 8), (8, 115, 155, 96, 6, 12)]
WATTN_TOL = dict(atol=1.5e-2, rtol=1.6e-2)  # tests/test_torch_cuda.py's


def wattn_bound_ms(b, h, w, c):
    """The least time of one launch: 4*64*C operations a padded token against
    the bf16 peak, QK and V read and O written once a real pixel in bf16
    against the memory bandwidth."""
    tokens = b * (-(-h // 8) * 8) * (-(-w // 8) * 8)
    ops, nbytes = 256 * c * tokens, 8 * c * b * h * w
    return 1e3 * max(ops / 989e12, nbytes / 3.35e12), "bytes" if nbytes / 3.35e12 > ops / 989e12 else "operations"


def phase_window_attention():
    """DehazeFormer's window attention kernel against its plain version at
    the bulk cell's stage shapes, both shifts (max abs error, the test's
    tolerance), its times (with the wrapper, on the device alone), the
    plain version's and scaled_dot_product_attention's on the windows
    already split (bias as its mask: the yardstick), and DehazeFormer-B
    through the engine at 8x460x620 bf16 (launches by the counter zeroed
    just before, device operations by the trace, ms, the host's enqueue of
    one forward from an idle device). Returns the kernels-table row."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from fdgan_tpu_torch.cli._common import maybe_profile
    from fdgan_tpu_torch.models.dehazeformer import dehazeformer_b
    from fdgan_tpu_torch.ops import window_attention as wattn
    from fdgan_tpu_torch.serve import InferenceEngine
    from fdgan_tpu_torch.tools.timing import device_ms

    t0 = time.perf_counter()
    rows, worst = [], 0.0
    for b, h, w, c, heads, blocks in WATTN_STAGES:
        gen = torch.Generator(device="cuda").manual_seed(c)
        qk = torch.randn((b, h, w, 2 * c), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
        bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device="cuda")
        row = {"shape": [b, h, w, c], "heads": heads, "blocks": blocks}
        for shift in (0, 4):
            got = wattn.window_attention(qk, v, bias, heads, shift)
            want = wattn.reference(qk, v, bias, heads, shift)
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), **WATTN_TOL)
            worst = max(worst, err)
            row[f"max_abs_err_shift{shift}"] = err
            row[f"ms_shift{shift}"] = cuda_ms(lambda: wattn.window_attention(qk, v, bias, heads, shift))
            row[f"device_ms_shift{shift}"] = device_ms(lambda: wattn.window_attention(qk, v, bias, heads, shift))
        row["plain_ms"] = cuda_ms(lambda: wattn.reference(qk, v, bias, heads, 0), reps=3, warmup=1)
        hd = c // heads
        nw = b * (-(-h // 8)) * (-(-w // 8))
        q3 = torch.randn((nw, heads, 64, hd), generator=gen, device="cuda").to(torch.bfloat16)
        mask = bias.to(torch.bfloat16)[None]
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q3, q3, q3, attn_mask=mask))
        row["bound_ms"], row["bound_by"] = wattn_bound_ms(b, h, w, c)
        rows.append(row)
        log(f"window_attention {json.dumps(row)}")
        del qk, v, got, want, q3
        torch.cuda.empty_cache()
    # DehazeFormer-B through the engine, as the bulk cell and cli/serve --inDir run it
    eng = InferenceEngine(dehazeformer_b(device="cuda"), device="cuda", precision="bf16", bucket=4,
                          input="uint8", output="uint8")
    eng.warmup([(460, 620)], batch=8)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (460, 620, 3), dtype=np.uint8) for _ in range(8)]
    # the main path's run: the counter from 0, read right after
    wattn.reset_launch_count()
    out = eng.predict_batch(images)
    torch.cuda.synchronize()
    per_batch = wattn.launches
    if per_batch != sum(r["blocks"] for r in rows):
        raise AssertionError(f"window_attention launched {per_batch} times a batch through the engine, not 24")
    if any(y.shape != img.shape or y.dtype != np.uint8 for img, y in zip(images, out)):
        raise AssertionError("the engine's uint8 results do not match their inputs' shapes")
    batch_ms = cuda_ms(lambda: eng.predict_batch(images), reps=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    eng.predict_batch(images)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as tmp:  # every device operation of one batch
        with maybe_profile(tmp):
            eng.predict_batch(images)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "trace.json")) as f:
            cats = collections.Counter(e.get("cat") for e in json.load(f)["traceEvents"]
                                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    # the host's enqueue of one forward with the device idle before it: the
    # dehazeformer.forward span's cost where no full launch queue paces it
    model = eng._model
    x = model.input_map(torch.from_numpy(np.stack(images)).cuda()).to(torch.bfloat16)
    host = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.serve_forward(x, "running")
            host.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
    forward = {"path": "InferenceEngine.predict_batch, bf16, bucket 4, uint8", "shape": [8, 460, 620],
               "launches": per_batch, "device_kernels": cats["kernel"], "device_copies": cats["gpu_memcpy"],
               "device_memsets": cats["gpu_memset"], "ms": batch_ms, "img_s": 8e3 / batch_ms,
               "host_enqueue_ms_from_idle": statistics.median(host[1:]), "peak_gib": peak}
    log(f"dehazeformer_b engine batch {json.dumps(forward)}")
    # the row of the first stage (the most of the kernel's bytes), with the
    # forward's time share: 24 launches a forward against the whole forward
    first = rows[0]
    kernel_ms = sum(r["blocks"] * (r["device_ms_shift0"] + r["device_ms_shift4"]) / 2 for r in rows)
    bound = sum(r["blocks"] * r["bound_ms"] for r in rows)
    del eng, model, x
    torch.cuda.empty_cache()
    log(f"phase window attention: {time.perf_counter() - t0:.1f} s")
    return {"name": "window_attention", "route": "cuda", "source": "fdgan_tpu_torch/csrc/window_attention.cu",
            "replaces": "none: added for DehazeFormer (bound by bytes, 32 FLOP/byte)",
            "launches": per_batch, "launches_by_path": {"engine_predict_batch": per_batch},
            "max_abs_err": worst, "ms": first["ms_shift0"], "device_ms": first["device_ms_shift0"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "forward_kernel_ms": kernel_ms, "forward_bound_ms": bound,
            "forward": forward, "stages": rows, "timed_at": first["shape"] + ["bfloat16", "shift 0"],
            "err_of": "bf16, three stage shapes, both shifts"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import fdgan_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references run in full fp32
    if sys.argv[1:] == ["--dp-ranks"]:
        return dp_ranks_main()
    if sys.argv[1:] == ["--mesh-ranks"]:
        return mesh_ranks_main()
    if sys.argv[1:] == ["--sp-ranks"]:
        return sp_ranks_main()
    if sys.argv[1:] == ["--window-attention"]:
        phase_device()
        print(json.dumps({"kernels": [phase_window_attention()]}))
        return 0
    t_start = time.perf_counter()
    phase_device()
    rows, worst, tf32x3_ceiling = phase_kernels()
    stats_timed, stats_worst = phase_channel_stats()
    model, gen = phase_generator()
    log(json.dumps({"generator": gen}))
    launches, serving = phase_serving(model)
    serving["warm"], warm_launches = phase_warmup(model)
    log(json.dumps({"serving": serving}))
    del model
    torch.cuda.empty_cache()
    k3_rows, k3_worst = phase_k3()
    grad_err = phase_gradients()
    train_fp32 = phase_train_fp32()
    training, train_launches = phase_training()
    log(json.dumps({"training": training, "train_fp32": train_fp32, "gradients_max_abs_err": grad_err}))
    torch.cuda.empty_cache()
    probe_rows, probe_errs, probe_launches = phase_probes()
    torch.cuda.empty_cache()
    demo, demo_launches, demo_probe_launches = phase_demo()
    log(json.dumps({"demo": demo}))
    torch.cuda.empty_cache()
    train_cli, cli_launches = phase_train_cli(training["kernels"]["img_s"])
    log(json.dumps({"train_cli": train_cli}))
    torch.cuda.empty_cache()
    zoo, zoo_launches = phase_zoo()
    log(json.dumps({"zoo": zoo}))
    torch.cuda.empty_cache()
    dp, dp_launches = phase_dp()
    log(json.dumps({"dp": dp}))
    torch.cuda.empty_cache()
    mesh_out, mesh_launches = phase_mesh()
    log(json.dumps({"mesh": mesh_out}))
    torch.cuda.empty_cache()
    sp_out, sp_launches = phase_sp()
    log(json.dumps({"sp": sp_out}))
    torch.cuda.empty_cache()
    export_out, export_launches = phase_export()
    log(json.dumps({"export": export_out}))
    torch.cuda.empty_cache()
    device_out, device_launches = phase_device_loop()
    log(json.dumps({"device_loop": device_out}))
    torch.cuda.empty_cache()
    wattn_row = phase_window_attention()
    ragged_c = {f"c{r['shape'][-1]}": {k: r[k] for k in r if k.startswith(("k1_", "k2_"))} | {"shape": r["shape"]}
                for r in zoo["kernels_ragged_c"] if r["dtype"] == "bfloat16"}
    timed = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}[TIMED_SHAPE]
    timed32 = {tuple(r["shape"]): r for r in rows if r["dtype"] == "float32"}[DEMO_LAYER]
    demo32 = demo["launches_per_run"]["fp32"]  # the demo's default: 2 images of 1024², 1200x1600 and 1021x1533
    k3_timed = {tuple(r["shape"]): r for r in k3_rows if r["dtype"] == "bfloat16"}[K3_SHAPES[0]]
    k1_halo = {}  # the first case of each dtype in MESH_K1_CASES
    for r in mesh_out["k1_halo"]:
        k1_halo.setdefault(r["dtype"], {k: r[k] for k in ("shape", "shards", "halo_device_ms", "shard_device_ms")})
    k3_halo = {k: sp_out["k3_halo"][0][k] for k in ("shape", "bands", "halo_device_ms", "shard_device_ms")}

    def by_path(k):
        return {"serving": launches.get(k, 0), "training": train_launches[k], "probes": 0,
                "demo": demo_launches[k], "train_cli": cli_launches[k], "zoo": zoo_launches[k],
                "dp": dp_launches["bf16"][k] + (dp_launches["fp32"][k] if k == "k3" else 0),
                "mesh": mesh_launches["bf16"][k],
                "sp": sp_launches["bf16"][k] + (sp_launches["fp32"][k] if k == "k3" else 0),
                # a forward of the exported programs: K1 in running BN, K2 and channel_stats in bf16 batch BN
                "export": export_launches["bf16_batch"][k],
                "warmup": warm_launches.get(k, 0),  # phase 4's warmup: K1 42 a rung and shape
                "sp_cx": sp_launches["cx"][k],  # phase 12's contextual-term steps (fp32: no channel_stats)
                "device_loop": device_launches[k]}  # phase 14's chunk of K steps

    kernels = [
        {"name": "fused_dense_layer (K1)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:172", "launches": train_launches["k1"],
         "launches_by_path": by_path("k1"),
         "max_abs_err": worst["bfloat16"]["k1"], "ms": timed["k1_ms"], "plain_ms": timed["k1_plain_ms"],
         "bound_ms": timed["k1_bound_ms"], "bound_by": timed["k1_bound_by"], "library_ms": None,
         "device_ms": timed["k1_device_ms"],
         "view_device_ms": timed["k1_view_device_ms"],  # x and out channel slices of a buffer of ld 256
         "halo": k1_halo["bfloat16"],  # phase 11: a shard of 8x512^2x64 with its halo row, and without
         "at_ragged_c": {c: {k: v for k, v in r.items() if not k.startswith("k2_")} for c, r in ragged_c.items()},
         "timed_at": list(TIMED_SHAPE) + ["bfloat16"], "err_of": "bf16, all shapes"},
        {"name": "fused_dense_layer fp32 (K1, 3xTF32)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:172", "launches": demo32["k1"],
         "launches_by_path": {"demo_fp32": demo32["k1"], "dp": dp_launches["fp32"]["k1"],
                              "mesh": mesh_launches["fp32"]["k1"], "sp": sp_launches["fp32"]["k1"],
                              "sp_cx": sp_launches["cx"]["k1"], "export": export_launches["fp32_batch"]["k1"]},
         "max_abs_err": worst["float32"]["k1"], "ms": timed32["k1_ms"], "plain_ms": timed32["k1_plain_ms"],
         "bound_ms": timed32["k1_bound_ms"], "bound_by": timed32["k1_bound_by"],
         "cuda_core_bound_ms": timed32["k1_cuda_core_bound_ms"], "library_ms": None,
         "device_ms": timed32["k1_device_ms"], "view_device_ms": timed32["k1_view_device_ms"],
         "halo": k1_halo["float32"],  # phase 11: a shard of 1x1024^2x64 with its halo row, and without
         "tf32x3_ceiling_tflops": tf32x3_ceiling,  # what the 3xTF32 k-steps reach alone (fp32-product TFLOP/s)
         "timed_at": list(DEMO_LAYER) + ["float32"], "err_of": "fp32 against the twin in full fp32, all shapes"},
        {"name": "h_batch_stats (K2)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:323", "launches": train_launches["k2"],
         "launches_by_path": by_path("k2"),
         "max_abs_err": worst["bfloat16"]["k2"], "ms": timed["k2_ms"], "plain_ms": timed["k2_plain_ms"],
         "bound_ms": timed["k2_bound_ms"], "bound_by": timed["k2_bound_by"], "library_ms": None,
         "device_ms": timed["k2_device_ms"],
         "mma_ms": timed["k2_mma_ms"],  # the mma.sync body the wgmma kernel replaced, same run
         "mma_device_ms": timed["k2_mma_device_ms"],
         "at_ragged_c": {c: {k: v for k, v in r.items() if not k.startswith("k1_")} for c, r in ragged_c.items()},
         "timed_at": list(TIMED_SHAPE) + ["bfloat16"], "err_of": "bf16, all shapes"},
        {"name": "h_batch_stats fp32 (K2, 3xTF32)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:323", "launches": demo32["k2"],
         "launches_by_path": {"demo_fp32": demo32["k2"], "dp": dp_launches["fp32"]["k2"],
                              "mesh": mesh_launches["fp32"]["k2"], "sp": sp_launches["fp32"]["k2"],
                              "sp_cx": sp_launches["cx"]["k2"], "export": export_launches["fp32_batch"]["k2"]},
         "max_abs_err": worst["float32"]["k2"], "ms": timed32["k2_ms"], "plain_ms": timed32["k2_plain_ms"],
         "bound_ms": timed32["k2_bound_ms"], "bound_by": timed32["k2_bound_by"],
         "cuda_core_bound_ms": timed32["k2_cuda_core_bound_ms"], "library_ms": None,
         "device_ms": timed32["k2_device_ms"], "tf32x3_ceiling_tflops": tf32x3_ceiling,
         "timed_at": list(DEMO_LAYER) + ["float32"], "err_of": "fp32 against the twin in full fp32, all shapes"},
        {"name": "channel_stats", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/channel_stats.cu",
         "replaces": "none: XLA's fused reduction, fdgan_tpu/nn/layers.py:125-145",
         "launches": train_launches["channel_stats"], "launches_by_path": by_path("channel_stats"),
         "max_abs_err": stats_worst, "ms": stats_timed["512_slice"]["ms"],
         "plain_ms": stats_timed["512_slice"]["plain_ms"], "bound_ms": stats_timed["512_slice"]["bound_ms"],
         "bound_by": stats_timed["512_slice"]["bound_by"], "library_ms": stats_timed["512_slice"]["library_ms"],
         "device_ms": stats_timed["512_slice"]["device_ms"],
         "timed_at": stats_timed["512_slice"]["shape"] + ["bfloat16", f"ld {stats_timed['512_slice']['ld']}"],
         "err_of": "bf16, the 45 views of a batch-BN forward"},
        {"name": "frequency_fuse (K3)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/freq_filters.cu",
         "replaces": "fdgan_tpu/ops/pallas_filters.py:81", "launches": train_launches["k3"],
         "launches_by_path": by_path("k3"),
         "max_abs_err": k3_worst, "ms": k3_timed["k3_ms"], "plain_ms": k3_timed["k3_plain_ms"],
         "bound_ms": k3_timed["k3_bound_ms"], "bound_by": k3_timed["k3_bound_by"], "library_ms": None,
         "device_ms": k3_timed["k3_device_ms"],
         "halo": k3_halo,  # phase 12: the middle 256 rows of 8x512^2 bf16 with its 7 rows a side, and without
         "timed_at": list(K3_SHAPES[0]) + ["bfloat16"], "err_of": "fp32 (bit for bit) and bf16, all shapes"},
    ]
    for name, row in probe_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": "fdgan_tpu_torch/csrc/probes.cu", "replaces": row["replaces"],
            "launches": probe_launches[name],
            "launches_by_path": {"serving": 0, "training": 0, "probes": probe_launches[name],
                                 "demo": demo_probe_launches[name], "train_cli": 0, "zoo": 0, "dp": 0, "mesh": 0,
                                 "sp": 0, "export": 0, "warmup": 0, "sp_cx": 0, "device_loop": 0},
            "max_abs_err": probe_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "ms_spread": row["ms_spread"], "library_ms_spread": row["library_ms_spread"],  # in turns, where a library call
            "timed_at": row["shape"] + ["bfloat16"], "err_of": "bf16, full and ragged shapes"})
    kernels.append(wattn_row)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
