#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, kernel-probe, demo,
training-CLI and model-zoo paths once on one CUDA GPU, and check them.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

1. device and build: the card's name and power limit from nvidia-smi, then
   the kernels of fdgan_tpu_torch/csrc built from source;
2. kernels against their plain twins at the dense-layer shapes of the
   8×512² serving path and of the 4×256² train path (fp32 without TF32,
   and bf16), with CUDA-event times; K1 and K2 also from a channel slice of
   a wider buffer (the dense block's concat), K1 into one, held bit for bit
   against the contiguous launch; in bf16 K2 (wgmma) is also held against
   and timed beside its earlier mma.sync body;
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
   just after it: every kernel must have run in it;
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
   trace must name K1's kernel 42 times (and gives the device's busy time);
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
   x and from the concat buffer's slice (the same bits), with their times.

The line before the last holds the per-kernel summary as JSON (time, bound,
plain version's and library call's time, the probes' spreads in turns,
launches per path, the training CLI's and the zoo's included; K1's and K2's
times at C = 400 and 456); the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time

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
]
TIMED_SHAPE = SHAPES[0]
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
    output written once; bf16 products at the tensor cores' peak, fp32 ones
    at the CUDA cores'."""
    from fdgan_tpu_torch.tools.probes import bound_ms, nbytes

    npix, c = x.numel() // x.shape[-1], x.shape[-1]
    tensor_cores = x.element_size() == 2
    k1, k1_by = bound_ms(2 * npix * (c * 128 + 9 * 128 * 32),
                         nbytes(x, a1, b1, w1, a2, b2, w2) + npix * 32 * x.element_size(), tensor_cores)
    k2, k2_by = bound_ms(2 * npix * c * 128, nbytes(x, a1, b1, w1) + 2 * 128 * 4, tensor_cores)
    return {"k1_bound_ms": k1, "k1_bound_by": k1_by, "k2_bound_ms": k2, "k2_bound_by": k2_by}


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
    from fdgan_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {"k1": 0.0, "k2": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            x, a1, b1, w1, a2, b2, w2 = layer_inputs(shape, dtype, gen)
            bf16 = dtype == torch.bfloat16
            # a dense block's concat: ld 256 at the timed shape, as block 1's buffer
            xv, fv = buffer_view(x, max(256, shape[-1] + 32))
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
            if dtype == torch.float32:
                worst["k1"], worst["k2"] = max(worst["k1"], e1), max(worst["k2"], e2)
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
                    t["k2_mma_device_ms"] = device_ms(lambda: dense._launch_k2_mma(x, a1, b1, w1))
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "ld": xv.stride(2),
                   "k1_max_abs_err": e1, "k2_max_abs_err": e2, "k2_vs_mma_max_abs_err": e_mma, **t,
                   **dense_bounds(x, a1, b1, w1, a2, b2, w2)}
            rows.append(row)
            log(json.dumps(row))
            if not (ok1 and ok2 and ok_mma and ok_view and ok_again):
                raise AssertionError(f"kernel disagrees at {shape} {dtype}: K1 vs twin ok={ok1} err={e1}, K2 vs twin "
                                     f"ok={ok2} err={e2}, K2 vs its mma.sync body ok={ok_mma} err={e_mma}, "
                                     f"from a buffer view the same bits ok={ok_view}, K2 twice the same bits "
                                     f"ok={ok_again}")
            del x, xv, fv, f_k, f_p
            torch.cuda.empty_cache()
    return rows, worst


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
    # 6. one 1024² image per precision under the demo's profiler: the trace must name K1's kernel;
    # the device's busy time per image is the sum of its kernels and copies (one stream: no overlap)
    for prec in ("fp32", "bf16"):
        with tempfile.TemporaryDirectory() as tmp:
            with maybe_profile(tmp):
                ms = run(pairs[:1], precision=prec)[1][0]
            with open(os.path.join(tmp, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        k1 = f"dense_layer_{'f32' if prec == 'fp32' else 'bf16'}_kernel"
        on_device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        named = sum(1 for e in on_device if k1 in e.get("name", ""))
        busy = sum(e.get("dur", 0) for e in on_device) / 1000.0
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in on_device:
            # the port's kernels sit in an anonymous namespace: "(anonymous namespace)::dense_layer_f32_kernel(...)"
            row = by_name[e.get("name", "").replace("(anonymous namespace)::", "").split("(")[0][:80]]
            row[0] += e.get("dur", 0) / 1000.0
            row[1] += 1
        top = sorted(([n, ms_, c] for n, (ms_, c) in by_name.items()), key=lambda r: -r[1])[:8]
        out[f"{prec}_batch_1024x1024_profiled"] = {"ms": ms, "device_busy_ms": busy, "device_events": len(on_device),
                                                   "k1_events": named, "top_ms_count": top}
        log(f"demo profile {prec} 1024x1024: {ms:.2f} ms (profiled), device busy {busy:.2f} ms in "
            f"{len(on_device)} events, {named} named {k1}; largest (ms, count): "
            + "; ".join(f"{n} {t:.2f} x{c}" for n, t, c in top))
        if named != 42:
            raise AssertionError(f"the profiler's trace of the demo names {k1} {named} times, expected 42")
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

    def count_eval(orig):
        def wrapped(g, val, device, impl="kernels"):
            before = all_counts()
            res = orig(g, val, device, impl)
            torch.cuda.synchronize()
            evals["launches"].update({k: v - before[k] for k, v in all_counts().items()})
            evals["calls"] += 1
            evals["images"] += len(val_pairs)
            return res
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
    with patched(cli, "evaluate", count_eval), patched(cli, "save_checkpoint", timed_save), \
            patched(cli, "load_checkpoint", timed_load):
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import fdgan_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references run in full fp32
    t_start = time.perf_counter()
    phase_device()
    rows, worst = phase_kernels()
    stats_timed, stats_worst = phase_channel_stats()
    model, gen = phase_generator()
    log(json.dumps({"generator": gen}))
    launches, serving = phase_serving(model)
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
    ragged_c = {f"c{r['shape'][-1]}": {k: r[k] for k in r if k.startswith(("k1_", "k2_"))} | {"shape": r["shape"]}
                for r in zoo["kernels_ragged_c"] if r["dtype"] == "bfloat16"}
    timed = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}[TIMED_SHAPE]
    k3_timed = {tuple(r["shape"]): r for r in k3_rows if r["dtype"] == "bfloat16"}[K3_SHAPES[0]]

    def by_path(k):
        return {"serving": launches.get(k, 0), "training": train_launches[k], "probes": 0,
                "demo": demo_launches[k], "train_cli": cli_launches[k], "zoo": zoo_launches[k]}

    kernels = [
        {"name": "fused_dense_layer (K1)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:172", "launches": train_launches["k1"],
         "launches_by_path": by_path("k1"),
         "max_abs_err": worst["k1"], "ms": timed["k1_ms"], "plain_ms": timed["k1_plain_ms"],
         "bound_ms": timed["k1_bound_ms"], "bound_by": timed["k1_bound_by"], "library_ms": None,
         "device_ms": timed["k1_device_ms"],
         "view_device_ms": timed["k1_view_device_ms"],  # x and out channel slices of a buffer of ld 256
         "at_ragged_c": {c: {k: v for k, v in r.items() if not k.startswith("k2_")} for c, r in ragged_c.items()},
         "timed_at": list(TIMED_SHAPE) + ["bfloat16"], "err_of": "fp32, all shapes"},
        {"name": "h_batch_stats (K2)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:323", "launches": train_launches["k2"],
         "launches_by_path": by_path("k2"),
         "max_abs_err": worst["k2"], "ms": timed["k2_ms"], "plain_ms": timed["k2_plain_ms"],
         "bound_ms": timed["k2_bound_ms"], "bound_by": timed["k2_bound_by"], "library_ms": None,
         "device_ms": timed["k2_device_ms"],
         "mma_ms": timed["k2_mma_ms"],  # the mma.sync body the wgmma kernel replaced, same run
         "mma_device_ms": timed["k2_mma_device_ms"],
         "at_ragged_c": {c: {k: v for k, v in r.items() if not k.startswith("k1_")} for c, r in ragged_c.items()},
         "timed_at": list(TIMED_SHAPE) + ["bfloat16"], "err_of": "fp32, all shapes"},
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
         "timed_at": list(K3_SHAPES[0]) + ["bfloat16"], "err_of": "fp32 (bit for bit) and bf16, all shapes"},
    ]
    for name, row in probe_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": "fdgan_tpu_torch/csrc/probes.cu", "replaces": row["replaces"],
            "launches": probe_launches[name],
            "launches_by_path": {"serving": 0, "training": 0, "probes": probe_launches[name],
                                 "demo": demo_probe_launches[name], "train_cli": 0, "zoo": 0},
            "max_abs_err": probe_errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "ms_spread": row["ms_spread"], "library_ms_spread": row["library_ms_spread"],  # in turns, where a library call
            "timed_at": row["shape"] + ["bfloat16"], "err_of": "bf16, full and ragged shapes"})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
