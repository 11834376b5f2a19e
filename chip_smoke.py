#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and kernel-probe paths once on
one CUDA GPU, and check them.

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
   turns beside torch.mul's with the verdict.

The line before the last holds the per-kernel summary as JSON (time, bound,
plain version's and library call's time, the probes' spreads in turns,
launches per path); the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

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


def phase_train_fp32():
    """One fp32 step (TF32 off) from one state and batch, kernels against
    plain. Losses: rtol 1e-4. Parameters: Adam's first step moves each by
    ±lr wherever |g| ≫ ε, so gradient noise around 0 (conv biases under batch
    BN) can differ in sign between the two: ≤ 2·lr everywhere and ≤ 1e-6 on
    all but 0.5 % (tests/test_torch_train.py); running stats atol 1e-5."""
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
            _, m = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), impl=impl)(st, haze, gt)
            metrics[impl] = {k: v.item() for k, v in m.items()}
    loss_err = max(abs(v - metrics["plain"][k]) / max(abs(metrics["plain"][k]), 1e-6)
                   for k, v in metrics["kernels"].items())
    off, worst_p, worst_s = compare_states(states["kernels"], states["plain"])
    out = {"loss_max_rel_err": loss_err, "param_share_over_1e-6": off, "param_max_abs_err": worst_p,
           "running_stat_max_abs_err": worst_s, "losses": metrics["kernels"]}
    log(f"train fp32 2x64^2 kernels vs plain: {json.dumps(out)}")
    finite = all(np.isfinite(v) for v in metrics["kernels"].values())
    if not (finite and loss_err <= 1e-4 and off < 5e-3 and worst_p <= 2 * LR + 1e-6 and worst_s <= 1e-5):
        raise AssertionError("the fp32 train step with the kernels disagrees with the plain step")
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
    timed = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}[TIMED_SHAPE]
    k3_timed = {tuple(r["shape"]): r for r in k3_rows if r["dtype"] == "bfloat16"}[K3_SHAPES[0]]

    def by_path(k):
        return {"serving": launches.get(k, 0), "training": train_launches[k], "probes": 0}

    kernels = [
        {"name": "fused_dense_layer (K1)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:172", "launches": train_launches["k1"],
         "launches_by_path": by_path("k1"),
         "max_abs_err": worst["k1"], "ms": timed["k1_ms"], "plain_ms": timed["k1_plain_ms"],
         "bound_ms": timed["k1_bound_ms"], "bound_by": timed["k1_bound_by"], "library_ms": None,
         "device_ms": timed["k1_device_ms"],
         "view_device_ms": timed["k1_view_device_ms"],  # x and out channel slices of a buffer of ld 256
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
            "launches_by_path": {"serving": 0, "training": 0, "probes": probe_launches[name]},
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
