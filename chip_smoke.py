#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA GPU, and check it.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

1. device and build: the card's name and power limit from nvidia-smi, then
   the kernels of fdgan_tpu_torch/csrc built from source;
2. kernels against their plain twins at the dense-layer shapes of the
   8×512² path (fp32 without TF32, and bf16), with CUDA-event times;
3. the full-width FDGAN generator (random weights, seed 0) at 8×512²:
   the kernel path against the plain path in fp32 for both BN modes, the
   bf16 PSNR check, the launch counts per forward, and img/s in bf16;
4. serving: InferenceEngines (bf16, running and batch BN) behind the
   BatchingFrontend answer ragged uint8 requests from several threads.
   The kernels' launch counters are zeroed just before this phase and read
   just after it: every kernel must have run in it.

The line before the last holds the per-kernel summary as JSON; the last
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

SHAPES = [  # (B, H, W, C): one layer per dense block of the 8×512² path, a ragged C, a ragged W
    (8, 512, 512, 64),
    (8, 256, 256, 128),
    (8, 128, 128, 256),
    (8, 128, 128, 992),
    (8, 120, 200, 64),
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
# serving: running BN makes each image independent of its batch-mates, but
# the batch size changes cuDNN's algorithms for the plain convs, so the bf16
# result may move by a few bf16 steps (2^-7 near ±1) after ~60 layers.
SERVE_TOL = dict(atol=5e-2, mean=2e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms."""
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
        if "registers" in line or "spill" in line or "error" in line.lower():
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


def phase_kernels():
    import torch

    from fdgan_tpu_torch.ops import dense

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {"k1": 0.0, "k2": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            x, a1, b1, w1, a2, b2, w2 = layer_inputs(shape, dtype, gen)
            with exact_fp32():
                f_k = dense.fused_dense_layer(x, a1, b1, w1, a2, b2, w2)
                f_p = dense.layer_reference(x, a1, b1, w1, a2, b2, w2)
                m_k, v_k = dense.h_batch_stats(x, a1, b1, w1)
                m_p, v_p = dense.h_stats_reference(x, a1, b1, w1)
            torch.cuda.synchronize()
            tol = K1_TOL_F32 if dtype == torch.float32 else K1_TOL_BF16
            e1 = (f_k.float() - f_p.float()).abs().max().item()
            e2 = max((m_k - m_p).abs().max().item(), (v_k - v_p).abs().max().item())
            ok1 = torch.allclose(f_k.float(), f_p.float(), **tol)
            ok2 = torch.allclose(m_k, m_p, **K2_MEAN_TOL) and torch.allclose(v_k, v_p, **K2_VAR_TOL)
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
            row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   "k1_max_abs_err": e1, "k2_max_abs_err": e2, **t}
            rows.append(row)
            log(json.dumps(row))
            if not (ok1 and ok2):
                raise AssertionError(f"kernel disagrees with its twin at {shape} {dtype}: "
                                     f"K1 ok={ok1} err={e1}, K2 ok={ok2} err={e2}")
            del x, f_k, f_p
            torch.cuda.empty_cache()
    return rows, worst


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

    from fdgan_tpu_torch.models.fdgan import FDGAN
    from fdgan_tpu_torch.ops import dense

    model = FDGAN(device="cuda", generator=torch.Generator().manual_seed(0))
    randomise_running_stats(model)
    x_np = np.random.default_rng(0).uniform(size=(8, 512, 512, 3)).astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    out = {}
    ref32 = {}
    with torch.inference_mode():
        with exact_fp32():
            for mode in ("batch", "running"):
                dense.reset_launch_counts()
                y_k = model(x, bn_mode=mode, impl="kernels")
                torch.cuda.synchronize()
                launches = (dense.k1_launches, dense.k2_launches)
                y_p = model(x, bn_mode=mode, impl="plain")
                err = (y_k - y_p).abs().max().item()
                ok = torch.allclose(y_k, y_p, **GEN_TOL) and bool(torch.isfinite(y_k).all())
                log(f"generator fp32 {mode}: kernels vs plain max_abs_err {err:.3e} "
                    f"launches K1 {launches[0]} K2 {launches[1]} ok={ok}")
                want = (42, 42 if mode == "batch" else 0)
                if not ok or tuple(y_k.shape) != (8, 512, 512, 3):
                    raise AssertionError(f"generator kernel path disagrees in fp32 {mode} mode")
                if launches != want:
                    raise AssertionError(f"launches per {mode} forward {launches}, expected {want}")
                out[f"fp32_{mode}_max_abs_err"] = err
                ref32[mode] = y_p
        model_bf = FDGAN(device="cuda", dtype=torch.bfloat16)
        model_bf.load_state_dict(model.state_dict())
        xb = x.bfloat16()
        for mode in ("batch", "running"):
            p_k = psnr(model_bf(xb, bn_mode=mode, impl="kernels").float(), ref32[mode])
            p_p = psnr(model_bf(xb, bn_mode=mode, impl="plain").float(), ref32[mode])
            log(f"generator bf16 {mode}: PSNR vs fp32 plain: kernels {p_k:.2f} dB, plain {p_p:.2f} dB")
            if not p_k >= p_p - 1.0:
                raise AssertionError(f"bf16 kernel path loses {p_p - p_k:.2f} dB in {mode} mode")
            out[f"bf16_{mode}_psnr_kernels_db"], out[f"bf16_{mode}_psnr_plain_db"] = p_k, p_p
        del ref32
        torch.cuda.empty_cache()
        # img/s at 8×512², bf16, running BN; in turns: plain, kernels, kernels, plain
        times = {"kernels": [], "plain": []}
        for impl in ("plain", "kernels", "kernels", "plain"):
            times[impl].append(cuda_ms(lambda: model_bf(xb, bn_mode="running", impl=impl), reps=5, warmup=1))
        for impl, ts in times.items():
            ms = sum(ts) / len(ts)
            out[f"bf16_running_{impl}_ms"] = ms
            out[f"bf16_running_{impl}_img_s"] = 8 * 1000.0 / ms
            log(f"generator bf16 running 8x512^2 {impl}: {ms:.2f} ms/batch, {8000.0 / ms:.2f} img/s")
    return model, out


def phase_serving(model):
    import torch

    from fdgan_tpu_torch.ops import dense
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
        t0 = time.perf_counter()
        results = {"running": submit_all(fronts["running"], images),
                   "batch": submit_all(fronts["batch"], images[:4])}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k1": dense.k1_launches, "k2": dense.k2_launches}
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
    if launches["k1"] == 0 or launches["k2"] == 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    return launches, {"wall_s": wall, "batches_total": eng_batches, **lat}


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
    model, gen = phase_generator()
    log(json.dumps({"generator": gen}))
    launches, serving = phase_serving(model)
    log(json.dumps({"serving": serving}))
    timed = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}[TIMED_SHAPE]
    kernels = [
        {"name": "fused_dense_layer (K1)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:172", "launches": launches["k1"],
         "max_abs_err": worst["k1"], "ms": timed["k1_ms"], "plain_ms": timed["k1_plain_ms"],
         "timed_at": list(TIMED_SHAPE) + ["bfloat16"], "err_of": "fp32, all shapes"},
        {"name": "h_batch_stats (K2)", "route": "cuda",
         "source": "fdgan_tpu_torch/csrc/dense_layer.cu",
         "replaces": "fdgan_tpu/ops/pallas_dense.py:323", "launches": launches["k2"],
         "max_abs_err": worst["k2"], "ms": timed["k2_ms"], "plain_ms": timed["k2_plain_ms"],
         "timed_at": list(TIMED_SHAPE) + ["bfloat16"], "err_of": "fp32, all shapes"},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
