"""Where the time of the adversarial train step goes, on one CUDA GPU.

    python -m fdgan_tpu_torch.tools.prof_train [--batch 4] [--size 256] [--impl kernels plain]

For each ``impl``, from a fresh seed-0 state, after ``--warmup`` steps of
``make_train_step`` (bf16, no perceptual term), prints one JSON line each:

- ``phases``: the step's parts in its order (G forward, G loss, G backward,
  G Adam, BN fold, D step), in ms between CUDA events recorded around each
  part of a step written out as ``train.loop`` runs it, median of
  ``--phase-steps`` steps with a ``synchronize`` after each;
- ``step``: ``wall_ms`` per step (host clock over ``--steps`` steps with
  one ``synchronize`` at the end), ``host_enqueue_ms`` (median time for
  the step call to return), ``device_ms`` per step (the sum of the self
  device time of every event that ``torch.profiler`` records on the device
  (kernels, memcpy and memset; not the user ranges that span them) over
  ``--prof-steps`` more steps),
  ``idle_share`` = 1 − device_ms / wall_ms (one stream, so device events do
  not overlap), ``device_events`` per step, and ``peak_gib``;
- ``top``: the 12 device events with the most time per step.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def _batch(b: int, size: int):
    gt = np.random.default_rng(0).uniform(size=(b, size, size, 3)).astype(np.float32)
    haze = np.clip(0.6 * gt + 0.3, 0, 1)
    return torch.from_numpy(haze).cuda(), torch.from_numpy(gt).cuda()


def phase_ms(state, tx_g, tx_d, weights, haze, gt, impl, steps):
    """Median ms of each part of the step, with ``train.loop._steps``'s
    order and calls."""
    from fdgan_tpu_torch.losses.composite import discriminator_loss, generator_loss
    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.nn.layers import fold_stats
    from fdgan_tpu_torch.train.loop import _frozen

    names = ("g_forward", "g_loss", "g_backward", "g_adam", "bn_fold", "d_step")
    times = {k: [] for k in names}
    h, g = haze.bfloat16(), gt.bfloat16()
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        stats: dict = {}
        with _frozen(state.d):
            x_hat = fdgan_fast.apply(state.g, h, bn_mode="batch", impl=impl, stats_out=stats)
            ev[1].record()
            _, terms = generator_loss(state.d, x_hat, g, weights, None, impl)
            ev[2].record()
            state.g_opt.zero_grad(set_to_none=True)
            terms["total"].backward()
            ev[3].record()
        tx_g.apply(state.g_opt, state.step)
        ev[4].record()
        fold_stats(state.g, stats)
        ev[5].record()
        loss, _ = discriminator_loss(state.d, x_hat.detach(), g, 1.0, impl)
        state.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        tx_d.apply(state.d_opt, state.d_updates)
        ev[6].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            times[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: statistics.median(v) for k, v in times.items()}


def profile_impl(impl: str, args) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

    weights = LossWeights(perceptual=0.0)
    haze, gt = _batch(args.batch, args.size)
    state, tx_g, tx_d = create_train_state(0, device="cuda")
    step = make_train_step(tx_g, tx_d, weights, compute_dtype=torch.bfloat16, impl=impl)
    for _ in range(args.warmup):
        step(state, haze, gt)
    torch.cuda.synchronize()
    phases = phase_ms(state, tx_g, tx_d, weights, haze, gt, impl, args.phase_steps)

    torch.cuda.reset_peak_memory_stats()
    host = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        t1 = time.perf_counter()
        step(state, haze, gt)
        host.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000 / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.prof_steps):
            step(state, haze, gt)
        torch.cuda.synchronize()
    # device events, less the ranges that annotate them (Optimizer.step#Adam.step)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in events) / 1000 / args.prof_steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "impl": impl,
        "shape": [args.batch, args.size, args.size, 3],
        "phases": phases,
        "step": {"wall_ms": wall_ms, "host_enqueue_ms": 1000 * statistics.median(host), "device_ms": device_ms,
                 "idle_share": 1 - device_ms / wall_ms,
                 "device_events": sum(e.count for e in events) / args.prof_steps,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30},
        "top": [{"ms": e.self_device_time_total / 1000 / args.prof_steps, "n": e.count / args.prof_steps,
                 "name": e.key[:140]} for e in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--impl", nargs="+", default=["kernels", "plain"], choices=["kernels", "plain"])
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--phase-steps", type=int, default=5)
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--prof-steps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_train needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for impl in args.impl:
        print(json.dumps(profile_impl(impl, args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
