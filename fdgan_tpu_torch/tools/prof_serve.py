"""Where the time of the generator's forward goes, on one CUDA GPU.

    python -m fdgan_tpu_torch.tools.prof_serve [--batch 8] [--size 512] [--impl kernels plain] [--bn running batch]
        [--forward fast module]

For each ``forward`` (``fast``: ``models.fdgan_fast.apply``, what the engine
and the train step run; ``module``: ``FDGAN.forward``), ``impl`` and BN mode,
on the full-width FDGAN generator (random
weights from seed 0, randomised running statistics, bf16) and after
``--warmup`` forwards, prints one JSON line:

- ``wall_ms``: ms per forward between CUDA events around ``--forwards``
  forwards queued behind each other, and ``img_s`` from it;
- ``device_ms`` per forward: the sum of the self device time of every event
  that ``torch.profiler`` records on the device over ``--prof-forwards`` more
  forwards, ``idle_share`` = 1 − device_ms / wall_ms (one stream, so device
  events do not overlap) and ``device_events`` per forward;
- ``k1_ms``, ``k2_ms``, ``stats_ms``, ``cat_ms``: the device time per
  forward of the dense layer's kernels (by their names in
  ``csrc/dense_layer.cu``), of ``channel_stats`` (``csrc/channel_stats.cu``,
  both of its kernels) and of every
  ``torch.cat``'s copies (``CatArrayBatchedCopy``): the dense blocks' concats
  where each layer concatenates, only the decoder's and the statistics'
  where a block keeps its concat in one buffer (``inference_mode``, as here);
- ``top``: the 10 device events with the most time per forward.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def profile_forward(model, x: torch.Tensor, forward_name: str, impl: str, bn_mode: str, args) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.tools.timing import events_ms

    def forward():
        if forward_name == "fast":
            return fdgan_fast.apply(model, x, bn_mode=bn_mode, impl=impl)
        return model(x, bn_mode=bn_mode, impl=impl)

    with torch.inference_mode():
        wall_ms = events_ms(forward, reps=args.forwards, warmup=args.warmup)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.prof_forwards):
                forward()
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    n = args.prof_forwards

    def ms_of(*parts: str) -> float:
        return sum(e.self_device_time_total for e in events if any(p in e.key for p in parts)) / 1000 / n

    device_ms = sum(e.self_device_time_total for e in events) / 1000 / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "forward": forward_name, "impl": impl, "bn_mode": bn_mode, "shape": list(x.shape), "dtype": "bfloat16",
        "wall_ms": wall_ms, "img_s": 1000 * x.shape[0] / wall_ms, "device_ms": device_ms,
        "idle_share": 1 - device_ms / wall_ms, "device_events": sum(e.count for e in events) / n,
        "k1_ms": ms_of("dense_layer_"), "k2_ms": ms_of("h_stats_"),
        "stats_ms": ms_of("channel_stats_"), "cat_ms": ms_of("CatArrayBatchedCopy"),
        "top": [{"ms": e.self_device_time_total / 1000 / n, "n": e.count / n, "name": e.key[:140]} for e in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--impl", nargs="+", default=["kernels", "plain"], choices=["kernels", "plain"])
    parser.add_argument("--bn", nargs="+", default=["running", "batch"], choices=["running", "batch"])
    parser.add_argument("--forward", nargs="+", default=["fast"], choices=["fast", "module"])
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--forwards", type=int, default=5)
    parser.add_argument("--prof-forwards", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_serve needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)

    from fdgan_tpu_torch.models.fdgan import FDGAN

    model = FDGAN(device="cuda", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    for m in model.modules():  # running stats that are not the identity: mean ~ N(0, 0.1²), var ~ 1 + U(0, 0.1)
        if getattr(m, "running_mean", None) is not None:
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, device="cuda", generator=gen))
            m.running_var.copy_(1 + 0.1 * torch.rand(m.running_var.shape, device="cuda", generator=gen))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(args.batch, args.size, args.size, 3)).astype(np.float32))
    x = x.cuda().bfloat16()
    for forward_name in args.forward:
        for impl in args.impl:
            for bn_mode in args.bn:
                print(json.dumps(profile_forward(model, x, forward_name, impl, bn_mode, args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
