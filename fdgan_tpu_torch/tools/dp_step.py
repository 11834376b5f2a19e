"""One data-parallel train step as one rank of a process group, and what it
gives: the check that the step over N processes is the step on the global
batch.

    FDGAN_TPU_DIST=1 FDGAN_TPU_DIST_COORD=localhost:29500 FDGAN_TPU_DIST_NPROCS=2 FDGAN_TPU_DIST_PID=0 \\
        python -m fdgan_tpu_torch.tools.dp_step --input step.pt --out rank0.pt --device cuda --backend gloo

(and the same with ``FDGAN_TPU_DIST_PID=1``, started beside it;
``dist.mesh.run_local_ranks`` starts them all). ``--input`` is a
``torch.save`` file holding the global batch (``haze``, ``gt``: NHWC fp32 in
[0, 1]) and, optionally, G's and D's state dicts (``g``, ``d``; else
``create_train_state``'s seed-0 weights). The process joins the group
(``dist.mesh.maybe_init_distributed``), and for each of :data:`RUNS`
builds the state anew and runs one train step (no perceptual term;
``make_gd_steps``' G update and D update, the order of ``make_train_step``)
with the group on its own rows of the batch (``dist.mesh.shard_batch``),
fp32 with TF32 off on the card: fp32; fp32 with ``remat=True``; bf16; and
bf16 with per-rank statistics, the negative control (``local_stats``: the
gradients and metrics are still averaged, as torch's DDP without
SyncBatchNorm would have it). ``--out`` gets, per run, the metrics, the
generator's output on this rank's rows, the gradients handed to Adam, G's
and D's state dicts after the step, the kernels' launches and the
collectives issued. Two ranks of one card need ``--backend gloo``: NCCL
takes one rank per device. With ``--time N`` and a global bf16 batch in
``--input`` (``timed_haze``, ``timed_gt``), each rank then times N bf16
steps on its rows of it, the data-parallel step against the step without a
group (N/2 of each a turn, bare, dp, dp, bare; the ranks meet at a barrier
before each turn), and profiles one more step of each (``torch.profiler``):
where the host's time goes, and what the card does.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import torch

from fdgan_tpu_torch.cli._common import fp32_exact
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.dist import stats as dist_stats
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.ops import dense, freq
from fdgan_tpu_torch.ops import stats as ops_stats
from fdgan_tpu_torch.train import loop
from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps, make_train_step


def _counts() -> dict:
    return {"k1": dense.k1_launches, "k2": dense.k2_launches, "k3": freq.k3_launches,
            "channel_stats": ops_stats.launches}


def _reset_counts() -> None:
    dense.reset_launch_counts()
    freq.reset_launch_count()
    ops_stats.reset_launch_count()
    dist_stats.reset_counts()
    mesh.reset_counts()


RUNS = {"fp32": dict(compute_dtype=torch.float32), "fp32_remat": dict(compute_dtype=torch.float32, remat=True),
        "bf16": dict(compute_dtype=torch.bfloat16),
        "bf16_local_stats": dict(compute_dtype=torch.bfloat16, local_stats=True)}


@contextlib.contextmanager
def _local_stats():
    """The step's batch statistics per rank: ``global_batch_stats`` made a
    no-op for the block."""
    orig = loop.global_batch_stats
    loop.global_batch_stats = lambda group: contextlib.nullcontext()
    try:
        yield
    finally:
        loop.global_batch_stats = orig


def run_step(blob: dict, device, compute_dtype=torch.float32, remat=False, local_stats=False) -> dict:
    """One data-parallel step from ``blob``'s state on this rank's rows of
    its batch (the module's docstring; with no group, one process's step on
    the whole batch); returns what the step gave, on the CPU."""
    state, tx_g, tx_d = create_train_state(0, device=device)
    if "g" in blob:
        state.g.load_state_dict(blob["g"], strict=True)
        state.d.load_state_dict(blob["d"], strict=True)
    mesh.broadcast_state(state)
    grads = {"g": {}, "d": {}}
    for net in ("g", "d"):
        names = {p: n for n, p in getattr(state, net).named_parameters()}

        def keep(opt, args, kwargs, into=grads[net], names=names):
            into.update({names[p]: p.grad.detach().cpu().clone() for group in opt.param_groups
                         for p in group["params"] if p.grad is not None})

        getattr(state, f"{net}_opt").register_step_pre_hook(keep)
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0), compute_dtype=compute_dtype,
                                   remat=remat, group=mesh.process_group())
    haze, gt = mesh.shard_batch((blob["haze"].to(device), blob["gt"].to(device)))
    _reset_counts()
    with fp32_exact("fp32" if compute_dtype == torch.float32 else "bf16", device), \
            (_local_stats() if local_stats else contextlib.nullcontext()):
        _, metrics, x_hat = g_step(state, haze, gt)
        _, d_metrics = d_step(state, x_hat, gt)
    _synchronize(device)
    return {"metrics": {k: float(v) for k, v in (metrics | d_metrics).items()}, "x_hat": x_hat.float().cpu(),
            "grads": grads,
            "g": {k: v.cpu() for k, v in state.g.state_dict().items()},
            "d": {k: v.cpu() for k, v in state.d.state_dict().items()},
            "launches": _counts(), "collectives": dict(dist_stats.collectives) | dict(mesh.counts),
            "rows": int(haze.shape[0])}


def time_steps(blob: dict, device, steps: int) -> dict:
    """ms per bf16 step (no perceptual term) on this rank's rows of
    ``blob``'s timed batch, with the group and without, in turns, after a
    warm-up step each (the module's docstring)."""
    haze, gt = mesh.shard_batch((blob["timed_haze"].to(device), blob["timed_gt"].to(device)))
    runs = {}
    for name, group in (("bare", None), ("dp", mesh.process_group())):
        state, tx_g, tx_d = create_train_state(0, device=device)
        step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), compute_dtype=torch.bfloat16, group=group)
        step(state, haze, gt)
        runs[name] = {"state": state, "step": step, "seconds": 0.0, "steps": 0}
    for name in ("bare", "dp", "dp", "bare"):
        r = runs[name]
        _synchronize(device)
        torch.distributed.barrier()
        t = time.perf_counter()
        for _ in range(steps // 2):
            r["step"](r["state"], haze, gt)
        _synchronize(device)
        r["seconds"] += time.perf_counter() - t
        r["steps"] += steps // 2
    ms = {f"{name}_ms_per_step": 1000 * r["seconds"] / r["steps"] for name, r in runs.items()}
    profiled = {name: profile_step(r["step"], r["state"], haze, gt, device) for name, r in runs.items()}
    return ms | {"dp_over_bare": ms["dp_ms_per_step"] / ms["bare_ms_per_step"], "rows": int(haze.shape[0]),
                 "steps": 2 * (steps // 2), "profile": profiled}


def profile_step(step, state, haze, gt, device) -> dict:
    """One step under ``torch.profiler``, after a barrier: its wall time and
    the host's time to enqueue it (until the call returns), ms; on the card,
    the busy time of the compute kernels and of NCCL's (which also wait for
    the slowest rank); the host's waits for the card (synchronisations and
    scalar reads) and its time in the collectives' calls; the host ops that
    take the most time. The profiler slows the host alike on both sides."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    _synchronize(device)
    torch.distributed.barrier()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        step(state, haze, gt)
        enqueue = time.perf_counter() - t
        _synchronize(device)
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if not e.is_user_annotation]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]

    def host_ms(*parts: str) -> dict:
        hit = [e for e in host if any(p in e.key for p in parts)]
        return {"ms": sum(e.cpu_time_total for e in hit) / 1000, "calls": sum(e.count for e in hit)}

    nccl = [e for e in dev if "nccl" in e.key.lower()]
    return {"wall_ms": 1000 * wall, "enqueue_ms": 1000 * enqueue,
            "device_ms": sum(e.self_device_time_total for e in dev if e not in nccl) / 1000,
            "nccl_device_ms": sum(e.self_device_time_total for e in nccl) / 1000,
            "device_events": sum(e.count for e in dev),
            "host_waits": host_ms("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                                  "_local_scalar_dense"),
            "host_collectives": host_ms("all_reduce", "allreduce"),
            "host_top": [{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1000, "calls": e.count}
                         for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]]}


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on the card, gloo on the CPU)")
    p.add_argument("--time", type=int, default=0, help="bf16 steps to time a side on the input's timed batch")
    opt = p.parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dp_step: no CUDA device; pass --device cpu to run on the CPU")
    mesh.maybe_init_distributed(device, opt.backend)
    if mesh.world_size() == 1:
        raise SystemExit("dp_step: no process group (FDGAN_TPU_DIST and its coordinates are not set)")
    if device.type == "cuda":
        device = mesh.local_device()
        torch.cuda.set_device(device)
    blob = torch.load(opt.input, map_location="cpu", weights_only=True)
    out = {"rank": mesh.rank(), "world": mesh.world_size(), "runs": {}}
    for name, kwargs in RUNS.items():
        out["runs"][name] = run_step(blob, device, **kwargs)
    if opt.time:
        out["timed"] = time_steps(blob, device, opt.time)
    torch.save(out, opt.out)
    torch.distributed.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
