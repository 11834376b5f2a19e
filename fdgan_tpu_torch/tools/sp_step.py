"""One train step with H sharded, as one rank of a process group: what the
step over a data × spatial mesh gives, and what it costs.

    FDGAN_TPU_DIST=1 FDGAN_TPU_DIST_COORD=localhost:29500 FDGAN_TPU_DIST_NPROCS=2 FDGAN_TPU_DIST_PID=0 \\
        python -m fdgan_tpu_torch.tools.sp_step --input runs.pt --out out/ --device cuda --backend gloo

(and the same with each other ``FDGAN_TPU_DIST_PID``, started beside it;
``dist.mesh.run_local_ranks`` starts them all). ``--input`` is a
``torch.save`` file holding the global batch (``haze``, ``gt``: NHWC fp32 in
[0, 1]) and a list of runs (``runs``), each a dict: ``name``, ``mesh``
[n_data, n_spatial], ``precision`` (fp32 | bf16), ``remat`` (False | True |
"stages"), and optionally ``check_k3`` (a tolerance dict: every K3 launch
with halo rows held against its twin on its own input), ``time`` (steps a
turn: the step over the mesh on this rank's block against the step of one
card on the whole batch, in turns, one card, mesh, mesh, one card, the ranks
meeting at a barrier before each turn) and ``profile`` (one step of the
mesh under ``torch.profiler`` on every rank, read on rank 0). For each run
every rank builds the mesh (``dist.mesh.make_mesh``), ``create_train_state``'s
seed-0 G and D (no perceptual term), and runs one step of ``make_gd_steps``'
G update and D update (``make_train_step``'s order) on its block
(``dist.mesh.shard_batch(spatial=True)``), fp32 with TF32 off on the card.
Each rank writes ``<out>/rank<r>.pt``: per run, the metrics, the generator's
output on its block, the kernels' launches, the halo exchanges (and those
staged through the host), the global means' count all-reduces and the
statistics' all-reduces of the step, its peak memory (GiB,
``max_memory_allocated`` over the step), the K3 checks; rank 0 also the
gradients handed to Adam and G's and D's state dicts after the step, the
turns and the profile. Two ranks of one card need ``--backend gloo``: NCCL
takes one rank per device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import torch

from fdgan_tpu_torch.cli._common import fp32_exact
from fdgan_tpu_torch.dist import halo_exchange
from fdgan_tpu_torch.dist import mesh as dmesh
from fdgan_tpu_torch.dist import stats as dist_stats
from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.ops import dense, filters, freq
from fdgan_tpu_torch.ops import stats as ops_stats
from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps


def _counters() -> dict:
    return {"k1": dense.k1_launches, "k2": dense.k2_launches, "k3": freq.k3_launches,
            "channel_stats": ops_stats.launches, "exchanges": halo_exchange.counts["exchanges"],
            "host_staged": halo_exchange.counts["host_staged"], "counts": halo_exchange.counts["counts"],
            "stats_forward": dist_stats.collectives["forward"], "stats_backward": dist_stats.collectives["backward"],
            "grads": dmesh.counts["grads"], "metrics": dmesh.counts["metrics"]}


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _checked_k3(tol: dict, record: dict):
    """Every K3 launch with halo rows inside the block held against its twin
    (``ops.filters.frequency_fuse(halo=)``) on the same input; the twin
    launches nothing."""
    orig = freq._launch_k3
    record.update(calls=0, max_abs_err=0.0, shapes=[])

    def checked(x, halo=None):
        got = orig(x, halo)
        if halo is not None:
            want = filters.frequency_fuse(x, halo)
            err = (got.float() - want.float()).abs().max().item()
            record["calls"] += 1
            record["max_abs_err"] = max(record["max_abs_err"], err)
            shape = [list(x.shape), [r is not None for r in halo]]
            if shape not in record["shapes"]:
                record["shapes"].append(shape)
            if not torch.allclose(got.float(), want.float(), **tol):
                raise AssertionError(f"K3 with halo rows {shape} disagrees with its twin: max abs err {err:.3e}")
        return got

    freq._launch_k3 = checked
    try:
        yield
    finally:
        freq._launch_k3 = orig


def _state(device, grads: Optional[dict] = None):
    """The seed-0 train state on ``device``, the same on every rank; with
    ``grads``, each Adam keeps the gradients it is handed there, by name."""
    state, tx_g, tx_d = create_train_state(0, device=device)
    if grads is not None:
        for net in ("g", "d"):
            names = {p: n for n, p in getattr(state, net).named_parameters()}
            grads[net] = {}

            def keep(opt, args, kwargs, into=grads[net], names=names):
                into.update({names[p]: p.grad.detach().float().cpu().clone() for group in opt.param_groups
                             for p in group["params"] if p.grad is not None})

            getattr(state, f"{net}_opt").register_step_pre_hook(keep)
    return state, tx_g, tx_d


def _stepper(tx_g, tx_d, dtype, remat, mesh):
    """One train step (G update, then D update on its output), as a function
    of (state, haze, gt) returning (metrics, generator output)."""
    g_step, d_step = make_gd_steps(tx_g, tx_d, LossWeights(perceptual=0.0), compute_dtype=dtype, remat=remat,
                                   mesh=mesh)

    def step(state, haze, gt):
        _, metrics, x_hat = g_step(state, haze, gt)
        _, d_metrics = d_step(state, x_hat, gt)
        return metrics | d_metrics, x_hat

    return step


def _turns(steps: dict, n: int, device) -> dict:
    """ms per step of each of ``steps`` (name -> a function of no argument
    running one step), ``n`` a turn after one warm-up each, in turns (single,
    mesh, mesh, single), the ranks meeting at a barrier before each turn;
    and each one's peak memory over its warm-up step."""
    peak = {}
    for name, fn in steps.items():
        _synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        _synchronize(device)
        peak[name] = torch.cuda.max_memory_allocated(device) / 2**30
    spent = {name: [] for name in steps}
    for name in ("single", "mesh", "mesh", "single"):
        _synchronize(device)
        torch.distributed.barrier()
        t = time.perf_counter()
        for _ in range(n):
            steps[name]()
        _synchronize(device)
        spent[name].append(1000 * (time.perf_counter() - t) / n)
    out = {f"{name}_ms_per_step": sum(ms) / len(ms) for name, ms in spent.items()}
    out |= {f"{name}_ms_turns": ms for name, ms in spent.items()}
    out |= {f"{name}_peak_gib": gib for name, gib in peak.items()}
    out["mesh_over_single"] = sum(spent["mesh"]) / sum(spent["single"])
    return out


def run_one(run: dict, blob: dict, device) -> dict:
    """One run of the module's docstring on this rank."""
    n_data, n_spatial = run["mesh"]
    mesh = dmesh.make_mesh(n_data, n_spatial, device.type)
    dtype = torch.float32 if run["precision"] == "fp32" else torch.bfloat16
    remat = run.get("remat", False)
    grads = {} if dmesh.rank() == 0 else None
    state, tx_g, tx_d = _state(device, grads)
    dmesh.broadcast_state(state)
    step = _stepper(tx_g, tx_d, dtype, remat, mesh)
    haze, gt = dmesh.shard_batch((blob["haze"].to(device), blob["gt"].to(device)), mesh, spatial=True)
    out = {"name": run["name"], "mesh": [n_data, n_spatial], "coordinate": list(mesh.get_coordinate()),
           "rows": [int(haze.shape[0]), int(haze.shape[1])]}
    k3_check: dict = {}
    with fp32_exact(run["precision"], device):
        _synchronize(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        before = _counters()
        with _checked_k3(run["check_k3"], k3_check) if run.get("check_k3") else contextlib.nullcontext():
            metrics, x_hat = step(state, haze, gt)
        _synchronize(device)
        out["per_step"] = {k: v - before[k] for k, v in _counters().items()}
        if device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        out |= {"metrics": {k: float(v) for k, v in metrics.items()}, "x_hat": x_hat.float().cpu(),
                "k3_check": k3_check}
        if grads is not None:
            out |= {"grads": grads, "g": {k: v.cpu() for k, v in state.g.state_dict().items()},
                    "d": {k: v.cpu() for k, v in state.d.state_dict().items()}}
        if run.get("time"):
            single_state, sg, sd = _state(device)
            single = _stepper(sg, sd, dtype, remat, None)
            whole = (blob["haze"].to(device), blob["gt"].to(device))
            out["turns"] = _turns({"single": lambda: single(single_state, *whole),
                                   "mesh": lambda: step(state, haze, gt)}, run["time"], device)
            del single_state
        if run.get("profile"):
            from fdgan_tpu_torch.tools.timing import busy_profile

            torch.distributed.barrier()
            prof = busy_profile(lambda: step(state, haze, gt))
            if dmesh.rank() == 0:
                out["profile"] = prof
    return out


def main(argv: Optional[list] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--out", required=True, help="a directory: each rank writes rank<r>.pt into it")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on the card, gloo on the CPU)")
    opt = p.parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sp_step: no CUDA device; pass --device cpu to run on the CPU")
    if device.type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    dmesh.maybe_init_distributed(device, opt.backend)
    if dmesh.world_size() == 1:
        raise SystemExit("sp_step: no process group (FDGAN_TPU_DIST and its coordinates are not set)")
    if device.type == "cuda":
        device = dmesh.local_device()
        torch.cuda.set_device(device)
    blob = torch.load(opt.input, map_location="cpu", weights_only=True)
    results = [run_one(run, blob, device) for run in blob["runs"]]
    torch.save(results, os.path.join(opt.out, f"rank{dmesh.rank()}.pt"))
    torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
