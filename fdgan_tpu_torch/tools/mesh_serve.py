"""The serving mesh as one rank of a process group: what a data × spatial
``InferenceEngine`` gives, and what it costs.

    FDGAN_TPU_DIST=1 FDGAN_TPU_DIST_COORD=localhost:29500 FDGAN_TPU_DIST_NPROCS=2 FDGAN_TPU_DIST_PID=0 \\
        python -m fdgan_tpu_torch.tools.mesh_serve --input runs.pt --out out/ --device cuda --backend gloo

(and the same with each other ``FDGAN_TPU_DIST_PID``, started beside it;
``dist.mesh.run_local_ranks`` starts them all). ``--input`` is a
``torch.save`` file holding the generator's state dict (``weights``) and a
list of runs (``runs``), each a dict: ``name``, ``mesh`` [n_data,
n_spatial], ``precision``, ``bn_mode``, ``bucket``, ``batch_sizes`` (None:
the engine's default),
``images`` (N, H, W, 3) fp32 in [0, 1], and optionally ``check_k1`` (a
tolerance dict: every halo'd K1 launch of the run's first forward held
against its twin, ``ops.dense.layer_reference``, on its own input), ``time``
(forwards a turn: the staged batch through this engine and through one
engine of one device on rank 0 alone, in turns, single, mesh, mesh, single)
and ``profile`` (one forward of the mesh under ``torch.profiler`` on rank
0). For each run every rank builds the mesh (``dist.mesh.make_mesh``) and
the engine; rank 0 serves ``images`` through ``predict_batch`` and the
other ranks run ``serve_worker``. Each rank writes ``<out>/rank<r>.pt``:
per run, the counts of each forward it ran (K1, K2 and ``channel_stats``
launches, halo exchanges, their bytes and those staged through the host,
the statistics' all-reduces), the K1 checks, and on rank 0 the outputs,
turns and profile. Two ranks of one card need ``--backend gloo``: NCCL
takes one rank per device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from fdgan_tpu_torch.dist import halo_exchange
from fdgan_tpu_torch.dist import mesh as dmesh
from fdgan_tpu_torch.dist import stats as dist_stats
from fdgan_tpu_torch.ops import dense
from fdgan_tpu_torch.ops import stats as ops_stats
from fdgan_tpu_torch.serve import InferenceEngine


def _counters() -> dict:
    return {"k1": dense.k1_launches, "k2": dense.k2_launches, "channel_stats": ops_stats.launches,
            "exchanges": halo_exchange.counts["exchanges"], "exchange_bytes": halo_exchange.counts["bytes"],
            "host_staged": halo_exchange.counts["host_staged"], "stats_allreduces": dist_stats.collectives["forward"]}


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _checked_k1(tol: dict, record: dict):
    """Every K1 launch with halo rows inside the block held against its twin
    on the same input, halo rows included; the twin launches nothing."""
    orig = dense.fused_dense_layer
    record.update(calls=0, max_abs_err=0.0, shapes=[])

    def checked(x, a1, b1, w1, a2, b2, w2, out=None, halo=None):
        got = orig(x, a1, b1, w1, a2, b2, w2, out=out, halo=halo)
        if halo is not None and x.device.type == "cuda":
            want = dense.layer_reference(x, a1, b1, w1, a2, b2, w2, halo=halo)
            err = (got.float() - want.float()).abs().max().item()
            record["calls"] += 1
            record["max_abs_err"] = max(record["max_abs_err"], err)
            shape = [list(x.shape), [r is not None for r in halo]]
            if shape not in record["shapes"]:
                record["shapes"].append(shape)
            if not torch.allclose(got.float(), want.float(), **tol):
                raise AssertionError(f"K1 with halo rows {shape} disagrees with its twin: max abs err {err:.3e}")
        return got

    dense.fused_dense_layer = checked
    try:
        yield
    finally:
        dense.fused_dense_layer = orig


def _staged(engine: InferenceEngine, images) -> np.ndarray:
    """The batch the engine dispatches for ``images`` (one bucket, a full rung)."""
    imgs = [engine._ingest(im) for im in images]
    h, w = engine._bucket_hw(*imgs[0].shape[:2])
    return np.stack([engine._pad_hw(im, h, w) for im in imgs])


def _turns(engines: dict, batch: np.ndarray, n: int, device) -> dict:
    """ms per batch of each engine, ``n`` dispatches a turn after one warm-up
    each, in turns (single, mesh, mesh, single); host clock, the card
    synchronised, the result fetched; and how far the warm-ups' results
    lie apart."""
    outputs = {name: eng._dispatch(batch).fetch().copy() for name, eng in engines.items()}
    spent = {name: [] for name in engines}
    for name in ("single", "mesh", "mesh", "single"):
        _synchronize(device)
        t = time.perf_counter()
        for _ in range(n):
            engines[name]._dispatch(batch).fetch()
        _synchronize(device)
        spent[name].append(1000 * (time.perf_counter() - t) / n)
    b = batch.shape[0]
    out = {f"{name}_ms": ms for name, ms in spent.items()}
    out.update({f"{name}_img_s": 1000 * b * len(ms) / sum(ms) for name, ms in spent.items()})
    out["mesh_over_single"] = sum(spent["mesh"]) / sum(spent["single"])
    out["mesh_vs_single_max_abs_err"] = float(np.abs(outputs["mesh"] - outputs["single"]).max())
    return out


def _profile(engine: InferenceEngine, batch: np.ndarray, device) -> dict:
    """One dispatch of the mesh under ``torch.profiler`` on this rank, after
    a warm-up (``tools.timing.busy_profile``: wall ms, the device's busy ms
    and idle share, NCCL's ms, the kernels that take the most time)."""
    from fdgan_tpu_torch.tools.timing import busy_profile

    engine._dispatch(batch).fetch()
    return busy_profile(lambda: engine._dispatch(batch).fetch())


def run_one(run: dict, weights: dict, device) -> dict:
    """One run of the module's docstring on this rank."""
    n_data, n_spatial = run["mesh"]
    mesh = dmesh.make_mesh(n_data, n_spatial, device.type)
    engine = InferenceEngine(weights, device=device, precision=run["precision"], bn_mode=run["bn_mode"],
                             bucket=run["bucket"],
                             batch_sizes=tuple(run["batch_sizes"]) if run.get("batch_sizes") else None, mesh=mesh,
                             spatial=run.get("spatial", n_spatial > 1))
    forwards, k1_check = [], {}
    block = engine._forward_block

    def counted(model, x):
        check = run.get("check_k1") if not forwards else None
        before = _counters()
        with _checked_k1(check, k1_check) if check else contextlib.nullcontext():
            y = block(model, x)
        _synchronize(device)
        forwards.append({k: v - before[k] for k, v in _counters().items()})
        return y

    engine._forward_block = counted
    out = {"name": run["name"], "mesh": [n_data, n_spatial], "coordinate": list(mesh.get_coordinate()),
           "batch_sizes": list(engine.batch_sizes)}
    if dmesh.rank() == 0:
        images = [im.numpy() for im in run["images"]]
        out["outputs"] = torch.from_numpy(np.stack(engine.predict_batch(images)))
        batch = _staged(engine, images)
        if run.get("time"):
            single = InferenceEngine(weights, device=device, precision=run["precision"], bn_mode=run["bn_mode"],
                                     bucket=run["bucket"], batch_sizes=(batch.shape[0],))
            out["turns"] = _turns({"single": single, "mesh": engine}, batch, run["time"], device)
            del single
        if run.get("profile"):
            out["profile"] = _profile(engine, batch, device)
        engine.close()
    else:
        engine.serve_worker()
    out.update(forwards=forwards, k1_check=k1_check)
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
        raise SystemExit("mesh_serve: no CUDA device; pass --device cpu to run on the CPU")
    if device.type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    dmesh.maybe_init_distributed(device, opt.backend)
    if dmesh.world_size() == 1:
        raise SystemExit("mesh_serve: no process group (FDGAN_TPU_DIST and its coordinates are not set)")
    if device.type == "cuda":
        device = dmesh.local_device()
        torch.cuda.set_device(device)
    blob = torch.load(opt.input, map_location="cpu", weights_only=True)
    results = []
    for run in blob["runs"]:
        results.append(run_one(run, blob["weights"], device))
    torch.save(results, os.path.join(opt.out, f"rank{dmesh.rank()}.pt"))
    torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
