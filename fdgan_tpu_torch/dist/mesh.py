"""Multi-process data parallelism: process-group set-up, the state's
broadcast, the batch's shard and the averages over ranks.

Counterpart of ``fdgan_tpu/dist/mesh.py`` in torch's idiom. JAX builds a
mesh and lets jit emit the collectives; here each process holds one device
and a replica of the train state, feeds its own slice of the global batch,
and the step issues the collectives itself (``train/loop.py``): the batch
statistics' (``dist/stats.py``), one flattened gradient all-reduce per model
per update and one for the metrics.

The launch is the JAX package's: ``FDGAN_TPU_DIST=1`` with

    FDGAN_TPU_DIST_COORD=host:port   the rendezvous address (rank 0's)
    FDGAN_TPU_DIST_NPROCS=N          the number of processes
    FDGAN_TPU_DIST_PID=i             this process's rank

or the flag alone under ``torchrun``, whose ``MASTER_ADDR`` / ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` variables take the place of JAX's
auto-detection (``init_method="env://"``).

``counts`` holds the collectives of this module issued in this process.
:func:`run_local_ranks` starts N such processes on this host, as the tests
and ``chip_smoke.py`` do.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
import warnings
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

counts = {"grads": 0, "metrics": 0}


def reset_counts() -> None:
    counts.update(grads=0, metrics=0)


def maybe_init_distributed(device="cuda", backend: Optional[str] = None) -> None:
    """Join the process group when ``FDGAN_TPU_DIST`` is set; nothing
    otherwise, or when a group exists already.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU, unless
    ``backend`` says otherwise. With ``FDGAN_TPU_DIST_COORD`` the rendezvous
    is ``tcp://COORD`` with the given process count and rank; with the flag
    alone it is ``env://``. Explicit coordinates that fail stop the process
    with ``SystemExit`` naming them (run on alone, this process would take
    itself for rank 0 of 1 and write over the real run's checkpoints); the
    flag alone that fails warns with ``RuntimeWarning`` and leaves the
    process single (``fdgan_tpu/dist/mesh.py:50-67``)."""
    if not os.environ.get("FDGAN_TPU_DIST", "") or dist.is_initialized():
        return
    coord = os.environ.get("FDGAN_TPU_DIST_COORD") or None
    nprocs = os.environ.get("FDGAN_TPU_DIST_NPROCS")
    pid = os.environ.get("FDGAN_TPU_DIST_PID")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    explicit = coord is not None or nprocs is not None or pid is not None
    try:
        if explicit:
            dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=int(nprocs), rank=int(pid))
        else:
            dist.init_process_group(backend, init_method="env://")
    except Exception as e:
        if explicit:
            raise SystemExit(f"FDGAN_TPU_DIST: init_process_group({backend!r}, coord={coord!r}, nprocs={nprocs}, "
                             f"pid={pid}) failed: {type(e).__name__}: {e}")
        warnings.warn(f"FDGAN_TPU_DIST is set but init_process_group({backend!r}, init_method='env://') failed "
                      f"({type(e).__name__}: {e}); continuing single-process", RuntimeWarning, stacklevel=2)


def process_group() -> Optional["dist.ProcessGroup"]:
    """The default group when one is initialised, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK}`` under torchrun, else
    ``cuda:{rank % device_count}``."""
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else rank() % torch.cuda.device_count())


def shard_batch(batch: Sequence[torch.Tensor]) -> tuple:
    """This process's rows of each tensor of a global batch: rank r of W
    takes rows [r·B/W, (r+1)·B/W). B must divide by W."""
    world, r = world_size(), rank()
    out = []
    for t in batch:
        if t.shape[0] % world:
            raise ValueError(f"global batch {t.shape[0]} does not divide by {world} processes")
        local = t.shape[0] // world
        out.append(t[r * local:(r + 1) * local])
    return tuple(out)


def _flat_apply_(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective(flat)`` on the concatenation of ``tensors`` (one per
    dtype), whose result is copied back into them."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def average_gradients(module: torch.nn.Module, group) -> None:
    """Every gradient of ``module`` replaced by its mean over the ranks of
    ``group`` (one flattened all-reduce); nothing at world size 1. The
    parameters without a gradient are the same on every rank."""
    if group is None or dist.get_world_size(group) == 1:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(dist.get_world_size(group))

    _flat_apply_(grads, mean)
    counts["grads"] += 1


@torch.no_grad()
def average_metrics(metrics: dict, group) -> dict:
    """The 0-d metric tensors averaged over the ranks (one all-reduce); the
    dict as it is at world size 1."""
    if group is None or dist.get_world_size(group) == 1 or not metrics:
        return metrics
    flat = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    counts["metrics"] += 1
    return dict(zip(metrics, flat / dist.get_world_size(group)))


@torch.no_grad()
def broadcast_state(state):
    """Rank 0's G, D, both Adams and the update counts on every rank, in
    place (the counterpart of ``shard_params``' "every process passes the
    same values"): after init or a resume, which may have read a checkpoint
    on rank 0 only. Returns ``state``."""
    if world_size() == 1:
        return state
    opts = (state.g_opt, state.d_opt)
    params = [[p for g in opt.param_groups for p in g["params"]] for opt in opts]
    # the counts and which parameters have Adam state, with Adam's per-parameter steps (CPU
    # tensors, which NCCL does not carry)
    meta = [state.step, state.d_updates,
            [{i: float(opt.state[p]["step"]) for i, p in enumerate(ps) if p in opt.state}
             for opt, ps in zip(opts, params)]]
    dist.broadcast_object_list(meta, src=0)
    state.step, state.d_updates = meta[0], meta[1]
    tensors = list(state.g.state_dict().values()) + list(state.d.state_dict().values())
    for opt, ps, steps in zip(opts, params, meta[2]):
        for i, p in enumerate(ps):
            if i not in steps:
                opt.state.pop(p, None)
                continue
            entry = opt.state[p]
            if "exp_avg" not in entry:
                entry.update(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            entry["step"] = torch.tensor(steps[i], dtype=torch.float32)
            tensors += [entry["exp_avg"], entry["exp_avg_sq"]]
    _flat_apply_(tensors, lambda flat: dist.broadcast(flat, src=0))
    return state


def free_port() -> int:
    """A TCP port of localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local_ranks(argv: Union[Sequence[str], Callable[[int], Sequence[str]]], nprocs: int, timeout: float,
                    env: Optional[dict] = None, cwd: Optional[str] = None) -> list:
    """``argv`` (or ``argv(rank)``) as each of ``nprocs`` ranks of one group
    on this host (``FDGAN_TPU_DIST`` with coordinates on a free localhost
    port, over this process's environment and ``env``). Returns each rank's
    output (stdout and stderr). A rank that exits with another code than 0
    raises ``RuntimeError`` with its output's end; ranks still running
    ``timeout`` seconds after the start raise ``TimeoutError``. Every rank
    is killed before this returns."""
    coord = f"localhost:{free_port()}"
    procs, logs = [], []
    try:
        for pid in range(nprocs):
            logs.append(tempfile.TemporaryFile(mode="w+"))  # a file, not a pipe: a rank that writes much never blocks
            procs.append(subprocess.Popen(
                list(argv(pid) if callable(argv) else argv), cwd=cwd, stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True,
                env=dict(os.environ, **(env or {}), FDGAN_TPU_DIST="1", FDGAN_TPU_DIST_COORD=coord,
                         FDGAN_TPU_DIST_NPROCS=str(nprocs), FDGAN_TPU_DIST_PID=str(pid))))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                tails = "".join(f"\n--- rank {pid}:\n{log[-2000:]}" for pid, log in enumerate(_read(logs)))
                raise TimeoutError(f"a rank of {nprocs} was still running after {timeout} s{tails}") from None
        out = _read(logs)
        for pid, (p, log) in enumerate(zip(procs, out)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {pid} of {nprocs} exited {p.returncode}:\n{log[-4000:]}")
        return out
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()


def _read(files) -> list:
    out = []
    for f in files:
        f.seek(0)
        out.append(f.read())
    return out
