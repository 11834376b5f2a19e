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
from typing import Callable, Optional, Sequence, Tuple, Union

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


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1, device_type: str = "cuda"):
    """A ``("data", "spatial")`` ``DeviceMesh`` over the ranks of the
    process group (``FDGAN_TPU_DIST``; every rank calls this, as it creates
    the mesh's groups): rank d·n_spatial + s at coordinate (d, s). The
    default puts every rank on ``data``. Raises ``ValueError`` when
    n_data·n_spatial is not the world size, as JAX's ``make_mesh`` does
    (``fdgan_tpu/dist/mesh.py:80-86``), and ``RuntimeError`` without a
    process group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if n_data is None:
        n_data = world // n_spatial
    if n_data < 1 or n_spatial < 1 or n_data * n_spatial != world:
        raise ValueError(f"mesh {n_data}x{n_spatial} does not cover {world} processes")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks under FDGAN_TPU_DIST (with "
                           "FDGAN_TPU_DIST_COORD/_NPROCS/_PID) or torchrun")
    return init_device_mesh(device_type, (n_data, n_spatial), mesh_dim_names=("data", "spatial"))


def mesh_dims(mesh) -> Tuple[int, int]:
    """(n_data, n_spatial) of a mesh from :func:`make_mesh`."""
    dims = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return int(dims["data"]), int(dims["spatial"])


def spatial_rows(h: int, n_spatial: int) -> list:
    """The (start, stop) rows of H that each of ``n_spatial`` shards holds:
    whole blocks of 8 rows (so FDGAN's three ÷2 pools stay on a rank), as
    evenly as they go, the first shards one block more where H/8 does not
    divide by n_spatial. Never padded: in batch BN a padded row would enter
    the statistics. Raises ``ValueError`` where H is not a multiple of 8 or
    H/8 < n_spatial."""
    if h % 8:
        raise ValueError(f"H={h} is not a multiple of 8")
    blocks = h // 8
    if blocks < n_spatial:
        raise ValueError(f"H={h} has {blocks} blocks of 8 rows, fewer than the {n_spatial} spatial shards")
    base, extra = divmod(blocks, n_spatial)
    bounds, start = [], 0
    for s in range(n_spatial):
        stop = start + 8 * (base + (s < extra))
        bounds.append((start, stop))
        start = stop
    return bounds


def mesh_block(shape: Sequence[int], mesh, spatial: bool, coord: Optional[Sequence[int]] = None) -> Tuple[slice, slice]:
    """The (batch rows, H rows) of a (B, H, ...) batch that the rank at
    ``coord`` (default: this rank's) holds: B split evenly over ``data``
    (B must divide by it), H by :func:`spatial_rows` over ``spatial`` when
    ``spatial``, else whole."""
    n_data, n_spatial = mesh_dims(mesh)
    d, s = coord if coord is not None else mesh.get_coordinate()
    b, h = shape[0], shape[1]
    if b % n_data:
        raise ValueError(f"batch {b} does not divide by the mesh's data axis of {n_data}")
    local = b // n_data
    rows = spatial_rows(h, n_spatial)[s] if spatial else (0, h)
    return slice(d * local, (d + 1) * local), slice(*rows)


def shard_batch(batch: Sequence[torch.Tensor], mesh=None, spatial: bool = False) -> tuple:
    """This process's rows of each tensor of a global batch. Without a mesh,
    rank r of W takes rows [r·B/W, (r+1)·B/W) (B must divide by W). With a
    mesh, its block (:func:`mesh_block`): its rows of B on ``data`` and, with
    ``spatial``, its rows of H on ``spatial`` (JAX's ``shard_batch(spatial=
    True)``); :func:`gather_batch` puts the blocks together again."""
    if mesh is not None:
        out = []
        for t in batch:
            rows, hs = mesh_block(t.shape, mesh, spatial)
            out.append(t[rows, hs])
        return tuple(out)
    world, r = world_size(), rank()
    out = []
    for t in batch:
        if t.shape[0] % world:
            raise ValueError(f"global batch {t.shape[0]} does not divide by {world} processes")
        local = t.shape[0] // world
        out.append(t[r * local:(r + 1) * local])
    return tuple(out)


def gather_batch(local: torch.Tensor, shape: Sequence[int], mesh, spatial: bool, dst: int = 0) -> Optional[torch.Tensor]:
    """The blocks of a (B, H, ...) batch of full ``shape`` that the mesh's
    ranks hold (:func:`shard_batch`), put together on rank ``dst``, which
    gets the whole batch; the other ranks send theirs and get None. With
    ``spatial`` off the ranks of a spatial group hold the same block, and
    the first one's is taken. Point to point; a CUDA block goes through host
    memory under gloo, whose point-to-point ops read host memory."""
    n_data, n_spatial = mesh_dims(mesh)
    me = rank()
    staged = local.device.type != "cpu" and dist.get_backend() == "gloo"
    home = torch.device("cpu") if staged else local.device
    if me != dst:
        coord = mesh.get_coordinate()
        if not spatial and coord[1] != 0:
            return None
        # batched, as the receiving side: NCCL runs a batch on the group's communicator and a lone send on
        # one of its own for the pair, and the two would never meet
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, local.to(home).contiguous(), dst)]):
            req.wait()
        return None
    whole = torch.empty(tuple(shape), dtype=local.dtype, device=local.device)
    ops, landed = [], []
    for d in range(n_data):
        for s in range(n_spatial if spatial else 1):
            r = d * n_spatial + s
            rows, hs = mesh_block(shape, mesh, spatial, (d, s))
            if r == me:
                whole[rows, hs] = local
                continue
            buf = torch.empty(whole[rows, hs].shape, dtype=local.dtype, device=home)
            ops.append(dist.P2POp(dist.irecv, buf, r))
            landed.append((rows, hs, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for rows, hs, buf in landed:
        whole[rows, hs] = buf
    return whole


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
def average_gradients(module: torch.nn.Module, group, n_spatial: int = 1) -> None:
    """Every gradient of ``module`` replaced by its sum over the ranks of
    ``group`` divided by the number of data groups, world / ``n_spatial``
    (one flattened all-reduce); nothing at world size 1. The parameters
    without a gradient are the same on every rank.

    The convention: each rank backpropagates its own share of the loss. With
    whole images (``n_spatial`` 1) that is the mean over its rows, and the
    global batch's gradient is the mean of the ranks' gradients. With H
    sharded over a spatial group of ``n_spatial`` ranks it is its band's sum
    over the data group's count (``halo_exchange.global_mean``): the shares
    of a spatial group add up to the data group's loss, so the gradient of
    the global-mean loss is the sum over each spatial group, averaged over
    the data groups. The exchanges' and the statistics all-reduces' backwards
    carry each rank's cotangents to the ranks whose values it read."""
    if group is None or dist.get_world_size(group) == 1:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(dist.get_world_size(group) // n_spatial)

    _flat_apply_(grads, mean)
    counts["grads"] += 1


@torch.no_grad()
def average_metrics(metrics: dict, group, n_spatial: int = 1) -> dict:
    """The 0-d metric tensors summed over the ranks and divided by the data
    groups, world / ``n_spatial`` (one all-reduce): the mean over the ranks
    with whole images, the sum of the band shares within a spatial group
    (:func:`average_gradients`). The dict as it is at world size 1."""
    if group is None or dist.get_world_size(group) == 1 or not metrics:
        return metrics
    flat = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    counts["metrics"] += 1
    return dict(zip(metrics, flat / (dist.get_world_size(group) // n_spatial)))


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
