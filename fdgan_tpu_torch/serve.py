"""Streaming batched-inference engine — the serving path on the GPU.

Counterpart of ``fdgan_tpu/serve.py``. The engine keeps the JAX engine's
serving mechanics:

* **Shape buckets** — inputs are reflect-padded up to multiples of
  ``bucket`` (which also meets FDGAN's ÷8 constraint), so ragged workloads
  run a handful of shapes.
* **Batch ladder** — a group is padded up to the next rung of
  ``batch_sizes`` (1, 2, 4, 8) by cycling its real images.
* **Asynchronous pipeline** — a batch is staged in pinned host memory,
  copied with ``non_blocking=True``, its forward enqueued and its result
  copy started, all without waiting. ``stream()`` asks the oldest batch in
  flight, without waiting, whether its CUDA event has completed on every
  image staging takes and every idle tick, and fetches it as soon as it
  has. It waits on the event only where it must: more than ``depth``
  batches in flight, about ``max_wait`` of quiet input, or the end of the
  input.
* **Running-stats BN by default** — each image's result is independent of
  its batch-mates; batch-stats mode is opt-in.
* **Warmup** — eager PyTorch compiles no program per shape, as XLA does, but
  a shape's first batch still pays for what the card does once: the
  kernels' library loaded and its modules loaded lazily by CUDA, cuDNN's
  choice of algorithms for each conv shape, and the caching allocator's
  growth. :meth:`InferenceEngine.warmup` pays it ahead for every ladder rung
  of given shapes, and ``auto_warm`` for a new shape bucket's other rungs
  in the background after its first batch, as the JAX engine's
  ``warmup`` and ``_spawn_auto_warm`` compile theirs. ``stats["compiles"]``
  counts the first batches of a (batch, H, W) shape, the counterpart of
  JAX's compiles.
* **Spans** — while a ``torch.profiler`` profile runs, each batch records
  ``engine.stage`` (padding, rung fill, stack; ``items``, the stream
  indices it carries; ``why`` the flush path: ``full``, ``aged``,
  ``overflow``, ``end`` or ``tiled``), ``engine.dispatch``,
  and in ``stream()`` ``engine.held`` (dispatched, not yet asked for) and
  ``engine.fetch`` (``why``: ``ready``, ``depth``, ``idle`` or ``end``), all
  under the batch's number (``fdgan_tpu_torch/trace.py``).

The forward is ``models.fdgan_fast.apply`` (as the JAX engine's is
``fdgan_fast.apply``): the encoder's 42 dense layers run through the
hand-written kernels K1 and K2, and in batch-BN mode the segment statistics
through ``channel_stats``; their launch counts appear in ``stats``.

The engine serves any module whose class declares its serving, as FDGAN
and DehazeFormer (``models/dehazeformer.py``) do: its bucket divisor
``multiple``, ``has_bn``, ``input_map`` (a staged batch, uint8 or [0, 1],
to the model's input range on the device) and ``serve_forward(x,
bn_mode)``. ``bn_mode`` and the default bucket of 64 apply only to a model
with BN; any other defaults to its ``multiple``. The tiled, mesh and
spatial routes stay FD-GAN's.

With ``tile`` > 0 an image larger than ``tile`` on either axis takes the
halo-tiled route instead (``dist/tiling.py``): padded to H, W divisible by
8, run tile by tile on the device, and handed back through the same pending
result as a batch, so ``stream()`` and ``predict_batch()`` do not care which
route an image took.

With a ``mesh`` (``dist.mesh.make_mesh``: ranks on a ``data`` and a
``spatial`` axis, one process each) a batch is split on ``data`` and, with
``spatial``, each image's H on ``spatial`` (``dist.mesh.mesh_block``), and
every rank runs its block through the same forward inside
``dist.halo_exchange.spatial_sharding``: the 3×3 convs and K1 take their
neighbours' rows, and every batch statistic is taken over the whole mesh.
JAX does this in one process through GSPMD (``fdgan_tpu/serve.py:117-155``);
here rank 0 is the engine its caller sees, and every other rank builds the
same engine and runs :meth:`InferenceEngine.serve_worker`. For each batch
rank 0 broadcasts a header (the command and the shape) and the staged batch,
every rank runs its block, and rank 0 gathers the output blocks
(``dist.mesh.gather_batch``) into the pending result. ``reload()``
broadcasts the new weights, ``close()`` ends the workers' loop, and the
tiled route runs on rank 0 alone (JAX computes those batch-1 tiles
replicated, to the same values).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import sys
import threading
import traceback
from typing import Callable, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from fdgan_tpu_torch import trace
from fdgan_tpu_torch.dist import halo_exchange
from fdgan_tpu_torch.dist import mesh as dmesh
from fdgan_tpu_torch.dist.tiling import tiled_apply
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.ops import dense, stats

__all__ = ["InferenceEngine"]

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the mesh's header: command, B, H, W, staging dtype (0 float32, 1 uint8); a warmup's forward is _WARM
_CLOSE, _FORWARD, _RELOAD, _WARM = 0, 1, 2, 3
_STAGING = (torch.float32, torch.uint8)
# what _stage yields, besides a staged batch, on an idle tick that ends ~max_wait of quiet input
# (None on any other turn without a batch)
_QUIET = "quiet"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _empty_copy(module: nn.Module, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` on ``device`` whose parameters are left
    uninitialised, the floating ones in ``dtype``, for a load to fill; its
    buffers are copied. The caller's weights are never copied whole."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device=device, dtype=dtype if p.is_floating_point() else p.dtype),
                                requires_grad=p.requires_grad)
            for p in module.parameters()}
    return copy.deepcopy(module, memo).to(device)


class _Pending:
    """A dispatched batch: its result (a pinned host tensor on CUDA, being
    filled by an asynchronous copy), the event that marks the copy done,
    its number in the spans, and where its dispatch span ended (0 where
    none was recorded)."""

    __slots__ = ("host", "event", "batch", "dispatched_ns")

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]):
        self.host = host
        self.event = event
        self.batch: Optional[int] = None
        self.dispatched_ns = 0

    def done(self) -> bool:
        """Whether the result is complete, without waiting: the copy into
        ``host`` is enqueued before the event is recorded."""
        return self.event is None or self.event.query()

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class InferenceEngine:
    """Batched executor for FDGAN dehazing (or a served module's) on one device.

    Parameters
    ----------
    params : an FDGAN module or its state dict, or another module whose
        class declares its serving (copied onto ``device`` and cast per
        ``precision``; the caller's module is left as it is).
    device : where the forward runs, 'cuda' (the default) or 'cpu'.
    precision : 'bf16' (serving default) or 'fp32'. fp32 runs cuDNN without
        TF32, the counterpart of the JAX engine's scoped 'highest' precision.
    bn_mode : 'running' (default, per-image deterministic) or 'batch'
        (reference parity; couples the images of a batch — padded slots
        repeat real images so the statistics stay in distribution).
    bucket : spatial bucket, a multiple of the model's ``multiple`` (8 for
        FDGAN); defaults to 64, or to the ``multiple`` in batch-BN mode or
        for a model without BN, where spatial padding enters the statistics.
    batch_sizes : ascending ladder of batch sizes.
    tile, halo : when ``tile`` > 0, images larger than ``tile`` on either
        axis run one at a time through halo-tiled inference
        (``dist/tiling.py``) instead of being padded to one large bucket.
    output : 'float32' (results in [-1, 1]) or 'uint8' (quantised on the
        device to round((y+1)·127.5) in fp32: a 4× smaller fetch, lossy by
        ≤ 1/255).
    input : staging dtype, 'float32' or 'uint8' ('uint8' uploads one byte
        per pixel and divides by 255 in fp32 on the device, exactly as the
        host would). Either accepts uint8 [0, 255] and float [0, 1] images.
    mesh : a ``dist.mesh.make_mesh`` mesh of this process group's ranks
        (every rank builds the engine alike; ranks other than 0 then run
        :meth:`serve_worker`). The default ladder is (1, 2, 4, 8) × the
        ``data`` size, and every rung must divide by it.
    spatial : with a mesh, shard each image's H over ``spatial`` too (the
        latency lever for few large images); ``bucket`` must divide by the
        ``spatial`` size, and a bucketed H splits into whole blocks of 8
        rows (``dist.mesh.spatial_rows``). Without it a spatial group's
        ranks each run their data block whole.
    auto_warm : after the first batch of a new (H, W) bucket, run its other
        ladder rungs once on a background thread (each under the dispatch
        lock, so on a mesh the ranks hear of them in order); the dedup is
        permanent and a failed warm never stops serving.
    """

    def __init__(
        self,
        params: Union[nn.Module, Mapping[str, torch.Tensor]],
        *,
        device: Union[str, torch.device] = "cuda",
        precision: str = "bf16",
        bn_mode: str = "running",
        bucket: Optional[int] = None,
        batch_sizes: Optional[Sequence[int]] = None,
        tile: int = 0,
        halo: int = 128,
        output: str = "float32",
        input: str = "float32",
        mesh=None,
        spatial: bool = False,
        auto_warm: bool = False,
    ):
        if precision not in _DTYPES:
            raise ValueError(f"precision must be 'bf16' or 'fp32', got {precision!r}")
        if bn_mode not in ("batch", "running"):
            raise ValueError(f"bn_mode must be 'batch' or 'running', got {bn_mode!r}")
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be 'float32' or 'uint8', got {output!r}")
        if input not in ("float32", "uint8"):
            raise ValueError(f"input must be 'float32' or 'uint8', got {input!r}")
        # the served class declares its bucket divisor, whether it has BN, its input map and its forward
        self._cls = type(params) if isinstance(params, nn.Module) else FDGAN
        missing = [a for a in ("multiple", "has_bn", "input_map", "serve_forward") if not hasattr(self._cls, a)]
        if missing:
            raise TypeError(f"a served {self._cls.__name__} must declare {', '.join(missing)}")
        if self._cls is not FDGAN and (tile or mesh is not None or spatial):
            raise ValueError("the tiled, mesh and spatial routes serve FD-GAN only")
        multiple = int(self._cls.multiple)
        if bucket is None:  # padding enters batch-BN's statistics and RLN's: there, the divisor alone
            bucket = 64 if self._cls.has_bn and bn_mode == "running" else multiple
        if bucket % multiple:
            raise ValueError(f"bucket must be a multiple of {multiple} ({self._cls.__name__}'s divisor), got {bucket}")
        if tile and (tile % 8 or tile <= 2 * halo):
            raise ValueError(f"tile must be a multiple of 8 and exceed 2*halo, got tile {tile} halo {halo}")
        n_data, n_spatial = dmesh.mesh_dims(mesh) if mesh is not None else (1, 1)
        if batch_sizes is None:
            batch_sizes = tuple(b * n_data for b in (1, 2, 4, 8))
        if not batch_sizes or list(batch_sizes) != sorted(set(batch_sizes)):
            raise ValueError("batch_sizes must be ascending and non-empty")
        if any(b < 1 for b in batch_sizes):
            raise ValueError(f"batch_sizes must be positive, got {tuple(batch_sizes)}")
        if any(b % n_data for b in batch_sizes):
            raise ValueError(f"batch_sizes {tuple(batch_sizes)} must be divisible by the mesh data-axis size {n_data}")
        if mesh is not None and spatial and bucket % n_spatial:
            # every bucketed H (a multiple of bucket) must divide by the spatial axis, as JAX's device_put needs
            raise ValueError(f"bucket {bucket} must be divisible by the mesh 'spatial' axis size {n_spatial} "
                             "for H sharding")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.precision = precision
        self.bn_mode = bn_mode
        self.bucket = int(bucket)
        self.batch_sizes = tuple(int(b) for b in batch_sizes)
        self.tile = int(tile)
        self.halo = int(halo)
        self.output = output
        self.input = input
        self._stage_dtype = np.uint8 if input == "uint8" else np.float32
        self._dtype = _DTYPES[precision]
        self.mesh = mesh
        self.spatial = bool(spatial) and mesh is not None
        self._rank = dmesh.rank() if mesh is not None else 0
        self._model = self._materialise(params, check_against=None)
        self._lock = threading.Lock()
        self.weights_version = 0  # bumped by reload(); 0 = the __init__ weights
        self.stats = {
            "images": 0,
            "batches": 0,
            "compiles": 0,
            "reloads": 0,
            "padded_frac": 0.0,
            "k1_launches": 0,
            "k2_launches": 0,
            "channel_stats_launches": 0,
        }
        self._pix_real = 0
        self._pix_padded = 0
        self._seen: set = set()     # (batch, H, W) shapes that have run: their first run is a "compile"
        self._batch_ids = itertools.count()  # a staged batch's number in the spans
        self._auto_warm = bool(auto_warm)
        self._warmed: set = set()   # (H, W) buckets ever auto-warmed (dedup)
        self._warming: set = set()  # (H, W) buckets with a warm thread live
        if mesh is not None:  # every rank serves rank 0's weights
            self._broadcast_weights(self._model)

    # --- weights -------------------------------------------------------------

    def _materialise(self, params, check_against: Optional[nn.Module]) -> nn.Module:
        """A fresh FDGAN (or an empty copy of the served module) on the
        engine's device and dtype holding ``params``. With ``check_against``, a module
        must be of its class, and the state dict must match its keys, shapes
        and (after the precision cast) dtypes."""
        if check_against is not None and isinstance(params, nn.Module) and not isinstance(params, type(check_against)):
            raise ValueError(f"reload: a {type(params).__name__} cannot replace the live "
                             f"{type(check_against).__name__} — wrong model family?")
        state = params.state_dict() if isinstance(params, nn.Module) else dict(params)
        cast = {
            k: v.to(self._dtype) if self._dtype == torch.bfloat16 and v.is_floating_point() else v
            for k, v in state.items()
        }
        if check_against is not None:
            cur = check_against.state_dict()
            if set(cast) != set(cur):
                diff = sorted(set(cast) ^ set(cur))
                raise ValueError(
                    f"reload: checkpoint structure differs from the loaded weights "
                    f"({len(cast)} vs {len(cur)} entries; first difference {diff[0]!r})"
                    " — wrong model family or config?"
                )
            for k, v in cast.items():
                if tuple(v.shape) != tuple(cur[k].shape):
                    raise ValueError(
                        f"reload: {k} has shape {tuple(v.shape)}, loaded weights have "
                        f"{tuple(cur[k].shape)} — wrong model family or config?"
                    )
                if v.dtype != cur[k].dtype:
                    raise ValueError(
                        f"reload: {k} has dtype {v.dtype}, loaded weights have {cur[k].dtype}"
                    )
        # a copy of the live module skips the random init, which the load overwrites
        if check_against is not None:
            model = copy.deepcopy(check_against)
        elif self._cls is FDGAN:
            model = FDGAN(device=self.device, dtype=self._dtype)
        else:
            model = _empty_copy(params, self.device, self._dtype)
        model.load_state_dict(cast, strict=True)
        return model.eval()

    def reload(self, params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
        """Swap the generator weights without dropping a request.

        The new weights are checked entry by entry (a mismatch raises
        ``ValueError`` and the old weights stay live) and copied to the
        device before the swap. The swap happens under the lock that
        serialises dispatches: batches already dispatched finish on the old
        weights, every later one uses the new. Returns the new
        ``weights_version``."""
        self._check_rank0("reload")
        new = self._materialise(params, check_against=self._model)
        with self._lock:
            if self.mesh is not None:
                self._broadcast_header(_RELOAD)
                self._broadcast_weights(new)
            self._model = new
            self.weights_version += 1
            self.stats["reloads"] += 1
            return self.weights_version

    # --- the forward -----------------------------------------------------------

    def _forward(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        y = model.serve_forward(model.input_map(x).to(self._dtype), self.bn_mode)
        if self.output == "uint8":
            # quantise on the device in fp32 (bf16 would itself cost a level)
            y = torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0.0, 255.0)
            return y.to(torch.uint8)
        return y.float()

    def _forward_block(self, model: FDGAN, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole staged batch ``x`` (on the device)
        through the forward, inside the mesh's spatial context."""
        (block,) = dmesh.shard_batch((x,), self.mesh, self.spatial)
        group = self.mesh.get_group("spatial") if self.spatial else None
        with halo_exchange.spatial_sharding(group, dmesh.process_group()):
            return self._forward(model, block)

    def _forward_tiled(self, model: FDGAN, x: torch.Tensor) -> torch.Tensor:
        return tiled_apply(lambda t: self._forward(model, t), x, tile=self.tile, halo=self.halo)

    def _exact(self):
        """fp32 is checkpoint-parity mode: cuDNN would otherwise run its convs
        in TF32. A new context each time: a generator's cannot be re-entered."""
        if self.precision == "fp32":
            return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
        return contextlib.nullcontext()

    def _run(self, x: torch.Tensor, tiled: bool, cmd: int = _FORWARD) -> _Pending:
        """Under the lock: upload, enqueue the forward (tile by tile when
        ``tiled``; on the mesh, its header ``cmd`` to the ranks first) and
        start the result copy; no wait."""
        meshed = self.mesh is not None and not tiled
        forward = self._forward_tiled if tiled else self._forward_mesh if meshed else self._forward
        with torch.inference_mode(), self._exact():
            if meshed:  # a shape the mesh cannot split raises here, before the ranks hear of it
                dmesh.mesh_block(x.shape, self.mesh, self.spatial)
                self._broadcast_header(cmd, x)
            if self.device.type != "cuda":
                return _Pending(forward(self._model, x), None)
            x = x.pin_memory().to(self.device, non_blocking=True)
            y = forward(self._model, x)
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return _Pending(host, event)

    def _dispatch(self, batch: np.ndarray, tiled: bool = False, number: Optional[int] = None) -> _Pending:
        """Upload, enqueue the forward (tile by tile when ``tiled``) and
        start the result copy; no wait. ``number`` is the batch's number in
        the spans (a new one where None)."""
        x = torch.from_numpy(batch)
        self._check_rank0("dispatch")
        number = next(self._batch_ids) if number is None else number
        with trace.span("engine.dispatch", batch=number) as sp, self._lock:
            k1, k2, ks = dense.k1_launches, dense.k2_launches, stats.launches
            pending = self._run(x, tiled)
            shape = (x.shape[0], x.shape[1], x.shape[2], tiled)
            fresh = shape not in self._seen
            self._seen.add(shape)
            self.stats["compiles"] += int(fresh)
            self.stats["batches"] += 1
            self.stats["k1_launches"] += dense.k1_launches - k1
            self.stats["k2_launches"] += dense.k2_launches - k2
            self.stats["channel_stats_launches"] += stats.launches - ks
        pending.batch = number
        if sp:
            pending.dispatched_ns = sp.end
        if fresh and self._auto_warm and not tiled:
            self._spawn_auto_warm(int(x.shape[1]), int(x.shape[2]), int(x.shape[0]))
        return pending

    # --- warmup ---------------------------------------------------------------

    def _warm_one(self, b: int, h: int, w: int) -> None:
        """One forward of a zero batch of (b, h, w), waited for, outside
        the dispatch statistics (a header of its own on the mesh, which the
        ranks do not count either)."""
        x = torch.from_numpy(np.zeros((b, h, w, 3), self._stage_dtype))
        with self._lock:
            pending = self._run(x, False, _WARM)
            self._seen.add((b, h, w, False))
        pending.fetch()

    def warmup(self, shapes: Iterable[Tuple[int, int]], batch: Optional[int] = None) -> None:
        """Run every rung of the batch ladder (``batch``: that rung only) at
        the bucket of each (H, W) of ``shapes`` once, as the JAX engine's
        ``warmup`` compiles them: a batch of a shape the engine has not run
        yet counts in ``stats["compiles"]``; the other statistics do not
        move. On a mesh the ranks run them too."""
        self._check_rank0("warmup")
        rungs = self.batch_sizes if batch is None else (batch,)
        for h, w in shapes:
            H, W = self._bucket_hw(h, w)
            for rung in rungs:
                b = self._batch_bucket(rung)
                with self._lock:
                    self.stats["compiles"] += int((b, H, W, False) not in self._seen)
                self._warm_one(b, H, W)

    def _spawn_auto_warm(self, H: int, W: int, done_rung: int) -> None:
        """The bucket (H, W) just ran its first batch at ``done_rung``: run
        its other rungs on a background thread, each under the lock (a
        request waits for at most one warm forward). Once per bucket ever;
        a failure is reported on stderr and serving goes on; these runs do
        not count in ``stats["compiles"]``, as JAX's do not."""
        with self._lock:
            if (H, W) in self._warmed:
                return
            self._warmed.add((H, W))
            self._warming.add((H, W))

        def warm():
            try:
                for rung in self.batch_sizes:
                    b = self._batch_bucket(rung)
                    if b != done_rung:
                        self._warm_one(b, H, W)
            except Exception:  # a warm failure must never stop serving: report it and go on
                print(f"auto-warm of bucket {H}x{W} failed; serving goes on", file=sys.stderr)
                traceback.print_exc()
            finally:
                with self._lock:
                    self._warming.discard((H, W))

        threading.Thread(target=warm, name=f"fdgan-warm-{H}x{W}", daemon=True).start()

    # --- the mesh ------------------------------------------------------------------

    def _check_rank0(self, what: str) -> None:
        if self._rank != 0:
            raise RuntimeError(f"{what} on rank {self._rank}: rank 0 of a mesh serves; the other ranks run "
                               "serve_worker()")

    def _broadcast_header(self, cmd: int, x: Optional[torch.Tensor] = None) -> List[int]:
        """Rank 0 sends, the others receive, the command and the batch's
        shape and staging dtype. Returns the header."""
        header = torch.zeros(5, dtype=torch.int64)
        if x is not None:
            header[:4] = torch.tensor([cmd, *x.shape[:3]])
            header[4] = _STAGING.index(x.dtype)
        else:
            header[0] = cmd
        header = header.to(self.device)
        torch.distributed.broadcast(header, src=0)
        return header.tolist()

    def _broadcast_weights(self, model: FDGAN) -> None:
        """Rank 0's state dict into every rank's ``model``, in place."""
        dmesh._flat_apply_(list(model.state_dict().values()), lambda flat: torch.distributed.broadcast(flat, src=0))

    def _forward_mesh(self, model: FDGAN, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's side of a batch on the mesh: the staged batch to every
        rank, its own block through the forward, the blocks gathered."""
        torch.distributed.broadcast(x, src=0)
        y = self._forward_block(model, x)
        return dmesh.gather_batch(y, tuple(x.shape[:3]) + y.shape[3:], self.mesh, self.spatial)

    def serve_worker(self) -> None:
        """A rank other than 0: run rank 0's batches until it calls
        :meth:`close` (its reloads too). Returns when rank 0 closes."""
        if self.mesh is None or self._rank == 0:
            raise RuntimeError("serve_worker runs on the ranks other than 0 of a mesh")
        while True:
            cmd, b, h, w, code = self._broadcast_header(_CLOSE)
            if cmd == _CLOSE:
                return
            if cmd == _RELOAD:
                new = copy.deepcopy(self._model)
                self._broadcast_weights(new)
                self._model = new
                self.weights_version += 1
                self.stats["reloads"] += 1
                continue
            with torch.inference_mode(), self._exact():
                k1, k2, ks = dense.k1_launches, dense.k2_launches, stats.launches
                x = torch.empty((b, h, w, 3), dtype=_STAGING[code], device=self.device)
                torch.distributed.broadcast(x, src=0)
                y = self._forward_block(self._model, x)
                dmesh.gather_batch(y, (b, h, w) + y.shape[3:], self.mesh, self.spatial)
                if cmd == _WARM:  # outside the statistics, as on rank 0
                    continue
                self.stats["batches"] += 1
                self.stats["k1_launches"] += dense.k1_launches - k1
                self.stats["k2_launches"] += dense.k2_launches - k2
                self.stats["channel_stats_launches"] += stats.launches - ks

    def close(self) -> None:
        """Rank 0 of a mesh: end the workers' loops (no batch may follow).
        Nothing without a mesh."""
        if self.mesh is None:
            return
        self._check_rank0("close")
        with self._lock:
            self._broadcast_header(_CLOSE)

    # --- shape management ------------------------------------------------------

    def _bucket_hw(self, h: int, w: int) -> Tuple[int, int]:
        return _round_up(max(h, 8), self.bucket), _round_up(max(w, 8), self.bucket)

    def _batch_bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def _ingest(self, img) -> np.ndarray:
        """Bring one caller image to the staging dtype: uint8 means [0, 255],
        float means [0, 1]; only float → uint8 quantises (lossy ≤ 1/510)."""
        a = np.asarray(img)
        if a.dtype == np.uint8:
            return a if self.input == "uint8" else a.astype(np.float32) / 255.0
        if self.input == "uint8":
            a = np.asarray(a, np.float32)
            return np.clip(np.round(a * 255.0), 0.0, 255.0).astype(np.uint8)
        return np.asarray(a, np.float32)

    @staticmethod
    def _pad_hw(img: np.ndarray, H: int, W: int) -> np.ndarray:
        ph, pw = H - img.shape[0], W - img.shape[1]
        if ph or pw:
            # reflect needs pad < dim; fall back to edge for tiny images
            mode = "reflect" if ph < img.shape[0] and pw < img.shape[1] else "edge"
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode=mode)
        return img

    # --- public API --------------------------------------------------------------

    def predict(self, image: np.ndarray) -> np.ndarray:
        """Dehaze one HWC image (float [0, 1] or uint8 [0, 255]); returns HWC
        fp32 in [-1, 1], or uint8 for an ``output='uint8'`` engine."""
        return self.predict_batch([image])[0]

    def predict_batch(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Dehaze a list of HWC images of any shapes; results in input order."""
        out: List[Optional[np.ndarray]] = [None] * len(images)
        for staged in self._stage(enumerate(images)):
            if staged is None:  # no batch this time
                continue
            pending, metas = staged
            y = pending.fetch()
            for slot, (idx, h, w) in enumerate(metas):
                out[idx] = y[slot, :h, :w].copy()  # a view would pin the batch
        return out  # type: ignore[return-value]

    def stream(
        self,
        images: Iterable[np.ndarray],
        depth: int = 2,
        max_wait: float = 0.0,
        taken: Optional[Callable[[int], None]] = None,
    ) -> Iterator[np.ndarray]:
        """Pipelined streaming inference, yielding results in input order.

        Host staging of later batches overlaps device work on earlier ones.
        On every image staging takes and every idle tick, the oldest batch
        in flight is fetched as soon as its result is back (``ready``; the
        batches run on one stream, so they finish in order). It is waited
        for only while more than ``depth`` batches are in flight
        (``depth``), once after about ``max_wait`` of quiet input
        (``idle``), and at the end of the input (``end``): ``depth`` is the
        most batches dispatched and not yet fetched. ``max_wait`` (seconds,
        0 = off) bounds per-image staging latency: a group whose oldest
        image has waited longer is flushed below its ladder rung, also
        while the input iterator is idle (the bound holds as long as the
        consumer keeps iterating). ``taken``, where given, is called with
        an image's index in ``images`` as staging takes it."""
        inflight: collections.deque = collections.deque()
        ready: dict = {}
        next_idx = 0

        def drain_one(why):
            pending, metas = inflight.popleft()
            with trace.span("engine.fetch", batch=pending.batch, why=why) as sp:
                if sp and pending.dispatched_ns:
                    trace.record("engine.held", pending.dispatched_ns, sp.start, batch=pending.batch)
                y = pending.fetch()  # waits only where the batch is not done
                for slot, (idx, h, w) in enumerate(metas):
                    ready[idx] = y[slot, :h, :w].copy()

        def emit():
            nonlocal next_idx
            while next_idx in ready:
                yield ready.pop(next_idx)
                next_idx += 1

        for staged in self._stage(enumerate(images), max_wait=max_wait, taken=taken):
            quiet = staged is _QUIET
            if staged is not None and not quiet:
                inflight.append(staged)
            while inflight:
                if inflight[0][0].done():
                    why = "ready"
                elif len(inflight) > depth:
                    why = "depth"
                elif quiet:  # the head still runs after ~max_wait of quiet: wait for it once
                    why, quiet = "idle", False
                else:
                    break
                drain_one(why)
            yield from emit()
        while inflight:
            drain_one("end")
            yield from emit()

    # --- staging -----------------------------------------------------------------

    def _timed_events(self, indexed_images, max_wait: float):
        """Wrap an (idx, img) iterator so ``None`` ticks come while the
        producer is idle: a daemon thread pulls items into a shallow bounded
        queue (backpressure) and the consumer polls it with a timeout below
        ``max_wait``. The producer stops if the consumer abandons the
        generator."""
        import queue as _queue

        q: _queue.Queue = _queue.Queue(maxsize=4)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def produce():
            try:
                for item in indexed_images:
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except _queue.Full:
                        continue

        threading.Thread(target=produce, daemon=True).start()
        tick = max(max_wait / 4.0, 0.005)
        try:
            while True:
                try:
                    item = q.get(timeout=tick)
                except _queue.Empty:
                    yield None
                    continue
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()

    def _stage(self, indexed_images, max_wait: float = 0.0, taken: Optional[Callable[[int], None]] = None):
        """Group (index, image) pairs into dispatched batches.

        Yields (pending, metas) with metas[slot] = (orig_index, h, w); the
        result is not waited for. Between batches it hands control back
        after every pair taken and every idle tick: None, or ``_QUIET`` on
        an idle tick that ends about ``max_wait`` of quiet. A group flushes
        at the top of the ladder; the oldest group is force-flushed once
        more than 2×top images are staged, or (``max_wait`` > 0) once its
        oldest image has waited longer than that, checked on every arrival
        and on idle ticks; the rest flush at the end of input.
        ``taken(index)``, where given, is called as each pair is taken from
        the input."""
        import time as _time

        groups: dict = collections.defaultdict(list)  # (H, W) -> [(idx, img)]
        born: dict = {}  # (H, W) -> arrival time of the group's oldest image
        top = self.batch_sizes[-1]
        max_pending = 2 * top

        def flush(key, why):
            """Stage and dispatch the group ``key``; ``why`` names the
            flush path in the spans."""
            H, W = key
            items = groups.pop(key)
            number = next(self._batch_ids)
            with trace.span("engine.stage", batch=number, why=why) as sp:
                if sp:
                    sp.attrs["items"] = [idx for idx, _ in items]
                n = len(items)
                b = self._batch_bucket(n)
                padded = [self._pad_hw(img, H, W) for _, img in items]
                # fill the ladder rung by cycling real images: in batch-BN mode
                # this keeps the coupled statistics in distribution
                while len(padded) < b:
                    padded.append(padded[len(padded) % n])
                metas = [(idx, img.shape[0], img.shape[1]) for idx, img in items]
                self._account(n, sum(im.shape[0] * im.shape[1] for _, im in items), b * H * W)
                staged = np.stack(padded)
            return self._dispatch(staged, number=number), metas

        def flush_aged():
            now = _time.monotonic()
            for k in [k for k, t0 in born.items() if now - t0 > max_wait]:
                if k in groups:
                    born.pop(k, None)
                    yield flush(k, "aged")

        if max_wait > 0:
            indexed_images = self._timed_events(indexed_images, max_wait)
        idle_ticks = 0
        for item in indexed_images:
            if item is None:  # idle tick: deadlines first
                idle_ticks += 1
                yield from flush_aged()
                # quiet only after ~max_wait (4 ticks): stream() then waits
                # for a batch still running, and doing that on every short
                # gap would collapse the pipeline window
                yield _QUIET if idle_ticks >= 4 else None
                continue
            idle_ticks = 0
            idx, img = item
            if taken is not None:
                taken(idx)
            img = self._ingest(img)
            if img.ndim != 3 or img.shape[-1] != 3:
                raise ValueError(f"expected HWC RGB image, got shape {img.shape}")
            if self.tile and max(img.shape[0], img.shape[1]) > self.tile:
                yield self._stage_tiled(idx, img)
                continue
            key = self._bucket_hw(img.shape[0], img.shape[1])
            if key not in groups:
                born[key] = _time.monotonic()
            groups[key].append((idx, img))
            if len(groups[key]) == top:
                born.pop(key, None)
                yield flush(key, "full")
            elif sum(len(v) for v in groups.values()) > max_pending:
                oldest = min(groups, key=lambda k: groups[k][0][0])
                born.pop(oldest, None)
                yield flush(oldest, "overflow")
            if max_wait > 0:
                yield from flush_aged()
            yield None  # stream() polls the batches in flight
        for key in list(groups):
            yield flush(key, "end")

    def _stage_tiled(self, idx: int, img: np.ndarray):
        """High-res route: one image padded to H, W divisible by 8 and
        dispatched through halo-tiled inference; the same (pending, metas)
        contract as a staged batch."""
        h, w = img.shape[:2]
        H, W = _round_up(h, 8), _round_up(w, 8)
        number = next(self._batch_ids)
        with trace.span("engine.stage", batch=number, why="tiled", items=[idx]):
            self._account(1, h * w, H * W)
            staged = self._pad_hw(img, H, W)[None]
        return self._dispatch(staged, tiled=True, number=number), [(idx, h, w)]

    def _account(self, n: int, real_pix: int, staged_pix: int) -> None:
        """Count ``n`` staged images: ``real_pix`` pixels of theirs in
        ``staged_pix`` pixels dispatched."""
        with self._lock:
            self._pix_real += real_pix
            self._pix_padded += staged_pix - real_pix
            self.stats["images"] += n
            self.stats["padded_frac"] = self._pix_padded / max(1, self._pix_real + self._pix_padded)
