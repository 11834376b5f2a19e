"""The alternating G/D adversarial train step of FD-GAN in PyTorch.

Counterpart of ``fdgan_tpu/train/loop.py`` (``create_train_state``,
``make_train_step``, ``make_gd_steps``): the FDGAN generator against the
fusion discriminator ``NLayerDiscriminator(input_nc=9)`` over concat[RGB,
LF, HF], two Adams (β1 0.5, β2 0.999, ε 1e-8), the reference's linear
learning-rate decay and an optional global-norm clip.

One step, in the JAX step's order (``loop.py:196-223``):

1. G forward (``models.fdgan_fast.apply``, as the JAX step's default
   ``impl="xla"`` runs ``fdgan_fast.apply``) with the batch statistics of
   every BN captured;
2. the G loss and its backward (D's and VGG's parameters frozen), then
   G's Adam update;
3. the captured statistics folded into G's running statistics (momentum
   0.1) under ``no_grad``;
4. a D step on the G output of step 1, detached.

Mixed precision is the JAX package's: ``compute_dtype`` casts the inputs
only; parameters and Adam state stay fp32, and each conv casts its weight
where it is used. ``impl='kernels'`` runs G's dense layers through K1/K2,
bf16 batch statistics through ``channel_stats`` and D's input through K3
(their plain versions for CPU tensors);
``impl='plain'`` runs the plain versions on any device.

Gradient accumulation (``accum_steps``) and rematerialisation (``remat``)
are the JAX step's memory levers.

Data parallelism (``group``, a ``torch.distributed`` process group): each
rank runs the step on its own slice of the global batch, as JAX's step runs
on a batch sharded over a mesh. Every batch statistic is taken over the
global batch (``dist.stats.global_batch_stats``, entered around the
forwards and the backwards both, so that a remat recompute combines again),
G's and D's gradients are averaged over the ranks by one flattened
all-reduce per model per update, after ``accum_steps``' scaling and before
the clip and Adam (the clip then sees the global gradient, as optax's does
under GSPMD), and the returned metrics are averaged over the ranks, so
that they are the global batch's. With equal local batches the step is then
JAX's step on the global batch; each rank applies the same update to the
same state. ``group=None``, or a group of one rank, issues no collective:
bit for bit the single-process step.

Spatial sharding (``mesh``, ``dist.mesh.make_mesh``'s ("data", "spatial")
mesh; ``cli/train --spatialShards``): the ranks of a spatial group hold the
same images, each a band of their rows (``dist.mesh.shard_batch(mesh,
spatial=True)``), and the step runs G's and D's forwards and backwards
inside ``dist.halo_exchange.spatial_sharding`` (the spatial group, the whole
mesh): the convs, K1, K3 and SSIM take their halo rows from the
neighbouring bands, the batch statistics are taken over the whole mesh, and
each loss is the rank's share of the whole image's mean. The gradients are
summed over each spatial group and averaged over the data groups
(``dist.mesh.average_gradients``' convention), as are the metrics. With a
spatial axis of 1 the step is the data-parallel step above. The state is updated in place: a step
returns the same ``TrainState``.

The device-resident loop (JAX's ``make_device_loop``, ``make_device_pool_loop``
and ``make_device_eval``, ``loop.py:228-341``; ``cli/train --deviceSteps``):
the dataset staged on the device as ``(n_batches, b, H, W, 3)`` tensors, and
a chunk of K steps that reads each batch by a device-side index and stacks
its metrics on the device, so that the host enqueues K steps without
waiting on the device once and fetches the metrics once a chunk. Where JAX
runs the chunk as one ``lax.scan`` dispatch, the port enqueues the same
steps eagerly; a chunk without a host synchronisation is what lets the
host run ahead of the device, and what a CUDA graph of a chunk would need.
``make_device_eval`` runs the val set staged on the device and fetches two
scalars.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from fdgan_tpu_torch.dist.halo_exchange import spatial_sharding
from fdgan_tpu_torch.dist.mesh import average_gradients, average_metrics, mesh_dims, process_group
from fdgan_tpu_torch.dist.stats import global_batch_stats
from fdgan_tpu_torch.losses.composite import LossWeights, discriminator_loss, generator_loss
from fdgan_tpu_torch.models import fdgan_fast
from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.models.vgg16 import VGG16
from fdgan_tpu_torch.nn.layers import fold_stats
from fdgan_tpu_torch.train.schedule import linear_decay_schedule

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    g: FDGAN
    d: NLayerDiscriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0       # G updates, the JAX state's ``step``
    d_updates: int = 0  # D updates: the count D's schedule is evaluated at


@torch.no_grad()
def clip_grad(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: the grads stay as they are while their
    global norm is below ``max_norm``, else each becomes (g / norm)·max_norm.
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm.) Returns the
    norm; no host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass(frozen=True)
class Transform:
    """What an optax chain holds besides Adam's moments: the learning-rate
    schedule, evaluated at the update count, and the clip (0 = off).
    ``scheduled``: the schedule decays (optax then keeps a second count,
    which a JAX ``TrainState`` file holds; ``io/checkpoint.py``)."""

    lr: Callable[[int], float]
    clip_grad: float = 0.0
    scheduled: bool = False

    def apply(self, opt: torch.optim.Optimizer, count: int) -> None:
        """One update of ``opt`` from the grads its parameters hold."""
        if self.clip_grad > 0:
            clip_grad((p for group in opt.param_groups for p in group["params"]), self.clip_grad)
        for group in opt.param_groups:
            group["lr"] = self.lr(count)
        opt.step()


def create_train_state(
    seed: int = 0,
    lr_g: float = 2e-4,
    lr_d: float = 2e-4,
    beta1: float = 0.5,
    decay_every: int = 0,
    decay_start: int = 0,
    clip_grad: float = 0.0,
    device="cuda",
) -> Tuple[TrainState, Transform, Transform]:
    """G and D on ``device`` (the card unless asked otherwise) with
    torch-style random weights from ``seed`` (G from ``seed``, D from
    ``seed + 1``), fresh Adams, and the two transforms.
    ``decay_every`` = 0 keeps the learning rates constant; ``decay_start``
    delays the decay."""
    g = FDGAN(device=device, generator=torch.Generator().manual_seed(seed))
    d = NLayerDiscriminator(input_nc=9, device=device, generator=torch.Generator().manual_seed(seed + 1))

    def transform(lr):
        sched = linear_decay_schedule(lr, decay_every, decay_start) if decay_every else (lambda count: lr)
        return Transform(sched, clip_grad, scheduled=bool(decay_every))

    def adam(module, lr):
        return torch.optim.Adam(module.parameters(), lr=lr, betas=(beta1, 0.999), eps=1e-8)

    state = TrainState(g=g, d=d, g_opt=adam(g, lr_g), d_opt=adam(d, lr_d))
    return state, transform(lr_g), transform(lr_d)


@contextlib.contextmanager
def _frozen(*modules: Optional[nn.Module]):
    """Parameters that gradients pass through but do not accumulate in."""
    params = [p for m in modules if m is not None for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _groups(group, mesh):
    """(the step's whole group, its spatial group or None, the spatial
    axis' size) for ``group`` and ``mesh``."""
    if mesh is None:
        return group, None, 1
    n_spatial = mesh_dims(mesh)[1]
    return (group if group is not None else process_group()), mesh.get_group("spatial"), n_spatial


def _steps(tx_g, tx_d, weights, vgg, compute_dtype, impl, real_label, remat=False, accum_steps=1, group=None,
           mesh=None):
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    group, sp_group, n_spatial = _groups(group, mesh)

    def sharded():
        """The context of the forwards and backwards: the batch statistics
        over ``group``, and with a mesh the spatial sharding over its
        spatial group."""
        return spatial_sharding(sp_group, group) if sp_group is not None else global_batch_stats(group)

    def g_update(state: TrainState, haze, gt) -> Tuple[Metrics, torch.Tensor]:
        if haze.shape[0] % accum_steps:
            raise ValueError(f"batch {haze.shape[0]} not divisible by accum_steps {accum_steps}")
        micro = haze.shape[0] // accum_steps
        parts = []  # (terms, stats, x_hat) of each microbatch
        with _frozen(state.d, vgg), sharded():
            state.g_opt.zero_grad(set_to_none=True)
            for h, g in zip(haze.split(micro), gt.split(micro)):
                stats: dict = {}
                x_hat = fdgan_fast.apply(state.g, h.to(compute_dtype), bn_mode="batch", impl=impl, stats_out=stats,
                                         remat=remat)
                _, terms = generator_loss(state.d, x_hat, g.to(compute_dtype), weights, vgg, impl)
                terms["total"].backward()
                parts.append(({k: v.detach() for k, v in terms.items()}, stats, x_hat.detach()))
        if accum_steps == 1:
            terms, stats, x_hat = parts[0]
        else:
            # JAX's scan (loop.py:162-194): the summed grads times 1/accum_steps, and the
            # terms and the BN moments (mean, unbiased var) averaged over the microbatches
            for p in state.g.parameters():
                if p.grad is not None:
                    p.grad.mul_(1.0 / accum_steps)
            terms = {k: torch.stack([t[k] for t, _, _ in parts]).mean(0) for k in parts[0][0]}
            stats = {k: tuple(torch.stack([s[k][j] for _, s, _ in parts]).mean(0) for j in (0, 1))
                     for k in parts[0][1]}
            x_hat = torch.cat([x for _, _, x in parts])
        average_gradients(state.g, group, n_spatial)
        tx_g.apply(state.g_opt, state.step)
        fold_stats(state.g, stats)
        state.step += 1
        return average_metrics({f"g_{k}": v for k, v in terms.items()}, group, n_spatial), x_hat

    def d_update(state: TrainState, fake, gt) -> Metrics:
        with sharded():
            loss, terms = discriminator_loss(state.d, fake, gt.to(compute_dtype), real_label, impl)
            state.d_opt.zero_grad(set_to_none=True)
            loss.backward()
        average_gradients(state.d, group, n_spatial)
        tx_d.apply(state.d_opt, state.d_updates)
        state.d_updates += 1
        return average_metrics({k: v.detach() for k, v in terms.items()}, group, n_spatial)

    return g_update, d_update


def make_train_step(
    tx_g: Transform,
    tx_d: Transform,
    weights: LossWeights = LossWeights(),
    vgg: Optional[VGG16] = None,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "kernels",
    real_label: float = 1.0,
    remat=False,
    accum_steps: int = 1,
    group=None,
    mesh=None,
):
    """``train_step(state, haze, gt) -> (state, metrics)``: a G update, the
    BN fold, then a D update on the pre-update G output. NHWC ``haze`` and
    ``gt`` in [0, 1]; the metrics are detached 0-d tensors (``g_total``,
    ``g_adv``, ``g_pixel``, ``g_ssim``, …, ``d_total``, ``d_real``,
    ``d_fake``).

    ``remat`` (False | True | "stages") is ``fdgan_fast.apply``'s.
    ``accum_steps`` > 1 splits the batch into that many equal microbatches
    (a batch that does not divide raises ``ValueError``), each with its own
    forward, batch statistics and backward; G's gradients, the loss terms
    and the BN moments folded into the running statistics are averaged over
    them, as JAX ``make_train_step(accum_steps=)``; D trains on the whole
    batch's G output.

    ``group``: the data-parallel step over the ranks of that process group
    (the module's docstring); ``haze`` and ``gt`` are this rank's slice of
    the global batch. ``mesh``: the step with H sharded over the mesh's
    spatial axis (``group`` then defaults to the whole process group), and
    ``haze`` and ``gt`` this rank's block (``dist.mesh.shard_batch(mesh,
    spatial=True)``)."""
    g_update, d_update = _steps(tx_g, tx_d, weights, vgg, compute_dtype, impl, real_label, remat, accum_steps,
                                group, mesh)

    def train_step(state: TrainState, haze: torch.Tensor, gt: torch.Tensor) -> Tuple[TrainState, Metrics]:
        metrics, x_hat = g_update(state, haze, gt)
        metrics.update(d_update(state, x_hat, gt))
        return state, metrics

    return train_step


def make_gd_steps(
    tx_g: Transform,
    tx_d: Transform,
    weights: LossWeights = LossWeights(),
    vgg: Optional[VGG16] = None,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "kernels",
    real_label: float = 1.0,
    remat=False,
    group=None,
    mesh=None,
):
    """Split steps for ImagePool training (misc.py:140-161):
    ``g_step(state, haze, gt) -> (state, metrics, x_hat)`` returns the
    generated batch, which the caller pools; ``d_step(state, fake, gt) ->
    (state, metrics)`` trains D on the (possibly older) fake batch.
    ``group`` and ``mesh`` as :func:`make_train_step`'s: each rank pools its
    own block of the fakes."""
    g_update, d_update = _steps(tx_g, tx_d, weights, vgg, compute_dtype, impl, real_label, remat, group=group,
                                mesh=mesh)

    def g_step(state: TrainState, haze: torch.Tensor, gt: torch.Tensor):
        metrics, x_hat = g_update(state, haze, gt)
        return state, metrics, x_hat

    def d_step(state: TrainState, fake: torch.Tensor, gt: torch.Tensor):
        return state, d_update(state, fake, gt)

    return g_step, d_step


def _stacked(metrics: list) -> Metrics:
    """Per-step metric dicts → each name's (K,) tensor of the chunk, on the
    device."""
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_device_loop(step, chunk_steps: int):
    """A ``make_train_step`` step as a device-resident chunk of
    ``chunk_steps`` steps (JAX ``make_device_loop``, ``loop.py:228``).

    Returns ``run(state, haze_all, gt_all, idx) -> (state, metrics)``:
    ``haze_all`` and ``gt_all`` are the staged dataset, ``(n_batches, b, H,
    W, 3)`` on the device (in bf16 where the step computes in bf16: its cast
    is then the identity), ``idx`` the chunk's ``(chunk_steps,)`` int64 batch
    indices on the device, and ``metrics`` maps each name to its
    ``(chunk_steps,)`` tensor on the device. Step j runs on batch ``idx[j]``,
    read by ``index_select`` with a device index: the chunk reads no value
    on the host. The state is updated in place and returned."""

    def run(state: TrainState, haze_all: torch.Tensor, gt_all: torch.Tensor, idx: torch.Tensor):
        metrics = []
        for j in range(chunk_steps):
            i = idx[j:j + 1]
            state, m = step(state, haze_all.index_select(0, i)[0], gt_all.index_select(0, i)[0])
            metrics.append(m)
        return state, _stacked(metrics)

    return run


def make_device_pool_loop(g_step, d_step, chunk_steps: int):
    """The device-resident chunk with the ImagePool (misc.py:140-161; JAX
    ``make_device_pool_loop``, ``loop.py:263``): ``make_gd_steps``' G step,
    the pool query on the detached fakes (``train/pool.py::
    device_pool_query``, its draws from a ``torch.Generator`` on the
    device), then the D step on the (possibly older) fake batch.

    Returns ``run(state, pool_buf, n_filled, haze_all, gt_all, idx,
    generator) -> (state, pool_buf, n_filled, metrics)``, with
    :func:`make_device_loop`'s arguments; allocate ``pool_buf, n_filled``
    with ``train/pool.py::device_pool_init``. The pool is updated in place."""
    from fdgan_tpu_torch.train.pool import device_pool_query

    def run(state: TrainState, pool_buf: torch.Tensor, n_filled: torch.Tensor, haze_all: torch.Tensor,
            gt_all: torch.Tensor, idx: torch.Tensor, generator: Optional[torch.Generator] = None):
        metrics = []
        for j in range(chunk_steps):
            i = idx[j:j + 1]
            gt = gt_all.index_select(0, i)[0]
            state, g_metrics, x_hat = g_step(state, haze_all.index_select(0, i)[0], gt)
            pool_buf, n_filled, fake = device_pool_query(pool_buf, n_filled, x_hat.detach(), generator)
            state, d_metrics = d_step(state, fake, gt)
            metrics.append({**g_metrics, **d_metrics})
        return state, pool_buf, n_filled, _stacked(metrics)

    return run


def make_device_eval(val_haze, val_gt, device="cuda", impl: str = "kernels"):
    """The val evaluation on the device (JAX ``make_device_eval``,
    ``loop.py:309``): ``evaluate(g) -> (psnr, ssim)``, floats.

    ``val_haze`` and ``val_gt`` are the val set as ``(n, 1, H, W, 3)`` arrays
    in [0, 1] (the val loader's batch-1 layout), staged on ``device`` once,
    in fp32. Each image goes through ``fdgan_fast.apply`` in batch BN, fp32
    with TF32 off (as the host eval, ``cli/train.py::evaluate``); its PSNR is
    10·log10(1/MSE) of clip((x̂ + 1)/2) against gt (PSNRSSIM.py:201-205, the
    MSE accumulated in float64) and its SSIM
    ``ops.ssim.ssim`` of the same. The means over the val set are the only
    values that cross to the host."""
    from fdgan_tpu_torch.cli._common import fp32_exact
    from fdgan_tpu_torch.ops.ssim import ssim

    device = torch.device(device)
    haze = torch.as_tensor(val_haze, dtype=torch.float32).to(device)
    gt = torch.as_tensor(val_gt, dtype=torch.float32).to(device)

    def evaluate(g: FDGAN):
        psnrs, ssims = [], []
        with torch.inference_mode(), fp32_exact("fp32", device):
            for h, y in zip(haze, gt):
                x01 = ((fdgan_fast.apply(g, h, impl=impl).float() + 1.0) * 0.5).clamp(0, 1)
                psnrs.append(10.0 * torch.log10(1.0 / (x01 - y).double().square().mean()))
                ssims.append(ssim(x01, y).double())
            both = torch.stack([torch.stack(psnrs).mean(), torch.stack(ssims).mean()]).cpu()
        return float(both[0]), float(both[1])

    return evaluate
