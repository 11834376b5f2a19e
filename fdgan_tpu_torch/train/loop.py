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

The state is updated in place: a step returns the same ``TrainState``.
Not ported yet (ROADMAP.md): gradient accumulation (``accum_steps``),
rematerialisation, and the device-resident ``lax.scan`` loops.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from fdgan_tpu_torch.losses.composite import CONTEXTUAL_TODO, LossWeights, discriminator_loss, generator_loss
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
    schedule, evaluated at the update count, and the clip (0 = off)."""

    lr: Callable[[int], float]
    clip_grad: float = 0.0

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
        return Transform(sched, clip_grad)

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


def _steps(tx_g, tx_d, weights, vgg, compute_dtype, impl, real_label):
    if weights.contextual > 0:
        raise NotImplementedError(CONTEXTUAL_TODO)

    def g_update(state: TrainState, haze, gt) -> Tuple[Metrics, torch.Tensor]:
        stats: dict = {}
        with _frozen(state.d, vgg):
            x_hat = fdgan_fast.apply(state.g, haze.to(compute_dtype), bn_mode="batch", impl=impl, stats_out=stats)
            _, terms = generator_loss(state.d, x_hat, gt.to(compute_dtype), weights, vgg, impl)
            state.g_opt.zero_grad(set_to_none=True)
            terms["total"].backward()
        tx_g.apply(state.g_opt, state.step)
        fold_stats(state.g, stats)
        state.step += 1
        return {f"g_{k}": v.detach() for k, v in terms.items()}, x_hat.detach()

    def d_update(state: TrainState, fake, gt) -> Metrics:
        loss, terms = discriminator_loss(state.d, fake, gt.to(compute_dtype), real_label, impl)
        state.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        tx_d.apply(state.d_opt, state.d_updates)
        state.d_updates += 1
        return {k: v.detach() for k, v in terms.items()}

    return g_update, d_update


def make_train_step(
    tx_g: Transform,
    tx_d: Transform,
    weights: LossWeights = LossWeights(),
    vgg: Optional[VGG16] = None,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "kernels",
    real_label: float = 1.0,
):
    """``train_step(state, haze, gt) -> (state, metrics)``: a G update, the
    BN fold, then a D update on the pre-update G output. NHWC ``haze`` and
    ``gt`` in [0, 1]; the metrics are detached 0-d tensors (``g_total``,
    ``g_adv``, ``g_pixel``, ``g_ssim``, …, ``d_total``, ``d_real``,
    ``d_fake``)."""
    g_update, d_update = _steps(tx_g, tx_d, weights, vgg, compute_dtype, impl, real_label)

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
):
    """Split steps for ImagePool training (misc.py:140-161):
    ``g_step(state, haze, gt) -> (state, metrics, x_hat)`` returns the
    generated batch, which the caller pools; ``d_step(state, fake, gt) ->
    (state, metrics)`` trains D on the (possibly older) fake batch."""
    g_update, d_update = _steps(tx_g, tx_d, weights, vgg, compute_dtype, impl, real_label)

    def g_step(state: TrainState, haze: torch.Tensor, gt: torch.Tensor):
        metrics, x_hat = g_update(state, haze, gt)
        return state, metrics, x_hat

    def d_step(state: TrainState, fake: torch.Tensor, gt: torch.Tensor):
        return state, d_update(state, fake, gt)

    return g_step, d_step
