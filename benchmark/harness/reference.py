"""The plain reference of the benchmark: FD-GAN's generator, its fusion
discriminator, its training losses and step, and DCPDN's DehazePhysical.

Plain PyTorch over a dict of tensors named as the published checkpoints name
them (``dense_block1.denselayer1.norm1.weight``, ``model.3.running_var``,
``tran_dense.conv0.weight``). It follows the published layer equations:
FD-GAN (Dong et al., AAAI 2020, arXiv:2001.06968; the reference repository's
``models/dehaze1113.py``) and DCPDN (Zhang & Patel, CVPR 2018,
arXiv:1803.08396; ``models/dehaze22.py``). Nothing here imports the program
under test: it is held against it. A model family's file
(``benchmark/models/<model>.py``) names its served output here, or brings
its own built on :class:`Net`.

Activations are NCHW float32 inside; the entry points take and return NHWC
images. Every convolution goes through :class:`Net` with an operand
quantiser ``q``: the identity for the reference, :func:`fp8` for the control
that computes the same model in the next precision below the configuration's
bf16 (e4m3 operands forward, e5m2 gradients backward). Callers run the reference with TF32 off (:func:`exact`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Stats = Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]
EPS = 1e-5


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _round(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to an fp8 format under a per-tensor scale that takes
    its absolute maximum to the format's largest value."""
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """An fp8 matmul's operand: e4m3 forward; the gradient that reaches it
    rounded to e5m2, as fp8 training carries gradients."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class _Fp8Output(torch.autograd.Function):
    """An fp8 matmul's output: as it is forward; its incoming gradient, the
    backward matmuls' operand, rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """A convolution operand computed in fp8: e4m3 under a per-tensor scale
    forward, its gradient in e5m2 backward."""
    return _Fp8Operand.apply(t)


fp8.out = _Fp8Output.apply


def bf16(t: torch.Tensor) -> torch.Tensor:
    """A convolution operand rounded to bf16, the configuration's precision:
    the yardstick of the rounding a sound bf16 program shows."""
    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def exact():
    """float32 convolutions and matmuls without TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Net:
    """The parameters, the BN mode, the operand quantiser and an optional
    collector of batch statistics, threaded through the layers."""

    def __init__(self, p: Params, bn_mode: str = "running", q: Callable = identity, stats: Stats = None):
        if bn_mode not in ("batch", "running"):
            raise ValueError(f"bn_mode must be 'batch' or 'running', got {bn_mode!r}")
        self.p, self.bn_mode, self.q, self.stats = p, bn_mode, q, stats
        self.out = getattr(q, "out", identity)

    def conv(self, x, name, stride=1, padding=0, bias=True):
        b = self.p.get(f"{name}.bias") if bias else None
        return self.out(F.conv2d(self.q(x), self.q(self.p[f"{name}.weight"]), b, stride=stride, padding=padding))

    def tconv(self, x, name, stride=1, padding=0):
        return self.out(F.conv_transpose2d(self.q(x), self.q(self.p[f"{name}.weight"]), self.p.get(f"{name}.bias"),
                                           stride=stride, padding=padding))

    def bn(self, x, name):
        """BatchNorm over N, H, W: the batch's statistics (biased variance)
        or the stored ones; the batch's (mean, unbiased variance) recorded
        under ``name`` where a collector is given."""
        if self.bn_mode == "batch":
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            if self.stats is not None:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                self.stats[name] = (mean.detach(), var.detach() * n / max(n - 1, 1))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        inv = self.p[f"{name}.weight"] * torch.rsqrt(var + EPS)
        return (x - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) + self.p[f"{name}.bias"].view(1, -1, 1, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def up_nearest_to(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest upsample to an exact size, output row i from input row
    floor(i·h / H)."""
    h, w = x.shape[2:]
    rows = torch.arange(size[0], device=x.device) * h // size[0]
    cols = torch.arange(size[1], device=x.device) * w // size[1]
    return x[:, :, rows][:, :, :, cols]


# --- DenseNet-121 pieces ---------------------------------------------------------

def dense_block(net: Net, x: torch.Tensor, name: str, layers: int) -> torch.Tensor:
    """Each layer: norm1, relu, 1×1 conv to 128, norm2, relu, 3×3 conv to
    32; its output concatenated to its input."""
    for i in range(1, layers + 1):
        pre = f"{name}.denselayer{i}"
        h = net.conv(torch.relu(net.bn(x, f"{pre}.norm1")), f"{pre}.conv1", bias=False)
        h = net.conv(torch.relu(net.bn(h, f"{pre}.norm2")), f"{pre}.conv2", padding=1, bias=False)
        x = torch.cat([x, h], dim=1)
    return x


def dense_transition(net: Net, x: torch.Tensor, name: str) -> torch.Tensor:
    """norm, relu, 1×1 conv, 2×2 average pool."""
    return F.avg_pool2d(net.conv(torch.relu(net.bn(x, f"{name}.norm")), f"{name}.conv", bias=False), 2)


# --- FD-GAN's generator ----------------------------------------------------------

FDGAN_BLOCKS = ((1, 6), (2, 12), (3, 24))


def _bottleneck_dy(net: Net, x, name):
    """x → cat[x, conv2(relu(conv1(relu(x))))] (its BNs are never called)."""
    h = net.conv(torch.relu(net.conv(torch.relu(x), f"{name}.conv1", bias=False)), f"{name}.conv2", padding=1,
                 bias=False)
    return torch.cat([x, h], dim=1)


def _transition_dy(net: Net, x, name):
    """relu, 1×1 transposed conv, ×2 nearest upsample."""
    return F.interpolate(net.tconv(torch.relu(x), f"{name}.conv1"), scale_factor=2, mode="nearest")


def fdgan_generator(p: Params, x: torch.Tensor, bn_mode: str = "running", q: Callable = identity,
                    stats: Stats = None) -> torch.Tensor:
    """FD-GAN's generator: NHWC (B, H, W, 3) in [0, 1], H and W divisible by
    8 → NHWC tanh output in [−1, 1]. In batch mode ``stats`` collects every
    called BN's (mean, unbiased variance)."""
    net = Net(p, bn_mode, q, stats)
    x = _nchw(x)
    x0 = torch.relu(net.conv(x, "conv_refin1", padding=1))
    x01 = net.conv(F.avg_pool2d(x0, 2), "conv_refin2")
    x1 = dense_transition(net, dense_block(net, x0, "dense_block1", 6), "trans_block1")
    x10 = net.conv(torch.cat([x01, x1], dim=1), "conv_refine4", padding=1)
    x2 = dense_transition(net, dense_block(net, x10, "dense_block2", 12), "trans_block2")
    x3 = dense_transition(net, dense_block(net, x2, "dense_block3", 24), "trans_block3")
    x22 = net.conv(F.avg_pool2d(x2, 2), "conv_refin5")
    x4 = net.conv(torch.cat([x3, x22], dim=1), "conv_refin6", padding=1)
    x4 = _transition_dy(net, _bottleneck_dy(net, x4, "dense_block4"), "trans_block4")
    x5 = _transition_dy(net, _bottleneck_dy(net, torch.cat([x4, x2], dim=1), "dense_block5"), "trans_block5")
    x6 = _transition_dy(net, _bottleneck_dy(net, x5, "dense_block6"), "trans_block6")
    return _nhwc(torch.tanh(net.conv(x6, "conv_refin3", padding=1)))


# --- the fusion discriminator ---------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _gauss(n: int, sigma: float) -> torch.Tensor:
    ax = torch.arange(n, dtype=torch.float64) - (n // 2)
    g = torch.exp(-(ax**2) / (2 * sigma**2))
    return (g / g.sum()).float()


def frequency_fuse(x: torch.Tensor) -> torch.Tensor:
    """concat[RGB, LF, HF] of NCHW x: LF the ImageNet-normalised image,
    reflect-padded by 7, under the normalised 15×15 σ=3 Gaussian; HF the raw
    image, zero-padded by 1, under the 3×3 Laplacian (ones, centre −8)."""
    c = x.shape[1]
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    g = _gauss(15, 3.0).to(x.device)
    k = torch.outer(g, g).expand(c, 1, 15, 15)
    lf = F.conv2d(F.pad((x - mean) / std, (7, 7, 7, 7), mode="reflect"), k, groups=c)
    lap = torch.ones(3, 3, device=x.device)
    lap[1, 1] = -8.0
    hf = F.conv2d(x, lap.expand(c, 1, 3, 3), padding=1, groups=c)
    return torch.cat([x, lf, hf], dim=1)


def discriminator(p: Params, x: torch.Tensor, q: Callable = identity) -> torch.Tensor:
    """The PatchGAN over the 9-channel fusion of NCHW x in [0, 1]: 4×4 convs
    (stride 2, 2, 2, 1, 1), batch-statistics BN on the middle three,
    LeakyReLU 0.2, a sigmoid head; (B, 1, H/8 − 2, W/8 − 2)."""
    net = Net(p, "batch", q)
    h = F.leaky_relu(net.conv(frequency_fuse(x), "model.0", stride=2, padding=1), 0.2)
    for conv, bn, stride in (("model.2", "model.3", 2), ("model.5", "model.6", 2), ("model.8", "model.9", 1)):
        h = F.leaky_relu(net.bn(net.conv(h, conv, stride=stride, padding=1, bias=False), bn), 0.2)
    return torch.sigmoid(net.conv(h, "model.11", stride=1, padding=1))


# --- the losses and the training step -------------------------------------------------

def bce(pred: torch.Tensor, target: float) -> torch.Tensor:
    pr = pred.clamp(1e-7, 1.0 - 1e-7)
    return -(target * torch.log(pr) + (1.0 - target) * torch.log(1.0 - pr)).mean()


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of NCHW a and b: 11-tap σ=1.5 Gaussian window, zero
    padding 5, C1 = 0.01², C2 = 0.03²."""
    c = a.shape[1]
    g = _gauss(11, 1.5).to(a.device)
    w = torch.outer(g, g).expand(c, 1, 11, 11)

    def filt(t):
        return F.conv2d(t, w, padding=5, groups=c)

    mu1, mu2 = filt(a), filt(b)
    s11, s22, s12 = filt(a * a) - mu1 * mu1, filt(b * b) - mu2 * mu2, filt(a * b) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def generator_loss(pd: Params, x_hat: torch.Tensor, gt: torch.Tensor, weights, q: Callable = identity):
    """adv·BCE(D(x̂), 1) + pixel·L1 + ssim·(1 − SSIM) over the [0, 1] views
    (NHWC x̂ in [−1, 1], gt in [0, 1])."""
    x01, y = _nchw((x_hat + 1.0) * 0.5), _nchw(gt)
    return (weights["adv"] * bce(discriminator(pd, x01, q), 1.0)
            + weights["pixel"] * (x01 - y).abs().mean()
            + weights["ssim"] * (1.0 - ssim(x01, y)))


def discriminator_loss(pd: Params, x_hat: torch.Tensor, gt: torch.Tensor, q: Callable = identity):
    """BCE(D(gt), 1) + BCE(D(x̂), 0), real and fake in separate forwards."""
    return bce(discriminator(pd, _nchw(gt), q), 1.0) + bce(discriminator(pd, _nchw((x_hat + 1.0) * 0.5), q), 0.0)


class Adam:
    """Adam over a dict of leaves (β1, β2, ε as given, no weight decay)."""

    def __init__(self, params: Params, lr: float, betas=(0.5, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(g: Params, d: Params, batches, cfg: dict, q: Callable = identity):
    """The FD-GAN training steps over ``batches`` [(haze, gt), ...] (NHWC in
    [0, 1]), from the parameters ``g`` and ``d`` (updated in place). Each
    step: G forward with batch statistics, G's loss and gradient, G's Adam
    update, the statistics folded into G's running ones (momentum), then
    D's loss on the step's detached G output, D's gradient and Adam update.
    Returns per step its G and D losses, and the gradients each Adam got
    at the first step."""
    lr, betas = cfg["lr"], tuple(cfg["betas"])
    gk = [k for k in g if not k.endswith(("running_mean", "running_var"))]
    dk = [k for k in d if not k.endswith(("running_mean", "running_var"))]
    g_adam, d_adam = Adam({k: g[k] for k in gk}, lr, betas), Adam({k: d[k] for k in dk}, lr, betas)
    losses, first = [], {}
    for haze, gt in batches:
        gl = {k: g[k].detach().requires_grad_(True) for k in gk}
        stats: dict = {}
        x_hat = fdgan_generator({**g, **gl}, haze, "batch", q, stats)
        dfrozen = {k: v.detach() for k, v in d.items()}
        loss_g = generator_loss(dfrozen, x_hat, gt, cfg["loss_weights"], q)
        grads = dict(zip(gk, torch.autograd.grad(loss_g, [gl[k] for k in gk], allow_unused=True)))
        grads = {k: v for k, v in grads.items() if v is not None}
        g_adam.step(g, grads)
        with torch.no_grad():
            m = cfg["bn_momentum"]
            for key, (mean, var) in stats.items():
                g[f"{key}.running_mean"].mul_(1 - m).add_(mean, alpha=m)
                g[f"{key}.running_var"].mul_(1 - m).add_(var, alpha=m)
        dl = {k: d[k].detach().requires_grad_(True) for k in dk}
        loss_d = discriminator_loss({**d, **dl}, x_hat.detach(), gt, q)
        dgrads = dict(zip(dk, torch.autograd.grad(loss_d, [dl[k] for k in dk])))
        d_adam.step(d, dgrads)
        if not first:
            first = {"g": {k: v.detach() for k, v in grads.items()}, "d": {k: v.detach() for k, v in dgrads.items()}}
        losses.append((float(loss_g.detach()), float(loss_d.detach())))
    return losses, first


# --- DCPDN ------------------------------------------------------------------------------

def _block_unet(net: Net, x, name, relu_: bool, transposed: bool, bn: bool):
    """Pre-activation (ReLU or LeakyReLU 0.2), a 4×4 stride-2 conv (or
    transposed conv) with padding 1 and no bias, an optional BN."""
    h = torch.relu(x) if relu_ else F.leaky_relu(x, 0.2)
    h = net.tconv(h, f"{name}.tconv", 2, 1) if transposed else net.conv(h, f"{name}.conv", 2, 1, bias=False)
    return net.bn(h, f"{name}.bn") if bn else h


def _unet_core(net: Net, x, name):
    """The 8-down, 7-up skip-concatenating U-Net body; dropout is off."""
    outs = [net.conv(x, f"{name}.layer1", 2, 1, bias=False)]
    for i in range(2, 9):
        outs.append(_block_unet(net, outs[-1], f"{name}.layer{i}", False, False, True))
    d = outs[7]
    for i in range(8, 1, -1):
        d = _block_unet(net, d, f"{name}.dlayer{i}", True, True, i != 8)
        if i > 2:
            d = torch.cat([d, outs[i - 2]], dim=1)
    return torch.cat([d, outs[0]], dim=1)


def _pyramid(net: Net, feat, name, pools):
    """Four average pools, a 1×1 conv to one channel each, LeakyReLU 0.2,
    nearest upsample back; concatenated before ``feat``."""
    pre = f"{name}." if name else ""
    br = [up_nearest_to(F.leaky_relu(net.conv(F.avg_pool2d(feat, w), f"{pre}{c}"), 0.2), feat.shape[2:])
          for c, w in zip(("conv1010", "conv1020", "conv1030", "conv1040"), pools)]
    return torch.cat(br + [feat], dim=1)


def _dense_g(net: Net, x, name):
    """The transmission generator: DenseNet-121's stem and three blocks, a
    bottleneck/transition decoder with two skips, a pyramid head, tanh."""
    h = net.conv(x, f"{name}.conv0", 2, 3, bias=False)
    h = F.max_pool2d(torch.relu(net.bn(h, f"{name}.norm0")), 3, 2, 1)
    skips = []
    for i, n in FDGAN_BLOCKS:
        h = dense_transition(net, dense_block(net, h, f"{name}.dense_block{i}", n), f"{name}.trans_block{i}")
        skips.append(h)
    for i in range(4, 9):
        if i in (5, 6):
            h = torch.cat([h, skips[6 - i]], dim=1)
        b = f"{name}.dense_block{i}"
        o = net.conv(torch.relu(net.bn(h, f"{b}.bn1")), f"{b}.conv1", bias=False)
        o = net.conv(torch.relu(net.bn(o, f"{b}.bn2")), f"{b}.conv2", padding=1, bias=False)
        h = torch.cat([h, o], dim=1)
        t = f"{name}.trans_block{i}"
        h = F.interpolate(net.tconv(torch.relu(net.bn(h, f"{t}.bn1")), f"{t}.conv1"), scale_factor=2, mode="nearest")
    h = net.conv(torch.cat([h, x], dim=1), f"{name}.conv_refin", padding=1)
    return torch.tanh(net.conv(_pyramid(net, F.leaky_relu(h, 0.2), name, (32, 16, 8, 4)), f"{name}.refine3",
                               padding=1))


def dehaze_physical(p: Params, x: torch.Tensor, bn_mode: str = "running", q: Callable = identity):
    """DCPDN's DehazePhysical over NHWC x (H, W divisible by 256): the
    transmission t (DenseG), the airlight A (the small U-Net, its map's
    global average), J = (I − A)/(|t| + 1e−10) + A, a refinement with a
    pyramid head. Returns the dehazed image, NHWC tanh in [−1, 1]."""
    net = Net(p, bn_mode, q)
    x = _nchw(x)
    tran = _dense_g(net, x, "tran_dense")
    atp = F.leaky_relu(net.tconv(torch.relu(_unet_core(net, x, "atp_est")), "atp_est.dlayer1.tconv", 2, 1), 0.2)
    b, c, h, w = atp.shape
    n = w // h
    atp = atp[..., :n * h].reshape(b, c, h, n, h).mean(dim=(2, 4)).unsqueeze(2)
    atp = up_nearest_to(F.leaky_relu(atp, 0.2), x.shape[2:])
    j = (x - atp) / (tran.abs() + 1e-10) + atp
    r = F.leaky_relu(net.conv(torch.cat([j, x], dim=1), "refine1", padding=1), 0.2)
    r = F.leaky_relu(net.conv(r, "refine2", padding=1), 0.2)
    return _nhwc(torch.tanh(net.conv(_pyramid(net, r, "", (32, 16, 8, 4)), "refine3", padding=1)))


def padded(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """NHWC x reflect-padded at the bottom and right to H, W multiples of
    ``multiple`` (edge-padded where a side is too short to reflect)."""
    h, w = x.shape[1:3]
    ph, pw = -h % multiple, -w % multiple
    if not (ph or pw):
        return x
    mode = "reflect" if ph < h and pw < w else "replicate"
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode).permute(0, 2, 3, 1)


def to_levels(y: torch.Tensor) -> torch.Tensor:
    """A tanh output in [−1, 1] as unrounded uint8 levels (y + 1)·127.5."""
    return (y.float() + 1.0) * 127.5
