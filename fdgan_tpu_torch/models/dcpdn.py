"""The DCPDN models (counterpart of ``fdgan_tpu/models/dcpdn.py``: the
reference's ``models/dehaze22.py`` and ``Dense``/``Dense2`` of
``models/dehaze1113.py``).

- ``UNetG``: the 8-down/8-up skip-concat U-Net with a 4-scale pyramid head
  (dehaze22.py:205-362);
- ``UNetG2``: the small airlight U-Net, nf 8, LeakyReLU output (:364-488);
- ``DenseG``: the transmission generator, DenseNet-121's front with
  ``pool0`` and a bottleneck/transition decoder; ``pyramid=True`` adds the
  4-scale pooling head (dehaze1113.py:431-699, dehaze22.py:531-658);
- ``DehazePhysical``: the atmospheric-scattering composition J = (I − A)/t + A
  with a refinement and pyramid head; it returns (dehaze, tran, atp,
  dehaze2) (dehaze22.py:662-753).

Images are NHWC at the entry points, as ``FDGAN.forward`` takes them; inside,
activations are NCHW in ``torch.channels_last``. The dense blocks of
``DenseG`` run through ``ops.dense.dense_block_fused`` (K1, K2 and
``channel_stats``); the bottlenecks and transitions of its decoder are plain
convolutions, as in JAX. Dead members stay in the state dict and never run:
``DehazePhysical.tran_est`` (dehaze22.py:665), ``DehazePhysical.batch1``
and ``DenseG(pyramid=False).batchnorm1``. ``UNetG``'s last conv keeps the
reference's key ``dlayerfinal.dlayer1.conv`` (dehaze22.py:286-289).

Module names are the JAX tree's paths. The reference's ``.pth`` files double
the segments of its blockUNet layers (``dlayer8.dlayer8.tconv.weight``);
``io/torch_import.py`` maps those keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fdgan_tpu_torch.models import densenet
from fdgan_tpu_torch.models.blocks import BlockUNet, Bottleneck, Transition
from fdgan_tpu_torch.nn.layers import (
    BatchNorm,
    BNCtx,
    Conv2d,
    StatsOut,
    avg_pool,
    dropout,
    finish,
    leaky_relu,
    tanh,
    upsample_nearest_to,
)

PYRAMID = ("conv1010", "conv1020", "conv1030", "conv1040")


def _to_nchw(x: torch.Tensor, multiple: int) -> torch.Tensor:
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected NHWC (B, H, W, 3) images, got shape {tuple(x.shape)}")
    if x.shape[1] % multiple or x.shape[2] % multiple:
        raise ValueError(f"H and W must be divisible by {multiple}, got {tuple(x.shape[1:3])}")
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _to_nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _pool_by_height(x: torch.Tensor) -> torch.Tensor:
    """``avg_pool(x, H)`` of NCHW x, the W // H windows of H×H, as means:
    ``F.avg_pool2d``'s CUDA kernel sums a whole window in one thread, which
    for a 512² map is the slowest op of the forward on the card."""
    b, c, h, w = x.shape
    n = w // h
    return x[..., :n * h].reshape(b, c, h, n, h).mean(dim=(2, 4)).unsqueeze(2)


def _add_pyramid(model: nn.Module, in_c: int, kw: dict) -> None:
    for name in PYRAMID:
        model.add_module(name, Conv2d(in_c, 1, 1, **kw))


def pyramid_head(model: nn.Module, feat: torch.Tensor, pools: Sequence[int]) -> torch.Tensor:
    """4-scale average pool → 1×1 conv → LeakyReLU → nearest upsample back,
    concatenated before ``feat`` (dehaze22.py:344-360)."""
    branches = [upsample_nearest_to(leaky_relu(getattr(model, name)(avg_pool(feat, win)), 0.2), feat.shape[2:])
                for name, win in zip(PYRAMID, pools)]
    return torch.cat(branches + [feat], dim=1)


class _UNetCore(nn.Module):
    """The 8-down encoder and the 7 up layers the two U-Nets share
    (dehaze22.py:209-284): ``layer1`` is a bare 4×4 s2 conv, ``layer2`` …
    ``layer8`` LeakyReLU → conv → BN, ``dlayer8`` … ``dlayer2`` ReLU →
    ConvTranspose2d → BN (none on dlayer8), dropout 0.5 on dlayer8, 7 and 6."""

    def _build_core(self, input_nc: int, nf: int, kw: dict) -> None:
        self.layer1 = Conv2d(input_nc, nf, 4, 2, 1, bias=False, **kw)
        in_c = nf
        for i, out_c in enumerate([nf * 2, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8, nf * 8], start=2):
            self.add_module(f"layer{i}", BlockUNet(in_c, out_c, bn=True, relu_=False, **kw))
            in_c = out_c
        dec_in = [nf * 8, nf * 16, nf * 16, nf * 16, nf * 16, nf * 8, nf * 4]
        dec_out = [nf * 8, nf * 8, nf * 8, nf * 8, nf * 4, nf * 2, nf]
        for i, ic, oc in zip(range(8, 1, -1), dec_in, dec_out):
            self.add_module(f"dlayer{i}", BlockUNet(ic, oc, bn=i != 8, transposed=True, **kw))

    def _core(self, x: torch.Tensor, bn: BNCtx, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        outs = [self.layer1(x)]
        for i in range(2, 9):
            outs.append(getattr(self, f"layer{i}")(outs[-1], bn.sub(f"layer{i}")))
        d = outs[7]
        for i in range(8, 1, -1):
            d = getattr(self, f"dlayer{i}")(d, bn.sub(f"dlayer{i}"))
            if i >= 6:
                d = dropout(d, 0.5, train, generator)
            if i > 2:
                d = torch.cat([d, outs[i - 2]], dim=1)
        return torch.cat([d, outs[0]], dim=1)


class UNetG(_UNetCore):
    """The U-Net generator: NHWC (B, H, W, input_nc) → tanh (B, H, W,
    output_nc); H and W divisible by 256."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, nf: int = 64, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self._build_core(input_nc, nf, kw)
        self.dlayer1 = BlockUNet(nf * 2, 20, transposed=True, **kw)
        _add_pyramid(self, 20, kw)
        # built with the reference's `name` still 'dlayer1' (dehaze22.py:286-289)
        self.dlayerfinal = nn.ModuleDict({"dlayer1": nn.ModuleDict(
            {"conv": Conv2d(24, output_nc, 3, padding=1, bias=False, **kw)})})
        finish(self, device, generator)

    def core(self, x, bn: BNCtx, train: bool = False, generator=None) -> torch.Tensor:
        d1 = self.dlayer1(self._core(x, bn, train, generator))
        return tanh(self.dlayerfinal["dlayer1"]["conv"](pyramid_head(self, d1, (16, 8, 4, 2))))

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels", stats_out: StatsOut = None,
                train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``bn_mode``, ``impl`` and ``stats_out`` as ``FDGAN.forward``'s;
        with ``train`` and a ``generator`` the three dropouts draw their masks."""
        return _to_nhwc(self.core(_to_nchw(x, 256), BNCtx(bn_mode, impl, stats_out), train, generator))


class UNetG2(_UNetCore):
    """The airlight U-Net: NHWC (B, H, W, input_nc) → LeakyReLU (B, H, W,
    output_nc) (its 'tanh' module is a LeakyReLU, dehaze22.py:445); H and W
    divisible by 256."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, nf: int = 8, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self._build_core(input_nc, nf, kw)
        self.dlayer1 = BlockUNet(nf * 2, output_nc, transposed=True, **kw)
        finish(self, device, generator)

    def core(self, x, bn: BNCtx, train: bool = False, generator=None) -> torch.Tensor:
        return leaky_relu(self.dlayer1(self._core(x, bn, train, generator)), 0.2)

    forward = UNetG.forward


class DenseG(nn.Module):
    """The transmission generator: NHWC (B, H, W, 3) → tanh (B, H, W, 3);
    H and W divisible by 32. ``pyramid=False`` is dehaze1113's ``Dense``
    (BN + LeakyReLU after conv_refin, no pyramid head), ``pyramid=True`` its
    ``Dense2``, dehaze22's ``Dense``."""

    def __init__(self, pyramid: bool = True, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.pyramid = pyramid
        self.conv0, self.norm0 = densenet.stem_modules(**kw)
        for i, (c, n) in enumerate([(64, 6), (128, 12), (256, 24)], start=1):
            self.add_module(f"dense_block{i}", densenet.DenseBlock(c, n, **kw))
            cat = c + n * densenet.GROWTH_RATE
            self.add_module(f"trans_block{i}", densenet.Transition(cat, cat // 2, **kw))
        for i, (cin, out, tout) in enumerate([(512, 256, 128), (384, 256, 128), (256, 128, 64), (64, 64, 32),
                                              (32, 32, 16)], start=4):
            self.add_module(f"dense_block{i}", Bottleneck(cin, out, **kw))
            self.add_module(f"trans_block{i}", Transition(cin + out, tout, **kw))
        self.conv_refin = Conv2d(19, 20, 3, padding=1, **kw)
        _add_pyramid(self, 20, kw)
        if pyramid:
            self.refine3 = Conv2d(24, 3, 3, padding=1, **kw)
        else:
            self.refine3 = Conv2d(20, 3, 3, padding=1, **kw)
            self.batchnorm20 = BatchNorm(20, **kw)
            self.batchnorm1 = BatchNorm(1, **kw)  # dead (dehaze1113.py:497)
        finish(self, device, generator)

    def core(self, x: torch.Tensor, bn: BNCtx) -> torch.Tensor:
        h = densenet.stem(self.conv0, self.norm0, x, bn)
        skips = []
        for i in (1, 2, 3):
            h = densenet.dense_block(getattr(self, f"dense_block{i}"), h, bn.sub(f"dense_block{i}"))
            h = densenet.transition(getattr(self, f"trans_block{i}"), h, bn.sub(f"trans_block{i}"))
            skips.append(h)
        for i in range(4, 9):
            if i in (5, 6):  # x4 joins x2, x5 joins x1
                h = torch.cat([h, skips[6 - i]], dim=1)
            h = getattr(self, f"dense_block{i}")(h, bn.sub(f"dense_block{i}"))
            h = getattr(self, f"trans_block{i}")(h, bn.sub(f"trans_block{i}"))
        h = self.conv_refin(torch.cat([h, x], dim=1))
        if self.pyramid:
            return tanh(self.refine3(pyramid_head(self, leaky_relu(h, 0.2), (32, 16, 8, 4))))
        return tanh(self.refine3(leaky_relu(bn(self.batchnorm20, h, "batchnorm20"), 0.2)))

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels",
                stats_out: StatsOut = None) -> torch.Tensor:
        """``bn_mode``, ``impl`` and ``stats_out`` as ``FDGAN.forward``'s."""
        return _to_nhwc(self.core(_to_nchw(x, 32), BNCtx(bn_mode, impl, stats_out)))


class DehazePhysical(nn.Module):
    """The physical dehazing model: NHWC (B, H, W, 3) → (dehaze, tran, atp,
    dehaze2), each NHWC (B, H, W, 3); H and W divisible by 256 (the airlight
    U-Net's depth)."""

    def __init__(self, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        kw = {"device": "meta", "dtype": dtype}
        self.tran_est = UNetG(3, 3, 64, **kw)  # dead (dehaze22.py:665)
        self.atp_est = UNetG2(3, 3, 8, **kw)
        self.tran_dense = DenseG(pyramid=True, **kw)
        self.refine1 = Conv2d(6, 20, 3, padding=1, **kw)
        self.refine2 = Conv2d(20, 20, 3, padding=1, **kw)
        self.refine3 = Conv2d(24, 3, 3, padding=1, **kw)
        self.batch1 = BatchNorm(20, **kw)  # dead (dehaze22.py:687)
        _add_pyramid(self, 20, kw)
        finish(self, device, generator)

    def forward(self, x: torch.Tensor, bn_mode: str = "batch", impl: str = "kernels", stats_out: StatsOut = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """``bn_mode``, ``impl`` and ``stats_out`` as ``FDGAN.forward``'s
        (keys under ``tran_dense.`` and ``atp_est.``); ``train`` and
        ``generator`` drive the airlight U-Net's dropout."""
        x = _to_nchw(x, 256)
        bn = BNCtx(bn_mode, impl, stats_out)
        tran = self.tran_dense.core(x, bn.sub("tran_dense"))
        atp = self.atp_est.core(x, bn.sub("atp_est"), train, generator)
        # the map's global average (windows of H×H), LeakyReLU, broadcast back (dehaze22.py:710-711)
        atp = upsample_nearest_to(leaky_relu(_pool_by_height(atp), 0.2), x.shape[2:])
        dehaze = (x - atp) / (tran.abs() + 1e-10) + atp
        h = leaky_relu(self.refine1(torch.cat([dehaze, x], dim=1)), 0.2)
        h = leaky_relu(self.refine2(h), 0.2)
        out = tanh(self.refine3(pyramid_head(self, h, (32, 16, 8, 4))))
        return tuple(_to_nhwc(t) for t in (out, tran, atp, dehaze))
