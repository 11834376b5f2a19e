"""DehazeFormer — a vision transformer for single-image dehazing, served by
``InferenceEngine`` beside FD-GAN.

Song, He, Qian and Du, "Vision Transformers for Single Image Dehazing",
IEEE TIP 2023, arXiv:2204.03883; the published code is IDKiro/DehazeFormer,
``models/dehazeformer.py``, whose ``dehazeformer_b`` :func:`dehazeformer_b`
builds. The JAX package has no counterpart: this model is the port's own.

A U-shaped stack of five stages of blocks at widths 24, 48, 96, 48, 24
(full, half and quarter resolution, and back), joined by 2×2 stride-2
patch merges, 1×1 convs with pixel shuffles, and SK fusions of the skips.
Every block is x ← x + proj(DW(V(x))), then x ← x + MLP(x), with DW a
reflect-padded depthwise 5×5 conv; in the last ¼, ½ and ¾ of stages 1-3 a
block first normalises x by RLN (each image over its whole C×H×W) and adds
shifted 8×8 window attention with a relative-position bias to DW's output
(``ops/window_attention.py``: the hand-written kernel on the card), its
result rescaled and rebiased by RLN's statistics. The output is
J = K·x − B + x of the 4-channel head's K and B.

The state dict's names and shapes are the published ones (``patch_embed.
proj``, ``layer1.blocks.12.norm1.meta1``, ``…attn.QK``, ``…attn.attn.meta.0``,
``fusion1.mlp.0``); ``relative_positions`` is a non-persistent buffer, so a
published checkpoint loads once that entry is dropped
(:func:`published_state_dict`).

Inside, activations are NHWC (channels last): the 1×1 convs are matmuls over
the channel dimension and the attention kernel reads NHWC. RLN's statistics
and the softmax are fp32; reflect padding is an explicit ``F.pad``. The
forward takes NHWC images in [−1, 1] and returns J (fp32).

``multiple``, ``has_bn``, :meth:`DehazeFormer.input_map` and
:meth:`DehazeFormer.serve_forward` are what ``InferenceEngine`` reads of a
served module's class: RLN sees every pixel of the
image, padded ones included, so the engine pads to the model's own
multiple of 4 and no further.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.init import _calculate_fan_in_and_fan_out, trunc_normal_

from fdgan_tpu_torch import trace
from fdgan_tpu_torch.ops import window_attention as wattn

__all__ = ["DehazeFormer", "dehazeformer_b", "published_state_dict"]

WINDOW = wattn.WINDOW


def relative_positions() -> torch.Tensor:
    """(64, 64, 2) fp32 on the CPU: sign(Δ)·log(1 + |Δ|) of each token
    pair's (Δrow, Δcol) in an 8×8 window, tokens row-major."""
    r = torch.arange(WINDOW)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).flatten(1)  # (2, 64)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).float()
    return torch.sign(rel) * torch.log1p(rel.abs())


def _linear(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1×1 conv on NHWC x: a matmul over the channels."""
    return F.linear(x, conv.weight.view(conv.out_channels, conv.in_channels), conv.bias)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC x reflect-padded by ``pad`` on H and W (``F.pad``'s "reflect",
    the edge not repeated), as one NHWC tensor: x copied into the middle in
    one pass of whole rows, then each border row and column from its mirror
    inside (rows first, so the corners mirror both ways). ``F.pad`` on the
    channels-last view writes NCHW, which the conv would then copy back."""
    b, h, w, c = x.shape
    out = x.new_empty((b, h + 2 * pad, w + 2 * pad, c))
    out[:, pad:pad + h, pad:pad + w] = x
    for i in range(pad):
        out[:, pad - 1 - i] = out[:, pad + 1 + i]
        out[:, pad + h + i] = out[:, pad + h - 2 - i]
    for i in range(pad):
        out[:, :, pad - 1 - i] = out[:, :, pad + 1 + i]
        out[:, :, pad + w + i] = out[:, :, pad + w - 2 - i]
    return out


def _conv_reflect(x: torch.Tensor, conv: nn.Conv2d, pad: int) -> torch.Tensor:
    """``conv`` on NHWC x, reflect-padded by ``pad``: NHWC out (the conv
    runs channels-last, so no layout copy is made on either side)."""
    if pad:
        x = _reflect_pad(x, pad)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=conv.stride, groups=conv.groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``nn.PixelShuffle(r)`` on NHWC x: channel c·r² + i·r + j of pixel
    (h, w) goes to channel c of pixel (h·r + i, w·r + j)."""
    b, h, w, cr = x.shape
    c = cr // (r * r)
    return x.view(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, c)


def _trunc_normal(param: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """The published ``trunc_normal_`` (±2, absolute), drawn in fp32 on the
    CPU from ``generator`` and copied into ``param``."""
    with torch.no_grad():
        param.copy_(trunc_normal_(torch.empty(param.shape), std=std, generator=generator))


def _std(weight: torch.Tensor, gain: float = 1.0) -> float:
    fan_in, fan_out = _calculate_fan_in_and_fan_out(weight)
    return gain * math.sqrt(2.0 / float(fan_in + fan_out))


class RLN(nn.Module):
    """Revised LayerNorm: each image normalised over its whole C×H×W, with
    a rescale and a rebias of its own σ and μ for the block's output."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.eps = eps
        self.weight = nn.Parameter(torch.ones((1, dim, 1, 1), **kw))
        self.bias = nn.Parameter(torch.zeros((1, dim, 1, 1), **kw))
        self.meta1 = nn.Conv2d(1, dim, 1, **kw)
        self.meta2 = nn.Conv2d(1, dim, 1, **kw)

    def forward(self, x: torch.Tensor):
        """(n, rescale, rebias) of NHWC x: n = (x − μ)/σ·γ + β in x's dtype,
        rescale = meta1(σ) and rebias = meta2(μ), (B, 1, 1, C) in fp32; μ and
        σ = √(var + eps) in fp32."""
        c = x.shape[-1]
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(1, 2, 3), correction=0, keepdim=True)
        std = torch.sqrt(var + self.eps)
        scale = self.weight.view(c).float() / std
        shift = self.bias.view(c).float() - mean * scale
        n = torch.addcmul(shift, xf, scale, out=torch.empty_like(x))
        rescale = torch.addcmul(self.meta1.bias.float(), std, self.meta1.weight.view(c).float())
        rebias = torch.addcmul(self.meta2.bias.float(), mean, self.meta2.weight.view(c).float())
        return n, rescale, rebias


class WindowAttention(nn.Module):
    """The relative-position bias of a block's window attention: ``meta``
    (Linear 2→256, ReLU, Linear 256→heads) at each token pair's log-scaled
    offset."""

    def __init__(self, num_heads: int, device=None, dtype=None):
        super().__init__()
        self.register_buffer("relative_positions", relative_positions().to(device), persistent=False)
        self.meta = nn.Sequential(nn.Linear(2, 256, device=device, dtype=dtype), nn.ReLU(True),
                                  nn.Linear(256, num_heads, device=device, dtype=dtype))

    def bias(self) -> torch.Tensor:
        """B_h, (heads, 64, 64) fp32, from ``meta``'s weights in fp32."""
        first, last = self.meta[0], self.meta[2]
        h = torch.relu(F.linear(self.relative_positions.float(), first.weight.float(), first.bias.float()))
        return F.linear(h, last.weight.float(), last.bias.float()).permute(2, 0, 1).contiguous()


class Attention(nn.Module):
    """V, the depthwise 5×5 conv and the projection of every block; QK and
    the window attention of an attending one."""

    def __init__(self, dim: int, num_heads: int, shift_size: int, use_attn: bool, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.num_heads, self.shift_size, self.use_attn = num_heads, shift_size, use_attn
        self.conv = nn.Conv2d(dim, dim, kernel_size=5, groups=dim, **kw)  # reflect-padded by 2 in forward
        self.V = nn.Conv2d(dim, dim, 1, **kw)
        self.proj = nn.Conv2d(dim, dim, 1, **kw)
        if use_attn:
            self.QK = nn.Conv2d(dim, dim * 2, 1, **kw)
            self.attn = WindowAttention(num_heads, **kw)

    def forward(self, x: torch.Tensor, impl: str = "kernels") -> torch.Tensor:
        v = _linear(x, self.V)
        y = _conv_reflect(v, self.conv, 2)
        if self.use_attn:
            fn = wattn.window_attention if impl == "kernels" else wattn.reference
            y = y + fn(_linear(x, self.QK), v, self.attn.bias(), self.num_heads, self.shift_size)
        return _linear(y, self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.mlp = nn.Sequential(nn.Conv2d(dim, hidden, 1, **kw), nn.ReLU(True), nn.Conv2d(hidden, dim, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(torch.relu_(_linear(x, self.mlp[0])), self.mlp[2])


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, shift_size: int, use_attn: bool, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.use_attn = use_attn
        self.norm1 = RLN(dim, **kw) if use_attn else nn.Identity()
        self.attn = Attention(dim, num_heads, shift_size, use_attn, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x: torch.Tensor, impl: str = "kernels") -> torch.Tensor:
        if self.use_attn:
            n, rescale, rebias = self.norm1(x)
            y = self.attn(n, impl)
            x = torch.addcmul(x, y, rescale.to(x.dtype)).add_(rebias.to(x.dtype))
        else:
            x = x + self.attn(x, impl)
        return x + self.mlp(x)


class BasicLayer(nn.Module):
    """A stage: ``depth`` blocks, the last ``attn_ratio`` of them attending,
    the odd ones of those with their windows shifted by 4."""

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: float, attn_ratio: float, device=None,
                 dtype=None):
        super().__init__()
        attn_depth = attn_ratio * depth
        self.blocks = nn.ModuleList([
            TransformerBlock(dim, num_heads, mlp_ratio, 0 if i % 2 == 0 else WINDOW // 2, i >= depth - attn_depth,
                             device=device, dtype=dtype)
            for i in range(depth)])

    def forward(self, x: torch.Tensor, impl: str = "kernels") -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, impl)
        return x


class _Proj(nn.Module):
    """A module holding ``proj``: the published PatchEmbed's name."""

    def __init__(self, proj: nn.Module):
        super().__init__()
        self.proj = proj


class SKFusion(nn.Module):
    """Selective-kernel fusion of two maps: per-channel weights over the pair
    from the pooled sum's bottleneck MLP (bias-free 1×1 convs)."""

    def __init__(self, dim: int, height: int = 2, reduction: int = 8, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.height = height
        d = max(int(dim / reduction), 4)
        self.mlp = nn.Sequential(nn.Conv2d(dim, d, 1, bias=False, **kw), nn.ReLU(),
                                 nn.Conv2d(d, dim * height, 1, bias=False, **kw))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """w_a·a + w_b·b of NHWC a and b, with w = softmax over the pair of
        MLP(avgpool(a + b)), computed in fp32."""
        c = a.shape[-1]
        pooled = torch.mean(a + b, dim=(1, 2), dtype=torch.float32)  # (B, C)
        first, last = self.mlp[0], self.mlp[2]
        h = torch.relu(pooled @ first.weight.view(first.out_channels, c).float().t())
        w = torch.softmax((h @ last.weight.view(last.out_channels, -1).float().t()).view(-1, self.height, 1, 1, c),
                          dim=1).to(a.dtype)
        return torch.addcmul(a * w[:, 0], b, w[:, 1])


class DehazeFormer(nn.Module):
    """The model: ``forward`` takes NHWC (B, H, W, 3) images in [−1, 1] and
    returns J, NHWC (B, H, W, 3) fp32; a side that is not a multiple of 4
    is reflect-padded for the forward and cropped back.

    The parameters follow the published ``_init_weights`` (``init_weights``,
    from ``generator``; seed 0 when omitted); on the meta device none are
    drawn."""

    multiple = 4    # the engine's bucket: two 2× merges, and RLN sees every padded pixel
    has_bn = False  # the engine's ``bn_mode`` does not apply

    def __init__(self, dims: Sequence[int] = (24, 48, 96, 48, 24), depths: Sequence[int] = (16, 16, 16, 8, 8),
                 heads: Sequence[int] = (2, 4, 6, 1, 1), mlp_ratios: Sequence[float] = (2.0, 4.0, 4.0, 2.0, 2.0),
                 attn_ratios: Sequence[float] = (1 / 4, 1 / 2, 3 / 4, 0.0, 0.0), device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dims[1] != dims[3] or dims[0] != dims[4]:
            raise ValueError(f"the skips need dims[1] == dims[3] and dims[0] == dims[4], got {tuple(dims)}")
        kw = {"device": device, "dtype": dtype}
        self.network_depth = sum(depths)
        layer = [BasicLayer(dims[i], depths[i], heads[i], mlp_ratios[i], attn_ratios[i], **kw) for i in range(5)]
        self.patch_embed = _Proj(nn.Conv2d(3, dims[0], 3, **kw))
        self.layer1 = layer[0]
        self.patch_merge1 = _Proj(nn.Conv2d(dims[0], dims[1], 2, stride=2, **kw))
        self.skip1 = nn.Conv2d(dims[0], dims[0], 1, **kw)
        self.layer2 = layer[1]
        self.patch_merge2 = _Proj(nn.Conv2d(dims[1], dims[2], 2, stride=2, **kw))
        self.skip2 = nn.Conv2d(dims[1], dims[1], 1, **kw)
        self.layer3 = layer[2]
        self.patch_split1 = _Proj(nn.Sequential(nn.Conv2d(dims[2], dims[3] * 4, 1, **kw), nn.PixelShuffle(2)))
        self.fusion1 = SKFusion(dims[3], **kw)
        self.layer4 = layer[3]
        self.patch_split2 = _Proj(nn.Sequential(nn.Conv2d(dims[3], dims[4] * 4, 1, **kw), nn.PixelShuffle(2)))
        self.fusion2 = SKFusion(dims[4], **kw)
        self.layer5 = layer[4]
        self.patch_unembed = _Proj(nn.Sequential(nn.Conv2d(dims[4], 4, 3, **kw), nn.PixelShuffle(1)))
        if torch.device(device or "cpu").type != "meta":
            self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """The published initialisation: the blocks' convs truncated normal
        at g·√(2/(fan_in + fan_out)) with g = (8·depth)^−¼ (QK without g),
        their biases 0; RLN's γ 1, β 0, meta1 and meta2 N(0, 0.02²) with
        biases 1 and 0; every other conv and linear PyTorch's default,
        U(±1/√fan_in) for weight and bias."""
        gain = (8 * self.network_depth) ** (-1 / 4)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    bound = 1.0 / math.sqrt(_calculate_fan_in_and_fan_out(m.weight)[0])
                    for p in (m.weight, m.bias):
                        if p is not None:
                            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
            for m in self.modules():
                if not isinstance(m, TransformerBlock):
                    continue
                scaled = [m.attn.conv, m.attn.V, m.attn.proj, m.mlp.mlp[0], m.mlp.mlp[2]]
                for conv, g in [(c, gain) for c in scaled] + ([(m.attn.QK, 1.0)] if m.use_attn else []):
                    _trunc_normal(conv.weight, _std(conv.weight, g), generator)
                    conv.bias.zero_()
                if m.use_attn:
                    rln = m.norm1
                    rln.weight.fill_(1.0)
                    rln.bias.zero_()
                    _trunc_normal(rln.meta1.weight, 0.02, generator)
                    rln.meta1.bias.fill_(1.0)
                    _trunc_normal(rln.meta2.weight, 0.02, generator)
                    rln.meta2.bias.zero_()

    def input_map(self, x: torch.Tensor) -> torch.Tensor:
        """A staged batch as the model takes it: uint8 [0, 255] or float
        [0, 1] to [−1, 1], in fp32 on x's device."""
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        return x * 2.0 - 1.0

    def serve_forward(self, x: torch.Tensor, bn_mode: str) -> torch.Tensor:
        """The engine's forward (``bn_mode`` does not apply): J clamped to
        [−1, 1], as the published test serves it."""
        return self(x).clamp_(-1.0, 1.0)

    def forward(self, x: torch.Tensor, impl: str = "kernels") -> torch.Tensor:
        """J of NHWC ``x`` in [−1, 1]. ``impl`` 'plain' runs the window
        attention's plain version on any device."""
        if impl not in ("kernels", "plain"):
            raise ValueError(f"impl must be 'kernels' or 'plain', got {impl!r}")
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected NHWC (B, H, W, 3) images, got shape {tuple(x.shape)}")
        b, h, w, _ = x.shape
        with trace.span("dehazeformer.forward", batch=b, h=h, w=w):
            ph, pw = -h % self.multiple, -w % self.multiple
            if ph or pw:
                x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
            x = x.contiguous()
            y = _conv_reflect(x, self.patch_embed.proj, 1)
            y = self.layer1(y, impl)
            skip1 = y
            y = self.layer2(_conv_reflect(y, self.patch_merge1.proj, 0), impl)
            skip2 = y
            y = self.layer3(_conv_reflect(y, self.patch_merge2.proj, 0), impl)
            y = _pixel_shuffle(_linear(y, self.patch_split1.proj[0]), 2)
            y = self.fusion1(y, _linear(skip2, self.skip2)) + y
            y = self.layer4(y, impl)
            y = _pixel_shuffle(_linear(y, self.patch_split2.proj[0]), 2)
            y = self.fusion2(y, _linear(skip1, self.skip1)) + y
            y = self.layer5(y, impl)
            feat = _conv_reflect(y, self.patch_unembed.proj[0], 1).float()
            xf = x.float()
            j = torch.addcmul(xf - feat[..., 1:], feat[..., :1], xf)
            return j[:, :h, :w]


def dehazeformer_b(device=None, dtype=torch.float32, generator: Optional[torch.Generator] = None) -> DehazeFormer:
    """DehazeFormer-B: dims 24, 48, 96, 48, 24; depths 16, 16, 16, 8, 8;
    heads 2, 4, 6, 1, 1; MLP ratios 2, 4, 4, 2, 2; attention in the last ¼,
    ½, ¾ of stages 1-3."""
    return DehazeFormer(device=device, dtype=dtype, generator=generator)


def published_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """A published checkpoint's state dict as the port loads it: a
    ``state_dict`` or ``model`` wrapper and DataParallel's ``module.``
    prefixes unwrapped, the ``relative_positions`` buffers dropped."""
    for key in ("state_dict", "model"):
        if key in state and isinstance(state[key], Mapping):
            state = state[key]
    out = {}
    for k, v in state.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.endswith("relative_positions"):
            out[k] = v
    return out
