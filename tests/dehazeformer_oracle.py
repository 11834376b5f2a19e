"""Plain reference of DehazeFormer for the port's tests: an ``nn.Module``
mirror of the published code (IDKiro/DehazeFormer, ``models/dehazeformer.py``;
Song, He, Qian and Du, "Vision Transformers for Single Image Dehazing",
IEEE TIP 2023, arXiv:2204.03883), NCHW, float32. It imports nothing of the
port and nothing of JAX.

Departures from the published code, none of which changes a value:

- ``trunc_normal_`` and ``_calculate_fan_in_and_fan_out`` come from
  ``torch.nn.init`` (the published file takes the first from ``timm``);
  ``to_2tuple`` and the unused ``Conv`` branch of ``Attention`` are gone;
- the constructors take ``depths``, ``embed_dims`` and the rest as
  ``dehazeformer_b``'s defaults, so that the tests can build smaller
  depths at the published widths;
- ``BasicLayer``'s ``attn_loc`` is fixed at ``'last'`` and ``conv_type`` at
  ``'DWConv'``, the settings every published variant uses;
- ``window_partition``, the shift's reflect padding and the crop are also
  exposed on their own (:func:`partition_attention`), for the tests of the
  port's ``window_attention``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.init import _calculate_fan_in_and_fan_out, trunc_normal_


class RLN(nn.Module):
    """Revised LayerNorm."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones((1, dim, 1, 1)))
        self.bias = nn.Parameter(torch.zeros((1, dim, 1, 1)))
        self.meta1 = nn.Conv2d(1, dim, 1)
        self.meta2 = nn.Conv2d(1, dim, 1)
        trunc_normal_(self.meta1.weight, std=.02)
        nn.init.constant_(self.meta1.bias, 1)
        trunc_normal_(self.meta2.weight, std=.02)
        nn.init.constant_(self.meta2.bias, 0)

    def forward(self, input):
        mean = torch.mean(input, dim=(1, 2, 3), keepdim=True)
        std = torch.sqrt((input - mean).pow(2).mean(dim=(1, 2, 3), keepdim=True) + self.eps)
        normalized_input = (input - mean) / std
        rescale, rebias = self.meta1(std), self.meta2(mean)
        out = normalized_input * self.weight + self.bias
        return out, rescale, rebias


class Mlp(nn.Module):
    def __init__(self, network_depth, in_features, hidden_features=None, out_features=None):
        super().__init__()
        out_features = out_features or in_features
        hidden_features = hidden_features or in_features
        self.network_depth = network_depth
        self.mlp = nn.Sequential(
            nn.Conv2d(in_features, hidden_features, 1),
            nn.ReLU(True),
            nn.Conv2d(hidden_features, out_features, 1),
        )
        self.apply(self._init_weights)

    def _init_weights(self, m):
        if isinstance(m, nn.Conv2d):
            gain = (8 * self.network_depth) ** (-1 / 4)
            fan_in, fan_out = _calculate_fan_in_and_fan_out(m.weight)
            std = gain * math.sqrt(2.0 / float(fan_in + fan_out))
            trunc_normal_(m.weight, std=std)
            if m.bias is not None:
                nn.init.constant_(m.bias, 0)

    def forward(self, x):
        return self.mlp(x)


def window_partition(x, window_size):
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size**2, C)
    return windows


def window_reverse(windows, window_size, H, W):
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)
    return x


def get_relative_positions(window_size):
    coords_h = torch.arange(window_size)
    coords_w = torch.arange(window_size)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_positions = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_positions = relative_positions.permute(1, 2, 0).contiguous()
    relative_positions_log = torch.sign(relative_positions) * torch.log(1. + relative_positions.abs())
    return relative_positions_log


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        relative_positions = get_relative_positions(self.window_size)
        self.register_buffer("relative_positions", relative_positions)
        self.meta = nn.Sequential(
            nn.Linear(2, 256, bias=True),
            nn.ReLU(True),
            nn.Linear(256, num_heads, bias=True),
        )
        self.softmax = nn.Softmax(dim=-1)

    def bias(self):
        """The relative position bias B_h, (heads, 64, 64)."""
        return self.meta(self.relative_positions).permute(2, 0, 1).contiguous()

    def forward(self, qkv):
        B_, N, _ = qkv.shape
        qkv = qkv.reshape(B_, N, 3, self.num_heads, self.dim // self.num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = (q @ k.transpose(-2, -1))
        attn = attn + self.bias().unsqueeze(0)
        attn = self.softmax(attn)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, self.dim)
        return x


def check_size(x, window_size, shift_size, shift):
    _, _, h, w = x.size()
    mod_pad_h = (window_size - h % window_size) % window_size
    mod_pad_w = (window_size - w % window_size) % window_size
    if shift:
        x = F.pad(x, (shift_size, (window_size - shift_size + mod_pad_w) % window_size,
                      shift_size, (window_size - shift_size + mod_pad_h) % window_size), mode="reflect")
    else:
        x = F.pad(x, (0, mod_pad_w, 0, mod_pad_h), "reflect")
    return x


def partition_attention(wattn: WindowAttention, QKV: torch.Tensor, shift_size: int) -> torch.Tensor:
    """Attention.forward's attention half on NCHW [QK, V]: the shift's reflect
    padding, the window partition, the windows' attention, the merge and the
    crop; NCHW (B, C, H, W) out."""
    window_size = wattn.window_size
    H, W = QKV.shape[2:]
    shifted_QKV = check_size(QKV, window_size, shift_size, shift_size > 0)
    Ht, Wt = shifted_QKV.shape[2:]
    shifted_QKV = shifted_QKV.permute(0, 2, 3, 1)
    qkv = window_partition(shifted_QKV, window_size)
    attn_windows = wattn(qkv)
    shifted_out = window_reverse(attn_windows, window_size, Ht, Wt)
    out = shifted_out[:, shift_size:(shift_size + H), shift_size:(shift_size + W), :]
    return out.permute(0, 3, 1, 2)


class Attention(nn.Module):
    def __init__(self, network_depth, dim, num_heads, window_size, shift_size, use_attn=False, conv_type=None):
        super().__init__()
        self.dim = dim
        self.head_dim = int(dim // num_heads)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.network_depth = network_depth
        self.use_attn = use_attn
        self.conv_type = conv_type
        if self.conv_type == "DWConv":
            self.conv = nn.Conv2d(dim, dim, kernel_size=5, padding=2, groups=dim, padding_mode="reflect")
        if self.conv_type == "DWConv" or self.use_attn:
            self.V = nn.Conv2d(dim, dim, 1)
            self.proj = nn.Conv2d(dim, dim, 1)
        if self.use_attn:
            self.QK = nn.Conv2d(dim, dim * 2, 1)
            self.attn = WindowAttention(dim, window_size, num_heads)
        self.apply(self._init_weights)

    def _init_weights(self, m):
        if isinstance(m, nn.Conv2d):
            w_shape = m.weight.shape
            fan_in, fan_out = _calculate_fan_in_and_fan_out(m.weight)
            if w_shape[0] == self.dim * 2:  # QK
                std = math.sqrt(2.0 / float(fan_in + fan_out))
            else:
                gain = (8 * self.network_depth) ** (-1 / 4)
                std = gain * math.sqrt(2.0 / float(fan_in + fan_out))
            trunc_normal_(m.weight, std=std)
            if m.bias is not None:
                nn.init.constant_(m.bias, 0)

    def forward(self, X):
        V = self.V(X)
        if self.use_attn:
            QK = self.QK(X)
            QKV = torch.cat([QK, V], dim=1)
            attn_out = partition_attention(self.attn, QKV, self.shift_size)
            return self.proj(self.conv(V) + attn_out)
        return self.proj(self.conv(V))


class TransformerBlock(nn.Module):
    def __init__(self, network_depth, dim, num_heads, mlp_ratio=4., norm_layer=RLN, mlp_norm=False,
                 window_size=8, shift_size=0, use_attn=True, conv_type=None):
        super().__init__()
        self.use_attn = use_attn
        self.mlp_norm = mlp_norm
        self.norm1 = norm_layer(dim) if use_attn else nn.Identity()
        self.attn = Attention(network_depth, dim, num_heads=num_heads, window_size=window_size,
                              shift_size=shift_size, use_attn=use_attn, conv_type=conv_type)
        self.norm2 = norm_layer(dim) if use_attn and mlp_norm else nn.Identity()
        self.mlp = Mlp(network_depth, dim, hidden_features=int(dim * mlp_ratio))

    def forward(self, x):
        identity = x
        if self.use_attn:
            x, rescale, rebias = self.norm1(x)
        x = self.attn(x)
        if self.use_attn:
            x = x * rescale + rebias
        x = identity + x
        identity = x
        x = self.mlp(x)
        x = identity + x
        return x


class BasicLayer(nn.Module):
    def __init__(self, network_depth, dim, depth, num_heads, mlp_ratio=4., norm_layer=RLN, window_size=8,
                 attn_ratio=0., conv_type="DWConv"):
        super().__init__()
        self.dim = dim
        self.depth = depth
        attn_depth = attn_ratio * depth
        use_attns = [i >= depth - attn_depth for i in range(depth)]
        self.blocks = nn.ModuleList([
            TransformerBlock(network_depth=network_depth, dim=dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
                             norm_layer=norm_layer, window_size=window_size,
                             shift_size=0 if (i % 2 == 0) else window_size // 2,
                             use_attn=use_attns[i], conv_type=conv_type)
            for i in range(depth)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size=4, in_chans=3, embed_dim=96, kernel_size=None):
        super().__init__()
        if kernel_size is None:
            kernel_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=kernel_size, stride=patch_size,
                              padding=(kernel_size - patch_size + 1) // 2, padding_mode="reflect")

    def forward(self, x):
        return self.proj(x)


class PatchUnEmbed(nn.Module):
    def __init__(self, patch_size=4, out_chans=3, embed_dim=96, kernel_size=None):
        super().__init__()
        if kernel_size is None:
            kernel_size = 1
        self.proj = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans * patch_size**2, kernel_size=kernel_size,
                      padding=kernel_size // 2, padding_mode="reflect"),
            nn.PixelShuffle(patch_size),
        )

    def forward(self, x):
        return self.proj(x)


class SKFusion(nn.Module):
    def __init__(self, dim, height=2, reduction=8):
        super().__init__()
        self.height = height
        d = max(int(dim / reduction), 4)
        self.avg_pool = nn.AdaptiveAvgPool2d(1)
        self.mlp = nn.Sequential(
            nn.Conv2d(dim, d, 1, bias=False),
            nn.ReLU(),
            nn.Conv2d(d, dim * height, 1, bias=False),
        )
        self.softmax = nn.Softmax(dim=1)

    def forward(self, in_feats):
        B, C, H, W = in_feats[0].shape
        in_feats = torch.cat(in_feats, dim=1)
        in_feats = in_feats.view(B, self.height, C, H, W)
        feats_sum = torch.sum(in_feats, dim=1)
        attn = self.mlp(self.avg_pool(feats_sum))
        attn = self.softmax(attn.view(B, self.height, C, 1, 1))
        out = torch.sum(in_feats * attn, dim=1)
        return out


class DehazeFormer(nn.Module):
    def __init__(self, in_chans=3, out_chans=4, window_size=8,
                 embed_dims=(24, 48, 96, 48, 24), mlp_ratios=(2., 4., 4., 2., 2.),
                 depths=(16, 16, 16, 8, 8), num_heads=(2, 4, 6, 1, 1),
                 attn_ratio=(1 / 4, 1 / 2, 3 / 4, 0, 0)):
        super().__init__()
        self.patch_size = 4
        self.window_size = window_size
        self.mlp_ratios = mlp_ratios
        nd = sum(depths)
        self.patch_embed = PatchEmbed(patch_size=1, in_chans=in_chans, embed_dim=embed_dims[0], kernel_size=3)
        self.layer1 = BasicLayer(nd, embed_dims[0], depths[0], num_heads[0], mlp_ratios[0], RLN, window_size,
                                 attn_ratio[0])
        self.patch_merge1 = PatchEmbed(patch_size=2, in_chans=embed_dims[0], embed_dim=embed_dims[1])
        self.skip1 = nn.Conv2d(embed_dims[0], embed_dims[0], 1)
        self.layer2 = BasicLayer(nd, embed_dims[1], depths[1], num_heads[1], mlp_ratios[1], RLN, window_size,
                                 attn_ratio[1])
        self.patch_merge2 = PatchEmbed(patch_size=2, in_chans=embed_dims[1], embed_dim=embed_dims[2])
        self.skip2 = nn.Conv2d(embed_dims[1], embed_dims[1], 1)
        self.layer3 = BasicLayer(nd, embed_dims[2], depths[2], num_heads[2], mlp_ratios[2], RLN, window_size,
                                 attn_ratio[2])
        self.patch_split1 = PatchUnEmbed(patch_size=2, out_chans=embed_dims[3], embed_dim=embed_dims[2])
        self.fusion1 = SKFusion(embed_dims[3])
        self.layer4 = BasicLayer(nd, embed_dims[3], depths[3], num_heads[3], mlp_ratios[3], RLN, window_size,
                                 attn_ratio[3])
        self.patch_split2 = PatchUnEmbed(patch_size=2, out_chans=embed_dims[4], embed_dim=embed_dims[3])
        self.fusion2 = SKFusion(embed_dims[4])
        self.layer5 = BasicLayer(nd, embed_dims[4], depths[4], num_heads[4], mlp_ratios[4], RLN, window_size,
                                 attn_ratio[4])
        self.patch_unembed = PatchUnEmbed(patch_size=1, out_chans=out_chans, embed_dim=embed_dims[4], kernel_size=3)

    def check_image_size(self, x):
        _, _, h, w = x.size()
        mod_pad_h = (self.patch_size - h % self.patch_size) % self.patch_size
        mod_pad_w = (self.patch_size - w % self.patch_size) % self.patch_size
        return F.pad(x, (0, mod_pad_w, 0, mod_pad_h), "reflect")

    def forward_features(self, x):
        x = self.patch_embed(x)
        x = self.layer1(x)
        skip1 = x
        x = self.patch_merge1(x)
        x = self.layer2(x)
        skip2 = x
        x = self.patch_merge2(x)
        x = self.layer3(x)
        x = self.patch_split1(x)
        x = self.fusion1([x, self.skip2(skip2)]) + x
        x = self.layer4(x)
        x = self.patch_split2(x)
        x = self.fusion2([x, self.skip1(skip1)]) + x
        x = self.layer5(x)
        x = self.patch_unembed(x)
        return x

    def forward(self, x):
        H, W = x.shape[2:]
        x = self.check_image_size(x)
        feat = self.forward_features(x)
        K, B = torch.split(feat, (1, 3), dim=1)
        x = K * x - B + x
        x = x[:, :, :H, :W]
        return x
