"""DehazeFormer (Song, He, Qian and Du, IEEE TIP 2023, arXiv:2204.03883;
IDKiro/DehazeFormer ``models/dehazeformer.py``) as the benchmark serves it:
``InferenceEngine`` takes the loaded module, whose forward runs the
shifted-window attention through the port's kernel, and the plain
reference is :func:`reference`, written here from the published layer
equations.

The reference is functional fp32 torch over the state dict (the published
names), NCHW inside, and imports nothing of the port. It reads the
architecture from the names and shapes (blocks per stage, the attending
ones by their ``norm1``, heads by ``meta``'s output, widths by the
weights), so it serves any depths at the published layout."""

from __future__ import annotations

import re
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from harness import counts
from harness import reference as plain

WINDOW = 8
EPS = 1e-5


def template():
    """The program's DehazeFormer-B on the meta device: its state dict
    names the weights."""
    from fdgan_tpu_torch.models.dehazeformer import dehazeformer_b

    return dehazeformer_b(device="meta")


def program(weights, device, mix):
    """What the cell's entry point is given: DehazeFormer-B holding
    ``weights`` (already on ``device`` in the served dtype), in eval mode."""
    from fdgan_tpu_torch.models.dehazeformer import dehazeformer_b

    model = dehazeformer_b(device=device, dtype=next(iter(weights.values())).dtype)
    model.load_state_dict(weights, strict=True)
    return model.eval()


# --- the plain reference ----------------------------------------------------------------

class _Ref:
    def __init__(self, p: Dict[str, torch.Tensor], q: Callable):
        self.p, self.q = p, q
        self.out = getattr(q, "out", plain.identity)

    def conv(self, x, name, stride=1, reflect=0, groups=1):
        if reflect:
            x = F.pad(x, (reflect,) * 4, mode="reflect")
        return self.out(F.conv2d(self.q(x), self.q(self.p[f"{name}.weight"]), self.p.get(f"{name}.bias"),
                                 stride=stride, groups=groups))

    def linear(self, x, name):
        return self.out(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"]))

    def matmul(self, a, b):
        return self.out(self.q(a) @ self.q(b))


def _relative_positions(device) -> torch.Tensor:
    """(64, 64, 2): sign(Δ)·log(1 + |Δ|) of each token pair's (Δrow, Δcol)."""
    r = torch.arange(WINDOW, dtype=torch.float32)
    rows, cols = r.repeat_interleave(WINDOW), r.repeat(WINDOW)
    rel = torch.stack([rows[:, None] - rows[None, :], cols[:, None] - cols[None, :]], dim=-1)
    return (torch.sign(rel) * torch.log(1.0 + rel.abs())).to(device)


def _pad_windows(x, shift):
    """The published ``check_size``: reflect-pad NCHW x to multiples of 8,
    ``shift`` rows and columns before where shifted."""
    h, w = x.shape[2:]
    mh, mw = (WINDOW - h % WINDOW) % WINDOW, (WINDOW - w % WINDOW) % WINDOW
    if shift:
        return F.pad(x, (shift, (WINDOW - shift + mw) % WINDOW, shift, (WINDOW - shift + mh) % WINDOW), mode="reflect")
    return F.pad(x, (0, mw, 0, mh), mode="reflect")


def _window_attention(net: _Ref, qkv, name, heads, shift):
    """Attention on NCHW [QK, V] (3C channels): padded, split into 8×8
    windows, softmax(q·kᵀ/√hd + B_h)·v per window and head, merged, cropped."""
    b, c3, h, w = qkv.shape
    c = c3 // 3
    hd = c // heads
    x = _pad_windows(qkv, shift)
    hp, wp = x.shape[2:]
    x = x.permute(0, 2, 3, 1).reshape(b, hp // WINDOW, WINDOW, wp // WINDOW, WINDOW, c3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, WINDOW * WINDOW, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = x[0] * hd ** -0.5, x[1], x[2]
    pos = _relative_positions(qkv.device)
    bias = net.linear(torch.relu(net.linear(pos, f"{name}.meta.0")), f"{name}.meta.2").permute(2, 0, 1)
    attn = torch.softmax(net.matmul(q, k.transpose(-2, -1)) + bias.unsqueeze(0), dim=-1)
    o = net.matmul(attn, v).transpose(1, 2).reshape(-1, WINDOW * WINDOW, c)
    o = o.view(b, hp // WINDOW, wp // WINDOW, WINDOW, WINDOW, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return o[:, shift:shift + h, shift:shift + w].permute(0, 3, 1, 2)


def _block(net: _Ref, x, name, shift):
    p = net.p
    attending = f"{name}.norm1.weight" in p
    identity = x
    if attending:
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = torch.sqrt((x - mean).pow(2).mean(dim=(1, 2, 3), keepdim=True) + EPS)
        x = (x - mean) / std * p[f"{name}.norm1.weight"] + p[f"{name}.norm1.bias"]
        rescale, rebias = net.conv(std, f"{name}.norm1.meta1"), net.conv(mean, f"{name}.norm1.meta2")
    v = net.conv(x, f"{name}.attn.V")
    y = net.conv(v, f"{name}.attn.conv", reflect=2, groups=v.shape[1])
    if attending:
        heads = p[f"{name}.attn.attn.meta.2.weight"].shape[0]
        qkv = torch.cat([net.conv(x, f"{name}.attn.QK"), v], dim=1)
        y = y + _window_attention(net, qkv, f"{name}.attn.attn", heads, shift)
    y = net.conv(y, f"{name}.attn.proj")
    x = identity + (y * rescale + rebias if attending else y)
    return x + net.conv(torch.relu(net.conv(x, f"{name}.mlp.mlp.0")), f"{name}.mlp.mlp.2")


def _layer(net: _Ref, x, name):
    depth = 1 + max(int(m.group(1)) for k in net.p for m in [re.match(rf"{name}\.blocks\.(\d+)\.", k)] if m)
    for i in range(depth):
        x = _block(net, x, f"{name}.blocks.{i}", 0 if i % 2 == 0 else WINDOW // 2)
    return x


def _sk_fusion(net: _Ref, a, b, name):
    attn = net.conv(torch.relu(net.conv((a + b).mean(dim=(2, 3), keepdim=True), f"{name}.mlp.0")), f"{name}.mlp.2")
    attn = torch.softmax(attn.view(a.shape[0], 2, a.shape[1], 1, 1), dim=1)
    return a * attn[:, 0] + b * attn[:, 1]


def reference(p, x, bn_mode: str = "running", q: Callable = plain.identity) -> torch.Tensor:
    """DehazeFormer's served output of NHWC x in [0, 1] (mapped to [−1, 1]):
    J clamped to [−1, 1], as the published test script serves it
    (``network(input).clamp_(-1, 1)``), NHWC; every convolution's and
    matmul's operands through ``q``, their outputs through ``q.out``.
    ``bn_mode`` does not apply: the model has no BN."""
    net = _Ref(p, q)
    x = x.permute(0, 3, 1, 2).float() * 2.0 - 1.0
    h, w = x.shape[2:]
    x = F.pad(x, (0, -w % 4, 0, -h % 4), mode="reflect")
    y = _layer(net, net.conv(x, "patch_embed.proj", reflect=1), "layer1")
    skip1 = y
    y = _layer(net, net.conv(y, "patch_merge1.proj", stride=2), "layer2")
    skip2 = y
    y = _layer(net, net.conv(y, "patch_merge2.proj", stride=2), "layer3")
    y = F.pixel_shuffle(net.conv(y, "patch_split1.proj.0"), 2)
    y = _sk_fusion(net, y, net.conv(skip2, "skip2"), "fusion1") + y
    y = _layer(net, y, "layer4")
    y = F.pixel_shuffle(net.conv(y, "patch_split2.proj.0"), 2)
    y = _sk_fusion(net, y, net.conv(skip1, "skip1"), "fusion2") + y
    y = _layer(net, y, "layer5")
    feat = net.conv(y, "patch_unembed.proj.0", reflect=1)
    j = feat[:, :1] * x - feat[:, 1:] + x
    return j[:, :, :h, :w].clamp(-1.0, 1.0).permute(0, 2, 3, 1).contiguous()


# --- the window attention kernel's least time ---------------------------------------------

def attention_blocks(config: dict):
    """(stage, C) of every attending block of the configuration."""
    out = []
    for k, (dim, depth, ratio) in enumerate(zip(config["dims"], config["depths"], config["attn_ratios"])):
        out += [(k, dim)] * sum(1 for i in range(depth) if i >= depth - ratio * depth)
    return out


def wattn_ops_bytes(c: int, batch: int, h: int, w: int):
    """The window attention's operations and bytes for one launch at NHWC
    (batch, h, w, C): 4·64·C operations a padded token (q·kᵀ and a·v, 2 a
    multiply-add, every window full), and QK, V read and O written once a
    real pixel in bf16 (8·C bytes). The tokens are the unshifted split's: a
    shifted split may pad one window more a side, which adds operations
    only, and the bytes bound the launch either way (32 FLOP a byte)."""
    tokens = batch * (-(-h // WINDOW) * WINDOW) * (-(-w // WINDOW) * WINDOW)
    return 4 * WINDOW * WINDOW * c * tokens, 2 * 4 * c * batch * h * w


def wattn_mean_bound_s(config: dict, launch_shape) -> float:
    """The kernel's least time a launch, the larger of its operations over
    the bf16 peak and its bytes over the memory bandwidth, averaged over the
    attending blocks, at the (batch, H, W) the window serves (stage k at
    H / 2^k, W / 2^k)."""
    b, h, w = launch_shape
    blocks = attention_blocks(config)
    total = 0.0
    for k, c in blocks:
        ops, nbytes = wattn_ops_bytes(c, b, h >> k, w >> k)
        total += max(ops / counts.PEAKS["bf16_flops"], nbytes / counts.PEAKS["hbm_bytes_s"])
    return total / len(blocks)
