"""Shifted 8×8 window attention with a relative-position bias (DehazeFormer).

:func:`window_attention` maps NHWC ``qk`` (B, H, W, 2C: Q then K) and ``v``
(B, H, W, C) to the attention output O (B, H, W, C), as DehazeFormer's
``Attention.forward`` computes it between its QK and V convolutions and
its projection (``models/dehazeformer.py``): [Q, K, V] reflect-padded to
multiples of 8 (shift 0: at the bottom and right; shift 4: 4 rows and
columns before, the rest after), split into 8×8 windows of 64 tokens, C
split into ``heads`` heads of contiguous channels, in each window and head
O = softmax(q·kᵀ·hd^−½ + B_h)·v, and the rows and columns of the image
cropped back out.

On a CUDA bf16 tensor it launches the hand-written kernel of
``csrc/window_attention.cu``: the padding and the window split are index
arithmetic, each block stages whole windows in shared memory, scores and
softmax stay in fp32 registers, and O is written only for the image's own
pixels. On a CPU tensor it runs :func:`reference`, the published code's
steps in plain torch (F.pad, the window partition, matmuls in fp32). A
CUDA tensor in any other dtype or layout raises; nothing falls back.

``bias`` is B_h, (heads, 64, 64) fp32: DehazeFormer computes it once a
forward per block from its ``meta`` MLP (``WindowAttention.bias``).

``launches`` counts the kernel launches in this process; the plain version
does not move it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

WINDOW = 8
TOKENS = WINDOW * WINDOW
HEAD_DIMS = (12, 16)  # the kernel's head dims: DehazeFormer-B's (12, 12, 16)

launches = 0


def reset_launch_count() -> None:
    global launches
    launches = 0


def pads(size: int, shift: int) -> Tuple[int, int]:
    """Reflect padding (before, after) of an axis of ``size`` for ``shift``
    (0 or WINDOW // 2): a multiple of WINDOW in all, ``shift`` before."""
    m = -size % WINDOW
    return (shift, (WINDOW - shift + m) % WINDOW) if shift else (0, m)


def _check(qk: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, heads: int, shift: int) -> int:
    """Validate the operands; returns the head dim."""
    if qk.dim() != 4 or v.dim() != 4 or qk.shape[:3] != v.shape[:3] or qk.shape[-1] != 2 * v.shape[-1]:
        raise ValueError(f"qk must be (B, H, W, 2C) and v (B, H, W, C), got {tuple(qk.shape)} and {tuple(v.shape)}")
    c = v.shape[-1]
    if heads < 1 or c % heads:
        raise ValueError(f"C = {c} does not split into {heads} heads")
    if tuple(bias.shape) != (heads, TOKENS, TOKENS):
        raise ValueError(f"bias must be (heads, {TOKENS}, {TOKENS}), got {tuple(bias.shape)}")
    if shift not in (0, WINDOW // 2):
        raise ValueError(f"shift must be 0 or {WINDOW // 2}, got {shift}")
    for size in qk.shape[1:3]:
        if max(pads(size, shift)) >= size:
            raise ValueError(f"a side of {size} is too short to reflect-pad by {pads(size, shift)}")
    return c // heads


def reference(qk: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, heads: int, shift: int) -> torch.Tensor:
    """Plain version: the published steps in torch, scores, softmax and both
    products in fp32; O in v's dtype."""
    hd = _check(qk, v, bias, heads, shift)
    b, h, w, c = v.shape
    x = torch.cat([qk, v], dim=-1).permute(0, 3, 1, 2)
    (top, bottom), (left, right) = pads(h, shift), pads(w, shift)
    x = F.pad(x, (left, right, top, bottom), mode="reflect")
    hp, wp = x.shape[2:]
    nh, nw = hp // WINDOW, wp // WINDOW
    x = x.reshape(b, 3, heads, hd, nh, WINDOW, nw, WINDOW)
    # (3, B, nh, nw, heads, 64 tokens, hd)
    x = x.permute(1, 0, 4, 6, 2, 5, 7, 3).reshape(3, b, nh, nw, heads, TOKENS, hd).float()
    q, k, vv = x[0], x[1], x[2]
    attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1) + bias.float(), dim=-1)
    o = (attn @ vv).reshape(b, nh, nw, heads, WINDOW, WINDOW, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)
    return o[:, top:top + h, left:left + w].to(v.dtype)


def _launch(qk: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, heads: int, shift: int) -> torch.Tensor:
    """The kernel on CUDA: check the operands, allocate O, launch; raises on
    a CUDA error and on what the kernel does not take."""
    global launches
    hd = _check(qk, v, bias, heads, shift)
    if qk.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the window_attention kernel is bfloat16 only, got {qk.dtype} and {v.dtype}")
    if bias.dtype != torch.float32 or bias.device != qk.device or v.device != qk.device:
        raise TypeError("bias must be float32, and all operands on one device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {hd}")
    b, h, w, c = v.shape
    if c % 8 or heads > 8:
        raise ValueError(f"the kernel needs C % 8 == 0 and at most 8 heads, got C={c}, heads={heads}")
    if not (qk.is_contiguous() and v.is_contiguous() and bias.is_contiguous()):
        raise ValueError("qk, v and bias must be contiguous (NHWC)")
    if qk.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("qk and v must be 16-byte aligned")
    if qk.numel() >= 2**31:
        raise ValueError("qk is too large for the kernel's 32-bit pixel indices")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    out = torch.empty_like(v)
    with torch.cuda.device(qk.device):
        err = lib.fdgan_window_attention_bf16(qk.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                                              c, heads, shift, torch.cuda.current_stream(qk.device).cuda_stream)
    build.check(lib, err, "fdgan_window_attention_bf16")
    launches += 1
    return out


def window_attention(qk: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, heads: int, shift: int) -> torch.Tensor:
    """O (B, H, W, C) of NHWC ``qk`` (B, H, W, 2C) and ``v`` (B, H, W, C)
    under the relative-position bias ``bias`` (heads, 64, 64): the kernel on
    a CUDA tensor, :func:`reference` on a CPU one."""
    if qk.device.type == "cpu":
        return reference(qk, v, bias, heads, shift)
    return _launch(qk, v, bias, heads, shift)
