"""The fused frequency decomposition (K3) of the fusion discriminator.

Counterpart of ``fdgan_tpu/ops/pallas_filters.py``. :func:`frequency_fuse`
maps NHWC x (B, H, W, 3) to concat[x, LF, HF] (B, H, W, 9) in x's dtype.
On a CUDA tensor it launches the hand-written kernel of
``csrc/freq_filters.cu``; on a CPU tensor it runs the plain version,
``ops.filters.frequency_fuse``, which keeps the kernel's rounding points. A
CUDA launch that fails raises; nothing falls back.

It is a ``torch.autograd.Function``: the generator's adversarial term
differentiates through D(fuse(x̂)). The JAX kernel has no VJP (its train
step uses XLA's filters); here the backward is the VJP of the plain
version with respect to x, recomputed from the saved input.

``k3_launches`` counts the kernel launches in this process; the plain
version does not move it.
"""

from __future__ import annotations

import numpy as np
import torch

from fdgan_tpu_torch.ops import filters
from fdgan_tpu_torch.ops.common import twin_vjp

k3_launches = 0

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# taps, mean, std in fp32, as csrc/freq_filters.cu reads them
_CONSTS = np.concatenate([
    filters.blur_taps(), np.asarray(filters.IMAGENET_MEAN, np.float32), np.asarray(filters.IMAGENET_STD, np.float32),
]).astype(np.float32)


def reset_launch_count() -> None:
    global k3_launches
    k3_launches = 0


def _launch_k3(x: torch.Tensor) -> torch.Tensor:
    global k3_launches
    if x.device.type != "cuda":
        raise ValueError(f"frequency_fuse runs on cpu or cuda, got {x.device}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"x must be NHWC (B, H, W, 3), got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    b, h, w, _ = x.shape
    if min(h, w) <= filters.BLUR_PAD:
        raise ValueError(f"H and W must exceed the reflect pad {filters.BLUR_PAD}, got {(h, w)}")
    if x.numel() * 3 >= 2**31:
        raise ValueError("x is too large for the kernel's 32-bit indices")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    out = torch.empty((b, h, w, 9), device=x.device, dtype=x.dtype)
    fn = getattr(lib, f"fdgan_freq_filters_{_KERNEL_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), _CONSTS.ctypes.data, b, h, w, stream)
    build.check(lib, err, "fdgan_freq_filters")
    k3_launches += 1
    return out


class _FrequencyFuse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return filters.frequency_fuse(x)
        return _launch_k3(x)

    @staticmethod
    def backward(ctx, ct):
        return twin_vjp(filters.frequency_fuse, ctx, (ct,))


def frequency_fuse(x: torch.Tensor) -> torch.Tensor:
    """concat[RGB, LF, HF] of NHWC x (differentiable): (B, H, W, 3) →
    (B, H, W, 9) in x's dtype, through K3 on a CUDA tensor."""
    return _FrequencyFuse.apply(x)
