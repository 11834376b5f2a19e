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

With H sharded, ``frequency_fuse(x, halo=(top, bottom))`` takes the 7 rows
of the image above and below the shard x (``dist.halo_exchange.halo_rows``;
None at an end of the image). The kernel's halo variant reads them where it
would reflect, and reflects (blur) or zero-pads (Laplacian) only at an end;
the backward also returns the halo rows' cotangents, which the exchange
sends back to their owners.

``k3_launches`` counts the kernel launches in this process; the plain
version does not move it.
"""

from __future__ import annotations

from typing import Optional

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


def _halo_operand(x: torch.Tensor, r: Optional[torch.Tensor], name: str) -> Optional[torch.Tensor]:
    """A halo row block as K3 reads it: its 7 rows next to x, contiguous,
    16-byte aligned; None stays None."""
    if r is None:
        return None
    if r.device != x.device or r.dtype != x.dtype or r.dim() != 4 or r.shape[0] != x.shape[0] \
            or r.shape[1] < filters.BLUR_PAD or r.shape[2:] != x.shape[2:]:
        raise ValueError(f"halo {name} must be (B, >={filters.BLUR_PAD}, W, 3) of x's dtype and device, got "
                         f"{tuple(r.shape)} {r.dtype} on {r.device}")
    r = (r[:, r.shape[1] - filters.BLUR_PAD:] if name == "top" else r[:, :filters.BLUR_PAD]).contiguous()
    if r.data_ptr() % 16:
        r = r.clone()
    return r


def _launch_k3(x: torch.Tensor, halo=None) -> torch.Tensor:
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
    dt = _KERNEL_DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if halo is None:
            entry = f"fdgan_freq_filters_{dt}"
            err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), _CONSTS.ctypes.data, b, h, w, stream)
        else:
            top, bottom = (_halo_operand(x, r, n) for r, n in zip(halo, ("top", "bottom")))
            entry = f"fdgan_freq_filters_halo_{dt}"
            err = getattr(lib, entry)(x.data_ptr(), 0 if top is None else top.data_ptr(),
                                      0 if bottom is None else bottom.data_ptr(), out.data_ptr(),
                                      _CONSTS.ctypes.data, b, h, w, stream)
    build.check(lib, err, entry)
    k3_launches += 1
    return out


def _fuse_twin(x, top, bottom):
    return filters.frequency_fuse(x, None if top is None and bottom is None else (top, bottom))


class _FrequencyFuse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom):
        ctx.save_for_backward(x, top, bottom)
        halo = None if top is None and bottom is None else (top, bottom)
        if x.device.type == "cpu":
            return filters.frequency_fuse(x, halo)
        return _launch_k3(x, halo)

    @staticmethod
    def backward(ctx, ct):
        return twin_vjp(_fuse_twin, ctx, (ct,))


def frequency_fuse(x: torch.Tensor, halo=None) -> torch.Tensor:
    """concat[RGB, LF, HF] of NHWC x (differentiable): (B, H, W, 3) →
    (B, H, W, 9) in x's dtype, through K3 on a CUDA tensor. ``halo``
    (top, bottom): x is a shard of the image along H, with the rows above
    and below it (each (B, ≥7, W, 3), None at an end of the image)."""
    top, bottom = halo if halo is not None else (None, None)
    return _FrequencyFuse.apply(x.contiguous(), top, bottom)  # a band of rows of a batch is a strided view
