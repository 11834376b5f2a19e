"""Per-channel batch statistics of NHWC activations (the ``channel_stats`` kernel).

Counterpart of ``fdgan_tpu/nn/layers.py::_batch_stats`` (``:125-145``),
which XLA fuses into one pass that never holds an fp32 copy of x. On a CUDA
bf16 tensor :func:`channel_stats` launches the hand-written kernel of
``csrc/channel_stats.cu``: x is read once, in bf16, and each block keeps
its sums in fp32 registers; the per-block partials are reduced in float64.
On a CPU bf16 tensor it runs the plain twin :func:`one_pass_reference`, the
same one-pass formula in torch (which does make an fp32 copy). fp32
activations are the parity mode: they keep the two-pass form
(:func:`two_pass_reference`) on every device, as the JAX package does.

The bf16 op is ``fdgan::channel_stats`` (``ops/library.py``), differentiable:
the train step differentiates through the batch statistics, of the
generator and of the discriminator. Its backward is the one-pass formula's VJP in closed form
(:func:`one_pass_vjp`), one elementwise pass in fp32 that writes dx in x's
dtype: no fp32 copy of x in the backward either.

x may be a channel slice of a wider NHWC buffer (``ops/common.py::
pixel_stride``): a dense block's new 32 channels inside its concat. A CUDA
tensor in any other layout raises; nothing copies it quietly.

``launches`` counts the kernel launches in this process; the twins do not
move it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fdgan_tpu_torch.ops import library  # noqa: F401  (registers the fdgan:: ops)
from fdgan_tpu_torch.ops.common import pixel_stride

_DIMS = (0, 1, 2)  # B, H, W of an NHWC tensor

launches = 0


def reset_launch_count() -> None:
    global launches
    launches = 0


def one_pass_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the kernel: fp32 mean and biased variance over B, H and
    W by the one-pass E[x²]−μ², clamped at 0 (``_batch_stats``'s bf16
    branch): its fp32 cancellation error is far below bf16's own steps."""
    mean = x.mean(dim=_DIMS, dtype=torch.float32)
    return mean, (x.float().square().mean(dim=_DIMS) - mean.square()).clamp_min(0.0)


def two_pass_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 form: mean, then the mean square deviation from it."""
    mean = x.mean(dim=_DIMS, dtype=torch.float32)
    return mean, (x.float() - mean).square().mean(dim=_DIMS)


def reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain statistics by dtype: one-pass for bf16, two-pass otherwise."""
    return one_pass_reference(x) if x.dtype == torch.bfloat16 else two_pass_reference(x)


def one_pass_vjp(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, ct_mean: torch.Tensor,
                 ct_var: torch.Tensor) -> torch.Tensor:
    """The VJP of the one-pass statistics at x, from their outputs: with n
    pixels, dx = ct_mean/n + ct_var·2(x − mean)/n where the clamp at 0 let
    the variance through (var > 0; where it bit, all of x equals its mean
    and the term is 0 anyway), as b + a·x with the per-channel fp32 a =
    2·ct_var/n and b = ct_mean/n − a·mean. One pass that computes in fp32
    and rounds once into a tensor of x's dtype: on the card the elementwise
    kernel casts as it stores, so no fp32 tensor of x's size exists. (The
    twin's VJP by autograd rounds its two terms to x's dtype before it adds
    them, and so differs from this by a few bf16 roundings of those terms:
    ``tests/test_torch_stats.py`` states the bound.)"""
    n = x.numel() // x.shape[-1]
    a = 2.0 * torch.where(var > 0, ct_var.float(), 0.0) / n
    b = ct_mean.float() / n - a * mean
    return torch.addcmul(b, x, a, out=torch.empty(x.shape, device=x.device, dtype=x.dtype))


def _launch(x: torch.Tensor, ld: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fdgan::channel_stats`` on CUDA: check x (its pixel stride against
    ``ld``, the op's; x's own where None), launch the kernel and its float64
    reduction; raises on a CUDA error and on a layout the kernel does not
    take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"channel_stats runs its kernel on cuda, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the channel_stats kernel is bfloat16 only, got {x.dtype}")
    own = pixel_stride(x)
    if ld is not None and own != ld:
        raise ValueError(f"x has pixel stride {own}, the op was given ld={ld}")
    ld = own
    b, h, w, c = x.shape
    npix = b * h * w
    if c % 8 or ld % 8 or x.data_ptr() % 16:
        # the kernel reads 16-byte vectors of 8 channels
        raise ValueError(f"channel_stats needs C % 8 == 0, a pixel stride ld % 8 == 0 and 16-byte alignment, "
                         f"got C={c}, ld={ld}")
    if npix == 0:
        raise ValueError("channel_stats of an empty tensor")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    out = torch.empty((2, c), device=x.device, dtype=torch.float32)  # mean, biased var
    with torch.cuda.device(x.device):
        rows = lib.fdgan_channel_stats_blocks(npix, c)  # one row of partials per block
        build.check(lib, -min(rows, 0), "fdgan_channel_stats_blocks")
        part = torch.empty((2, rows, c), device=x.device, dtype=torch.float64)  # sums of x, of x·x
        err = lib.fdgan_channel_stats_bf16(x.data_ptr(), part.data_ptr(), out.data_ptr(), npix, c, ld, rows,
                                           torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "fdgan_channel_stats_bf16")
    launches += 1
    return out[0], out[1]


def channel_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 (mean, biased var) of NHWC x over B, H and W
    (differentiable). bf16 x goes through ``fdgan::channel_stats``: the
    kernel on a CUDA tensor, its twin on a CPU one, the closed-form VJP
    backward. Any other dtype takes the two-pass form."""
    if x.dtype == torch.bfloat16:
        return torch.ops.fdgan.channel_stats(x, pixel_stride(x))
    return two_pass_reference(x)
