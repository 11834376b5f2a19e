"""The fused DenseNet layer (K1) and norm2's batch statistics (K2).

Counterpart of ``fdgan_tpu/ops/pallas_dense.py``. On a CUDA tensor,
``fused_dense_layer`` and ``h_batch_stats`` launch the hand-written kernels
of ``csrc/dense_layer.cu``; on a CPU tensor they run the plain PyTorch twins
``layer_reference`` and ``h_stats_reference``, which keep the kernels'
rounding points. A CUDA launch that fails raises; nothing falls back.

Tensors here are in the JAX layout, NHWC: the generator passes the NHWC
view of its channels_last activations, which costs no copy. Weights are
``w1`` (C, 128), the 1×1 conv as a matrix, and ``w2`` (3, 3, 128, 32), HWIO.

``k1_launches`` and ``k2_launches`` count the kernel launches in this
process; the twins do not move them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from fdgan_tpu_torch.nn.layers import batch_stats

_EPS = 1e-5
INTER = 128   # bn_size * growth of DenseNet-121
GROWTH = 32

k1_launches = 0
k2_launches = 0


def reset_launch_counts() -> None:
    global k1_launches, k2_launches
    k1_launches = 0
    k2_launches = 0


def fold_bn(weight, bias, mean, var) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN as a per-channel fp32 affine: y = a·x + b."""
    a = weight.float() * torch.rsqrt(var.float() + _EPS)
    return a, bias.float() - mean.float() * a


def channel_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 (mean, biased var) of an NHWC tensor over B, H, W."""
    return batch_stats(x, dims=(0, 1, 2))


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _t(x, a1, b1) -> torch.Tensor:
    """t = relu(a1·x + b1) in fp32, rounded to x's dtype."""
    return torch.relu(x.float() * a1.float() + b1.float()).to(x.dtype)


def layer_reference(x, a1, b1, w1, a2, b2, w2) -> torch.Tensor:
    """Plain twin of K1, with its rounding points: t and g are rounded to
    x's dtype, h and f are accumulated in fp32, and g is zero-padded. The
    convs run on fp32 copies, so bf16 operands multiply exactly."""
    t = _t(x, a1, b1).permute(0, 3, 1, 2)
    w1_oihw = w1.t().reshape(INTER, -1, 1, 1).float()
    h = F.conv2d(t.float(), w1_oihw)
    g = torch.relu(h * a2.float().view(1, -1, 1, 1) + b2.float().view(1, -1, 1, 1)).to(x.dtype)
    f = F.conv2d(g.float(), w2.permute(3, 2, 0, 1).float(), padding=1)
    return f.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def h_stats_reference(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K2: h = t·W1 in fp32, then a two-pass fp32 mean and
    biased variance per channel."""
    t = _t(x, a1, b1).reshape(-1, x.shape[-1])
    h = t.float() @ w1.float()
    mean = h.mean(dim=0)
    return mean, (h - mean).square().mean(dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_inputs(x, a1, b1, w1) -> int:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (B, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be NHWC-contiguous")
    c = x.shape[-1]
    if tuple(w1.shape) != (c, INTER):
        raise ValueError(f"w1 must be ({c}, {INTER}), got {tuple(w1.shape)}")
    if a1.numel() != c or b1.numel() != c:
        raise ValueError(f"a1, b1 must have {c} entries")
    if x.numel() >= 2**31:
        raise ValueError("x is too large for the kernels' 32-bit pixel indices")
    if x.dtype == torch.bfloat16 and (c % 8 or x.data_ptr() % 16):
        # the bf16 kernels stage x in 16-byte vectors of 8 channels
        raise ValueError(f"bf16 x needs C % 8 == 0 and 16-byte alignment, got C={c}")
    return c


def _w1_arg(w1, x) -> torch.Tensor:
    """W1 in the layout the kernel of x's dtype reads: (C, 128) for fp32,
    transposed to (128, C) for bf16."""
    w = _on_device(w1, x, x.dtype)
    return w if x.dtype == torch.float32 else w.t().contiguous()


def _on_device(t: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """A contiguous copy of ``t`` on x's device in ``dtype`` (a no-op when it
    already is one); the kernels take raw pointers."""
    if t.device != x.device:
        raise ValueError(f"tensor on {t.device}, x on {x.device}")
    return t.to(dtype).contiguous()


def fused_dense_layer(x, a1, b1, w1, a2, b2, w2) -> torch.Tensor:
    """One fused dense layer: x (B,H,W,C) → f (B,H,W,32) in x's dtype.

    a1, b1 (C) and a2, b2 (128) are the folded norm1 and norm2 affines,
    w1 (C, 128), w2 (3, 3, 128, 32)."""
    global k1_launches
    if x.device.type == "cpu":
        return layer_reference(x, a1, b1, w1, a2, b2, w2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_layer runs on cpu or cuda, got {x.device}")
    _check_inputs(x, a1, b1, w1)
    if tuple(w2.shape) != (3, 3, INTER, GROWTH):
        raise ValueError(f"w2 must be (3, 3, {INTER}, {GROWTH}), got {tuple(w2.shape)}")
    if a2.numel() != INTER or b2.numel() != INTER:
        raise ValueError(f"a2, b2 must have {INTER} entries")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    bsz, h, w, c = x.shape
    a1k, b1k, a2k, b2k = (_on_device(t, x, torch.float32) for t in (a1, b1, a2, b2))
    w1k = _w1_arg(w1, x)
    # W2 as (9·128, 32) for fp32; for bf16 as (9, 32, 128), per tap the
    # inputs of each output channel
    w2k = _on_device(w2 if x.dtype == torch.float32 else w2.permute(0, 1, 3, 2), x, x.dtype)
    out = torch.empty((bsz, h, w, GROWTH), device=x.device, dtype=x.dtype)
    fn = getattr(lib, f"fdgan_dense_layer_{_KERNEL_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), a1k.data_ptr(), b1k.data_ptr(), w1k.data_ptr(),
            a2k.data_ptr(), b2k.data_ptr(), w2k.data_ptr(), out.data_ptr(),
            bsz, h, w, c, stream,
        )
    build.check(lib, err, "fdgan_dense_layer")
    k1_launches += 1
    return out


def h_batch_stats(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """norm2's batch statistics: per-channel fp32 (mean, biased var) of
    h = relu(a1·x + b1)·W1 over B, H and W."""
    global k2_launches
    if x.device.type == "cpu":
        return h_stats_reference(x, a1, b1, w1)
    if x.device.type != "cuda":
        raise ValueError(f"h_batch_stats runs on cpu or cuda, got {x.device}")
    c = _check_inputs(x, a1, b1, w1)
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    npix = x.numel() // c
    rows = lib.fdgan_h_stats_rows()
    nblk = -(-npix // rows)
    a1k, b1k = (_on_device(t, x, torch.float32) for t in (a1, b1))
    w1k = _w1_arg(w1, x)
    psum = torch.empty((nblk, INTER), device=x.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    fn = getattr(lib, f"fdgan_h_stats_{_KERNEL_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), a1k.data_ptr(), b1k.data_ptr(), w1k.data_ptr(),
            psum.data_ptr(), psq.data_ptr(), npix, c, stream,
        )
    build.check(lib, err, "fdgan_h_stats")
    k2_launches += 1
    # the partials are reduced in float64: at 8×512² the count is 2.1 M, and
    # E[h²]−μ² in fp32 would lose the variance to cancellation
    mean = psum.double().sum(dim=0) / npix
    var = (psq.double().sum(dim=0) / npix - mean.square()).clamp_min(0.0)
    return mean.float(), var.float()


# ---------------------------------------------------------------------------
# Full dense block
# ---------------------------------------------------------------------------

def dense_block_fused(layers, x: torch.Tensor, mode: str = "batch", impl: str = "kernels") -> torch.Tensor:
    """A DenseNet block over NHWC x: ``layers`` are the block's DenseLayer
    modules (norm1, conv1, norm2, conv2). Returns the concat of x and every
    layer's 32 new channels.

    In batch mode, norm1's statistics are the per-channel statistics of the
    concat, kept per segment as it grows (channels partition, so each
    segment is reduced once), and norm2's come from K2. ``impl='plain'``
    runs the twins on any device."""
    if mode not in ("batch", "running"):
        raise ValueError(f"unknown BN mode {mode!r}")
    if impl == "kernels":
        layer_fn, stats_fn = fused_dense_layer, h_batch_stats
    elif impl == "plain":
        layer_fn, stats_fn = layer_reference, h_stats_reference
    else:
        raise ValueError(f"unknown impl {impl!r}")
    if mode == "batch":
        mean_cat, var_cat = channel_stats(x)
    for layer in layers:
        if mode == "batch":
            m1, v1 = mean_cat, var_cat
        else:
            m1, v1 = layer.norm1.running_mean, layer.norm1.running_var
        a1, b1 = fold_bn(layer.norm1.weight, layer.norm1.bias, m1, v1)
        w1 = layer.conv1.weight.reshape(INTER, -1).t()
        if mode == "batch":
            m2, v2 = stats_fn(x, a1, b1, w1)
        else:
            m2, v2 = layer.norm2.running_mean, layer.norm2.running_var
        a2, b2 = fold_bn(layer.norm2.weight, layer.norm2.bias, m2, v2)
        f = layer_fn(x, a1, b1, w1, a2, b2, layer.conv2.weight.permute(2, 3, 1, 0))
        if mode == "batch":
            mf, vf = channel_stats(f)
            mean_cat = torch.cat([mean_cat, mf])
            var_cat = torch.cat([var_cat, vf])
        x = torch.cat([x, f], dim=-1)
    return x
