"""The fused DenseNet layer (K1) and norm2's batch statistics (K2).

Counterpart of ``fdgan_tpu/ops/pallas_dense.py``. On a CUDA tensor,
``fused_dense_layer`` and ``h_batch_stats`` launch the hand-written kernels
of ``csrc/dense_layer.cu``; on a CPU tensor they run the plain PyTorch twins
``layer_reference`` and ``h_stats_reference``, which keep the kernels'
rounding points. A CUDA launch that fails raises; nothing falls back. In
batch mode ``dense_block_fused`` takes norm1's statistics, segment by
segment, from the ``channel_stats`` kernel (``ops/stats.py``).

Tensors here are in the JAX layout, NHWC: the generator passes the NHWC
view of its channels_last activations, which costs no copy. Weights are
``w1`` (C, 128), the 1×1 conv as a matrix, and ``w2`` (3, 3, 128, 32), HWIO.
x, and K1's output ``out=``, may be channel slices of one wider NHWC buffer
(the kernels take a pixel stride): ``dense_block_fused`` keeps a block's
concat in one buffer that way when autograd records nothing.

Both ops are ``torch.autograd.Function``s, as the JAX ops are
``jax.custom_vjp``s (``pallas_dense.py:247-262``, ``:293-307``): the forward
is the kernel (the twin on the CPU), the backward is the VJP of the twin,
recomputed from the saved inputs. The JAX package has no backward kernel
for either, so neither has the port.

``k1_launches`` and ``k2_launches`` count the kernel launches in this
process; the twins do not move them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fdgan_tpu_torch.nn.layers import unbiased
from fdgan_tpu_torch.ops.common import pixel_stride, twin_vjp
from fdgan_tpu_torch.ops.stats import channel_stats
from fdgan_tpu_torch.ops.stats import reference as stats_reference

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


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _t(x, a1, b1) -> torch.Tensor:
    """t = relu(a1·x + b1) in fp32, rounded to x's dtype."""
    return torch.relu(x.float() * a1.float() + b1.float()).to(x.dtype)


def layer_reference(x, a1, b1, w1, a2, b2, w2) -> torch.Tensor:
    """Plain twin of K1, with its rounding points: t and g are rounded to
    x's dtype, h and f are accumulated in fp32, and g is zero-padded. The
    weights are rounded to x's dtype, as the kernel reads them. The convs
    run on fp32 copies, so bf16 operands multiply exactly."""
    t = _t(x, a1, b1).permute(0, 3, 1, 2)
    w1_oihw = w1.to(x.dtype).t().reshape(INTER, -1, 1, 1).float()
    h = F.conv2d(t.float(), w1_oihw)
    g = torch.relu(h * a2.float().view(1, -1, 1, 1) + b2.float().view(1, -1, 1, 1)).to(x.dtype)
    f = F.conv2d(g.float(), w2.to(x.dtype).permute(3, 2, 0, 1).float(), padding=1)
    return f.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def h_stats_reference(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K2: h = t·W1 in fp32, then a two-pass fp32 mean and
    biased variance per channel."""
    t = _t(x, a1, b1).reshape(-1, x.shape[-1])
    h = t.float() @ w1.to(x.dtype).float()
    mean = h.mean(dim=0)
    return mean, (h - mean).square().mean(dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_inputs(x, a1, b1, w1) -> Tuple[int, int]:
    """(C, ld) of x; raises on what the kernels do not take, on any device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the dense-layer ops run on cpu or cuda, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    ld = pixel_stride(x)
    c = x.shape[-1]
    if tuple(w1.shape) != (c, INTER):
        raise ValueError(f"w1 must be ({c}, {INTER}), got {tuple(w1.shape)}")
    if a1.numel() != c or b1.numel() != c:
        raise ValueError(f"a1, b1 must have {c} entries")
    if x.dtype == torch.bfloat16 and (c % 8 or ld % 8 or x.data_ptr() % 16):
        # the bf16 kernels load x in 16-byte vectors of 8 channels
        raise ValueError(f"bf16 x needs C % 8 == 0, a pixel stride ld % 8 == 0 and 16-byte alignment, "
                         f"got C={c}, ld={ld}")
    return c, ld


def _check_out(out, x) -> int:
    """out's pixel stride; raises unless out is a (B, H, W, 32) tensor of x's
    dtype and device that K1 can write."""
    want = tuple(x.shape[:3]) + (GROWTH,)
    if tuple(out.shape) != want or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"out must be {want} {x.dtype} on {x.device}, got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")
    ldo = pixel_stride(out, "out")
    if x.dtype == torch.bfloat16 and (ldo % 8 or out.data_ptr() % 16):
        raise ValueError(f"bf16 out needs a pixel stride ldo % 8 == 0 and 16-byte alignment, got ldo={ldo}")
    return ldo


def w1_planes(w1: torch.Tensor) -> torch.Tensor:
    """W1 (C, 128) as (C/8, 128, 8): planes of eight input channels,
    ``planes[p, n, k] = w1[8p + k, n]``. It is the shared-memory layout the
    bf16 kernels' ``wgmma`` descriptors name (``csrc/wgmma_bf16.cuh``), so 64
    channels of W1 are 16 contiguous KB that one bulk copy brings in."""
    c, n = w1.shape
    return w1.reshape(c // 8, 8, n).permute(0, 2, 1).contiguous()


def w1_tw1_planes(w1: torch.Tensor) -> torch.Tensor:
    """W1 (C, 128) for the ``tw1_stream`` kernels (bf16 K2, the conv1 probe's
    ``wgmma`` body; ``csrc/wgmma_bf16.cuh``): its rows zero-padded to a
    multiple of 64, permuted within each 64 into the order in which those
    kernels take a chunk's channels (logical k = 16s + kk is channel
    16·(kk % 8 // 2) + 4s + 2·(kk // 8) + kk % 2, which puts a thread's
    A-fragment elements of the ``wgmma`` on 16 consecutive channels of its
    rows), as planes of eight (``w1_planes``): a chunk of 64 channels is 16
    contiguous KB, and the padding multiplies a t of 0."""
    c, n = w1.shape
    c64 = -(-c // 64) * 64
    padded = torch.cat([w1, w1.new_zeros(c64 - c, n)]) if c64 > c else w1
    # channel 16·tq + 4s + 2·hi + e of a chunk is logical k 16s + 8·hi + 2·tq + e, which lies
    # in plane 2s + hi at place 2·tq + e: a view and one copy on W1's own device (an index
    # tensor built on the host would stall the stream at every call)
    return padded.reshape(c64 // 64, 4, 4, 2, 2, n).permute(0, 2, 3, 5, 1, 4).reshape(c64 // 8, n, 8)


def _on_device(t: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """A contiguous copy of ``t`` on x's device in ``dtype`` (a no-op when it
    already is one); the kernels take raw pointers."""
    if t.device != x.device:
        raise ValueError(f"tensor on {t.device}, x on {x.device}")
    return t.to(dtype).contiguous()


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_k1(x, a1, b1, w1, a2, b2, w2, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check the inputs, lay the weights out and launch K1, into ``out``
    (a (B,H,W,32) tensor, possibly a channel slice of a wider buffer) or a
    new tensor; raises on a CUDA error."""
    global k1_launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_layer runs its kernel on cuda, got {x.device}")
    c, ldx = _check_inputs(x, a1, b1, w1)
    if tuple(w2.shape) != (3, 3, INTER, GROWTH):
        raise ValueError(f"w2 must be (3, 3, {INTER}, {GROWTH}), got {tuple(w2.shape)}")
    if a2.numel() != INTER or b2.numel() != INTER:
        raise ValueError(f"a2, b2 must have {INTER} entries")
    if out is None:
        out = torch.empty(tuple(x.shape[:3]) + (GROWTH,), device=x.device, dtype=x.dtype)
    ldo = _check_out(out, x)
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    bsz, h, w, _ = x.shape
    a1k, b1k, a2k, b2k = (_on_device(t, x, torch.float32) for t in (a1, b1, a2, b2))
    # W2 as (9·128, 32) for fp32; for bf16 as (9, 32, 128), per tap the
    # inputs of each output channel
    w2k = _on_device(w2 if x.dtype == torch.float32 else w2.permute(0, 1, 3, 2), x, x.dtype)
    entry = f"fdgan_dense_layer_{_KERNEL_DTYPES[x.dtype]}"
    with torch.cuda.device(x.device):
        w1k = _on_device(w1, x, x.dtype)
        w1k = w1k if x.dtype == torch.float32 else w1_planes(w1k)
        err = getattr(lib, entry)(
            x.data_ptr(), a1k.data_ptr(), b1k.data_ptr(), w1k.data_ptr(),
            a2k.data_ptr(), b2k.data_ptr(), w2k.data_ptr(), out.data_ptr(),
            bsz, h, w, c, ldx, ldo, _stream(x),
        )
    build.check(lib, err, entry)
    k1_launches += 1
    return out


def _run_k2(x, a1, b1, w1, mma: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (bf16: its ``wgmma`` kernel, or with ``mma`` its
    ``mma.sync`` body) and reduce its per-block partials; raises on a CUDA
    error."""
    if x.device.type != "cuda":
        raise ValueError(f"h_batch_stats runs its kernel on cuda, got {x.device}")
    c, ldx = _check_inputs(x, a1, b1, w1)
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    npix = x.numel() // c
    a1k, b1k = (_on_device(t, x, torch.float32) for t in (a1, b1))
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16 and not mma:
            entry, w1k, partial = "fdgan_h_stats_bf16", w1_tw1_planes(_on_device(w1, x, x.dtype)), torch.float64
            rows = lib.fdgan_h_stats_bf16_blocks(npix)  # one row per persistent block
            build.check(lib, -min(rows, 0), "fdgan_h_stats_bf16_blocks")
        else:
            entry, partial = f"fdgan_h_stats_{_KERNEL_DTYPES[x.dtype]}{'_mma' if mma else ''}", torch.float32
            w1k = _on_device(w1, x, x.dtype)
            w1k = w1k.t().contiguous() if mma else w1k  # the mma.sync body stages W1 as (128, C)
            rows = -(-npix // lib.fdgan_h_stats_rows())  # one row per block of 192 pixels
        part = torch.empty((2, rows, INTER), device=x.device, dtype=partial)  # sums of h, of h·h
        err = getattr(lib, entry)(x.data_ptr(), a1k.data_ptr(), b1k.data_ptr(), w1k.data_ptr(),
                                  part[0].data_ptr(), part[1].data_ptr(), npix, c, ldx, _stream(x))
    build.check(lib, err, entry)
    # the partials are reduced in float64: at 8×512² the count is 2.1 M, and
    # E[h²]−μ² in fp32 would lose the variance to cancellation
    mom = part.double().sum(dim=1).div_(npix)
    mom[1].addcmul_(mom[0], mom[0], value=-1.0).clamp_min_(0.0)
    mean, var = mom.float()
    return mean, var


def _launch_k2(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    global k2_launches
    stats = _run_k2(x, a1, b1, w1)
    k2_launches += 1
    return stats


def _launch_k2_mma(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's earlier bf16 body (``mma.sync`` fragments, one block per 192
    pixels), kept so that one run can time it beside the ``wgmma`` kernel
    that ``h_batch_stats`` launches. No model path calls it and it moves no
    launch count."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the mma.sync body is bfloat16 only, got {x.dtype}")
    return _run_k2(x, a1, b1, w1, mma=True)


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a1, b1, w1, a2, b2, w2):
        ctx.save_for_backward(x, a1, b1, w1, a2, b2, w2)
        if x.device.type == "cpu":
            _check_inputs(x, a1, b1, w1)
            return layer_reference(x, a1, b1, w1, a2, b2, w2)
        return _launch_k1(x, a1, b1, w1, a2, b2, w2)

    @staticmethod
    def backward(ctx, ct):
        return twin_vjp(layer_reference, ctx, (ct,))


class _HStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a1, b1, w1):
        ctx.save_for_backward(x, a1, b1, w1)
        if x.device.type == "cpu":
            _check_inputs(x, a1, b1, w1)
            return h_stats_reference(x, a1, b1, w1)
        return _launch_k2(x, a1, b1, w1)

    @staticmethod
    def backward(ctx, ct_mean, ct_var):
        return twin_vjp(h_stats_reference, ctx, (ct_mean, ct_var))


def fused_dense_layer(x, a1, b1, w1, a2, b2, w2, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused dense layer (differentiable): x (B,H,W,C) → f (B,H,W,32)
    in x's dtype.

    a1, b1 (C) and a2, b2 (128) are the folded norm1 and norm2 affines,
    w1 (C, 128), w2 (3, 3, 128, 32). x may be a channel slice of a wider
    NHWC buffer (``pixel_stride``). With ``out``, a (B,H,W,32) tensor that
    may be such a slice too, f is written into it and ``out`` is returned:
    a write in place, which autograd cannot record, so it raises where
    autograd would record the call."""
    if out is None:
        return _FusedLayer.apply(x, a1, b1, w1, a2, b2, w2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a1, b1, w1, a2, b2, w2, out)):
        raise RuntimeError("fused_dense_layer(out=...) writes in place, which autograd cannot record: "
                           "call it under torch.no_grad() or torch.inference_mode()")
    if x.device.type == "cpu":
        _check_inputs(x, a1, b1, w1)
        _check_out(out, x)
        return out.copy_(layer_reference(x, a1, b1, w1, a2, b2, w2))
    return _launch_k1(x, a1, b1, w1, a2, b2, w2, out=out)


def h_batch_stats(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """norm2's batch statistics (differentiable): per-channel fp32 (mean,
    biased var) of h = relu(a1·x + b1)·W1 over B, H and W. x may be a
    channel slice of a wider NHWC buffer (``pixel_stride``)."""
    return _HStats.apply(x, a1, b1, w1)


# ---------------------------------------------------------------------------
# Full dense block
# ---------------------------------------------------------------------------

def _reference_into(*args, out: torch.Tensor) -> torch.Tensor:
    """``layer_reference`` written into ``out``: the plain buffer path."""
    return out.copy_(layer_reference(*args))


def _layer_core(layer, mode: str, layer_fn, stats_fn, x, a1, b1):
    """One dense layer after its folded norm1 (a1, b1): norm2's statistics
    (K2 in batch mode, the running ones otherwise), its fold, and the layer
    (K1). Returns ``(f, m2, v2)``: the statistics are outputs, not writes, so
    that a checkpoint's recompute records nothing twice."""
    w1 = layer.conv1.weight.reshape(INTER, -1).t()
    if mode == "batch":
        m2, v2 = stats_fn(x, a1, b1, w1)
    else:
        m2, v2 = layer.norm2.running_mean, layer.norm2.running_var
    a2, b2 = fold_bn(layer.norm2.weight, layer.norm2.bias, m2, v2)
    return layer_fn(x, a1, b1, w1, a2, b2, layer.conv2.weight.permute(2, 3, 1, 0)), m2, v2


def dense_block_fused(
    layers,
    x: torch.Tensor,
    mode: str = "batch",
    impl: str = "kernels",
    stats_out: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
    prefix: str = "",
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """A DenseNet block over NHWC x: ``layers`` are the block's DenseLayer
    modules (norm1, conv1, norm2, conv2). Returns ``(concat, stats)``: the
    concat of x and every layer's 32 new channels, and in batch mode its
    per-channel batch statistics ``(mean, var)`` (None in running mode),
    which the transition after the block reuses (``models/fdgan_fast.py``,
    as ``fdgan_fast._SegStats``).

    Where autograd records nothing (``torch.is_grad_enabled()`` is false, as
    under ``torch.inference_mode``, the serving path), the concat is one
    buffer of C0 + 32·L channels: x is copied into its first C0 channels once,
    each layer reads the channel slice before its own and writes its 32
    channels after it (``fused_dense_layer(out=...)``), and no layer copies
    the concat. With grad enabled (the train step) each layer's concat is a
    new tensor from ``torch.cat``: autograd saves every layer's input, and a
    later layer's write into a buffer those inputs were views of would bump
    the buffer's version and fail the backward.

    In batch mode, norm1's statistics are the per-channel statistics of the
    concat, kept per segment as it grows (channels partition, so each
    segment is reduced once: ``ops.stats.channel_stats``), and norm2's come
    from K2. With ``stats_out``,
    batch mode records every BN's (mean, unbiased var), detached, under
    ``{prefix}denselayerN.norm1`` / ``.norm2``, as ``pallas_dense.py:411-413``.
    ``impl='plain'`` runs the twins on any device. ``remat`` (with grad
    enabled) checkpoints each layer's core (``_layer_core``, as JAX
    ``fdgan_fast._dense_layer_fast`` wraps its core in ``jax.checkpoint``):
    the backward recomputes K2 and K1 from the layer's input."""
    if mode not in ("batch", "running"):
        raise ValueError(f"unknown BN mode {mode!r}")
    if impl == "kernels":
        layer_fn, stats_fn, seg_fn = fused_dense_layer, h_batch_stats, channel_stats
    elif impl == "plain":
        layer_fn, stats_fn, seg_fn = layer_reference, h_stats_reference, stats_reference
    else:
        raise ValueError(f"unknown impl {impl!r}")
    n = x.shape[0] * x.shape[1] * x.shape[2]
    buf = None
    if not torch.is_grad_enabled():
        c0 = x.shape[-1]
        buf = torch.empty(tuple(x.shape[:3]) + (c0 + GROWTH * len(layers),), device=x.device, dtype=x.dtype)
        buf[..., :c0] = x
        x = buf[..., :c0]
    if mode == "batch":
        mean_cat, var_cat = seg_fn(x)
    for i, layer in enumerate(layers):
        if mode == "batch":
            m1, v1 = mean_cat, var_cat
        else:
            m1, v1 = layer.norm1.running_mean, layer.norm1.running_var
        a1, b1 = fold_bn(layer.norm1.weight, layer.norm1.bias, m1, v1)
        if buf is None:
            core = functools.partial(_layer_core, layer, mode, layer_fn, stats_fn)
            f, m2, v2 = checkpoint(core, x, a1, b1, use_reentrant=False) if remat else core(x, a1, b1)
        else:
            c = x.shape[-1]
            f = buf[..., c:c + GROWTH]
            write = functools.partial(fused_dense_layer if impl == "kernels" else _reference_into, out=f)
            _, m2, v2 = _layer_core(layer, mode, write, stats_fn, x, a1, b1)
        if stats_out is not None and mode == "batch":
            key = f"{prefix}denselayer{i + 1}"
            stats_out[f"{key}.norm1"] = (m1.detach(), unbiased(v1.detach(), n))
            stats_out[f"{key}.norm2"] = (m2.detach(), unbiased(v2.detach(), n))
        if mode == "batch":
            mf, vf = seg_fn(f)
            mean_cat = torch.cat([mean_cat, mf])
            var_cat = torch.cat([var_cat, vf])
        x = torch.cat([x, f], dim=-1) if buf is None else buf[..., :c + GROWTH]
    return x, ((mean_cat, var_cat) if mode == "batch" else None)
