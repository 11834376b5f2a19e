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

The kernels run as the ``fdgan::dense_layer`` and ``fdgan::h_stats`` ops
(``ops/library.py``), which take the kernels' own operands: ``k1`` and
``k2`` lay x and the weights out for x's device and call them. Both
wrappers are differentiable, as the JAX ops are ``jax.custom_vjp``s
(``pallas_dense.py:247-262``, ``:293-307``): where autograd records,
they run ``fdgan::fused_dense_layer`` / ``fdgan::h_batch_stats`` over the
plain weights, whose backward is the VJP of the twin, recomputed from the
saved inputs. The JAX package has no backward kernel for either, so
neither has the port.

Under spatial sharding (``dist/halo_exchange.py``) a shard's K1 also takes
halo rows (``fused_dense_layer(halo=)``): the neighbouring shards' rows of
x above and below it, kept in x's buffer after its pixels
(``halo_buffer``), where the kernel computes g as at any pixel instead of
zero-padding it. Its backward is the twin's VJP with the same rows
(``layer_reference(halo=)``), which also gives the halo rows' cotangents.

``k1_launches`` and ``k2_launches`` count the kernel launches in this
process; the twins do not move them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fdgan_tpu_torch.dist import halo_exchange
from fdgan_tpu_torch.dist.stats import combine as global_stats
from fdgan_tpu_torch.nn.layers import unbiased
from fdgan_tpu_torch.ops import library  # noqa: F401  (registers the fdgan:: ops)
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


def layer_reference(x, a1, b1, w1, a2, b2, w2, halo=None) -> torch.Tensor:
    """Plain twin of K1, with its rounding points: t and g are rounded to
    x's dtype, h and f are accumulated in fp32, and g is zero-padded. The
    weights are rounded to x's dtype, as the kernel reads them. The convs
    run on fp32 copies, so bf16 operands multiply exactly.

    ``halo`` is K1's: (top, bottom), each None or the (B, 1, W, C) row of
    x's channels above (below) x's first (last) row, a neighbouring shard's
    under spatial sharding. g is computed on those rows like on x's and
    feeds the 3×3 conv there instead of its zero padding."""
    top, bottom = halo if halo is not None else (None, None)
    if top is not None or bottom is not None:
        x = torch.cat([r for r in (top, x, bottom) if r is not None], dim=1)
    t = _t(x, a1, b1).permute(0, 3, 1, 2)
    w1_oihw = w1.to(x.dtype).t().reshape(INTER, -1, 1, 1).float()
    h = F.conv2d(t.float(), w1_oihw)
    g = torch.relu(h * a2.float().view(1, -1, 1, 1) + b2.float().view(1, -1, 1, 1)).to(x.dtype)
    w2_oihw = w2.to(x.dtype).permute(3, 2, 0, 1).float()
    if top is None and bottom is None:
        f = F.conv2d(g.float(), w2_oihw, padding=1)
    else:  # the rows from the halo take the place of the H padding
        f = F.conv2d(F.pad(g.float(), (1, 1, int(top is None), int(bottom is None))), w2_oihw)
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


def _aligned(t: torch.Tensor) -> bool:
    """Whether t's first element lies on a 16-byte boundary, read from its
    offset in its storage (the allocators align storages to more): a
    traced tensor has no address. The CUDA ops check the address itself."""
    return t.storage_offset() * t.element_size() % 16 == 0


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
    if x.dtype == torch.bfloat16 and (c % 8 or ld % 8 or not _aligned(x)):
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
    if x.dtype == torch.bfloat16 and (ldo % 8 or not _aligned(out)):
        raise ValueError(f"bf16 out needs a pixel stride ldo % 8 == 0 and 16-byte alignment, got ldo={ldo}")
    return ldo


def halo_buffer(b: int, h: int, w: int, c: int, *, device, dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, top, bottom): an empty NHWC x (B, H, W, C) and its two halo rows
    (B, 1, W, C) each, in one buffer, the rows after x's B·H·W pixels with
    x's pixel stride, where K1 finds them (``fused_dense_layer(halo=)``).
    Channel slices of all three (``[..., c0:c1]``) are a halo'd x again."""
    flat = torch.empty((b * h * w + 2 * b * w, c), device=device, dtype=dtype)
    rows = flat[b * h * w:].view(2, b, 1, w, c)
    return flat[:b * h * w].view(b, h, w, c), rows[0], rows[1]


def _halo_rows(x, halo, ld: int) -> Tuple[int, int]:
    """K1's ``top`` and ``bot``: the pixel index from x of each halo row's
    first pixel, -1 for none. The rows must be (B, 1, W, C) views of x's
    buffer after its pixels, with its dtype and pixel stride
    (:func:`halo_buffer`); anything else raises."""
    bsz, h, w, c = x.shape
    esz = x.element_size()
    offsets = []
    for name, row in zip(("top", "bottom"), halo):
        if row is None:
            offsets.append(-1)
            continue
        if tuple(row.shape) != (bsz, 1, w, c) or row.dtype != x.dtype or row.device != x.device:
            raise ValueError(f"halo {name} must be {(bsz, 1, w, c)} {x.dtype} on {x.device}, got "
                             f"{tuple(row.shape)} {row.dtype} on {row.device}")
        gap = row.data_ptr() - x.data_ptr()
        same = row.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        if (not same or pixel_stride(row, f"halo {name}") != ld or gap < 0 or gap % (esz * ld)
                or gap // (esz * ld) < bsz * h * w):
            raise ValueError(f"halo {name} must lie in x's buffer after its pixels, with its pixel stride {ld} "
                             "(ops.dense.halo_buffer)")
        offsets.append(gap // (esz * ld))
    if (max(offsets) + bsz * w) * ld + c >= 2**31:
        raise ValueError("x and its halo rows are too large for the kernels' 32-bit pixel indices")
    return offsets[0], offsets[1]


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


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """Each fp32 element rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 mantissa bits, to nearest with ties away from zero, the 13 low bits
    of the result zero (subnormals alike; a value past tf32's largest
    rounds to inf; NaN stays NaN). torch has no tf32 dtype: the rounding is
    integer arithmetic on the bits, whose sign bit stands apart, so adding
    half of the dropped bits' range rounds the magnitude."""
    v = v.float()
    bits = v.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(v), v, rounded)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) = (tf32(v), tf32(v − big)), as the fp32 kernels split
    their operands for 3×TF32 products (``csrc/wgmma_tf32.cuh``): big + small
    holds v to ~2⁻²² of |v|."""
    big = tf32_round(v)
    return big, tf32_round(v.float() - big)


def w1_tf32x3_planes(w1: torch.Tensor) -> torch.Tensor:
    """W1 (C, 128) for the fp32 kernels: rows zero-padded to a multiple of
    32, each chunk of 32 channels as its tf32 big planes, then its small
    planes, (C32/32, 2, 8, 128, 4) with ``planes[c, part, p, n, e]`` the
    part of ``w1[32c + 8e + p, n]``. It is the shared-memory layout of the
    kernels' ``wgmma`` descriptors (K-major planes of four k) in the channel
    order that gives a thread eight consecutive channels
    (``csrc/wgmma_tf32.cuh``): a chunk is 32 contiguous KB, one bulk copy."""
    c, n = w1.shape
    c32 = -(-c // 32) * 32
    parts = torch.stack(tf32_split(F.pad(w1.float(), (0, 0, 0, c32 - c))))  # (2, C32, n)
    return parts.reshape(2, c32 // 32, 4, 8, n).permute(1, 0, 3, 4, 2).contiguous()


def w2_tf32x3_planes(w2: torch.Tensor) -> torch.Tensor:
    """W2 (3, 3, 128, 32), HWIO, for the fp32 K1: twelve chunks, one per
    kernel row dy and 32 channels kc of g (chunk 4·dy + kc), each as its tf32
    big planes then its small planes, (12, 2, 8, 96, 4) with
    ``planes[4dy + kc, part, p, 32dx + n, e]`` the part of
    ``w2[dy, dx, 32kc + 8e + p, n]``: the three taps dx of a kernel row side by
    side in N = 96, as the conv's products take them."""
    parts = torch.stack(tf32_split(w2)).reshape(2, 3, 3, 4, 4, 8, GROWTH)  # part, dy, dx, kc, e, p, n
    return parts.permute(1, 3, 0, 5, 2, 6, 4).reshape(12, 2, 8, 3 * GROWTH, 4).contiguous()


def _f32_operands(x, a1, b1, halo: bool = False):
    """x, a1, b1 as the fp32 kernels take them: a1 and b1 zero-padded to a
    multiple of 32 channels, and x as it is where C and its pixel stride are
    multiples of 4 and it is 16-byte aligned (its 16-byte loads), else a
    contiguous copy with C zero-padded to a multiple of 4; x with ``halo``
    rows raises there instead (the copy would leave its rows behind).
    Returns (x, a1, b1, C, ld) for the launch."""
    c, ld = x.shape[-1], pixel_stride(x)
    c32 = -(-c // 32) * 32
    a1k, b1k = (F.pad(_on_device(t, x, torch.float32).reshape(-1), (0, c32 - c)) for t in (a1, b1))
    if c % 4 or ld % 4 or not _aligned(x):
        if halo:
            raise ValueError(f"fp32 x with halo rows needs C and its pixel stride multiples of 4 and 16-byte "
                             f"alignment, got C={c}, ld={ld}")
        c4 = -(-c // 4) * 4
        x = F.pad(x, (0, c4 - c)).contiguous()
        c, ld = c4, c4
    return x, a1k, b1k, c, ld


def _on_device(t: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """A contiguous copy of ``t`` on x's device in ``dtype`` (a no-op when it
    already is one): the layouts the kernels read."""
    if t.device != x.device:
        raise ValueError(f"tensor on {t.device}, x on {x.device}")
    return t.to(dtype).contiguous()


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def check_stride(t: torch.Tensor, ld: int, name: str) -> None:
    """Raise unless ``t``'s pixel stride is ``ld``: an op gets the layout
    it was traced with, or fails."""
    got = pixel_stride(t, name)
    if got != ld:
        raise ValueError(f"{name} has pixel stride {got}, the op was given ld={ld}")


def _check_operand(t: torch.Tensor, x: torch.Tensor, dtype, numel: int, name: str) -> None:
    """A kernel reads ``t`` through a raw pointer: it must be a contiguous
    ``dtype`` tensor of ``numel`` elements on x's device."""
    if t.device != x.device or t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of {numel} elements on {x.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_address(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernels' vector loads)")


def _k1_operands(x, a1, b1, w1, a2, b2, w2, halo: bool = False):
    """(x, a1, b1, w1, a2, b2, w2) as ``fdgan::dense_layer`` takes them on
    x's device: on CUDA the fp32 kernel's (``_f32_operands``, W1 and W2 as
    tf32 big and small planes) or the bf16 kernel's (fp32 affines, W1 as
    ``w1_planes``, W2 as (3, 3, 32, 128), in bf16); on the CPU as they are,
    for the twin. Ordinary tensor ops: in an exported program they are part
    of the graph, where a compiler may fold them into constants."""
    if x.device.type != "cuda":
        return x, a1, b1, w1, a2, b2, w2
    a2k, b2k = (_on_device(t, x, torch.float32) for t in (a2, b2))
    if x.dtype == torch.float32:
        x, a1k, b1k, _, _ = _f32_operands(x, a1, b1, halo)
        return (x, a1k, b1k, w1_tf32x3_planes(_on_device(w1, x, torch.float32)), a2k, b2k,
                w2_tf32x3_planes(_on_device(w2, x, torch.float32)))
    a1k, b1k = (_on_device(t, x, torch.float32) for t in (a1, b1))
    return x, a1k, b1k, w1_planes(_on_device(w1, x, x.dtype)), a2k, b2k, _on_device(w2.permute(0, 1, 3, 2), x, x.dtype)


def _k2_operands(x, a1, b1, w1):
    """(x, a1, b1, w1) as ``fdgan::h_stats`` takes them on x's device: W1 as
    tf32 planes in fp32, as ``w1_tw1_planes`` in bf16 (as they are on the CPU)."""
    if x.device.type != "cuda":
        return x, a1, b1, w1
    if x.dtype == torch.float32:
        x, a1k, b1k, _, _ = _f32_operands(x, a1, b1)
        return x, a1k, b1k, w1_tf32x3_planes(_on_device(w1, x, torch.float32))
    a1k, b1k = (_on_device(t, x, torch.float32) for t in (a1, b1))
    return x, a1k, b1k, w1_tw1_planes(_on_device(w1, x, x.dtype))


def k1(x, a1, b1, w1, a2, b2, w2, out: Optional[torch.Tensor] = None, halo=None) -> torch.Tensor:
    """K1 through ``fdgan::dense_layer``: check the inputs, lay them out for
    x's device and run the op into ``out`` (a (B,H,W,32) tensor, possibly a
    channel slice of a wider buffer) or a new tensor, with x's ``halo`` rows
    (:func:`_halo_rows`) where given. Records nothing for autograd."""
    _check_inputs(x, a1, b1, w1)
    if tuple(w2.shape) != (3, 3, INTER, GROWTH):
        raise ValueError(f"w2 must be (3, 3, {INTER}, {GROWTH}), got {tuple(w2.shape)}")
    if a2.numel() != INTER or b2.numel() != INTER:
        raise ValueError(f"a2, b2 must have {INTER} entries")
    if out is None:
        out = torch.empty(tuple(x.shape[:3]) + (GROWTH,), device=x.device, dtype=x.dtype)
    ldo = _check_out(out, x)
    xk, a1k, b1k, w1k, a2k, b2k, w2k = _k1_operands(x, a1, b1, w1, a2, b2, w2, halo is not None)
    ld = pixel_stride(xk)
    top, bot = _halo_rows(xk, halo, ld) if halo is not None else (-1, -1)
    torch.ops.fdgan.dense_layer(xk, a1k, b1k, w1k, a2k, b2k, w2k, ld, top, bot, out, ldo)
    return out


def k2(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 through ``fdgan::h_stats``: norm2's (mean, biased var), fp32
    (128,) each. Records nothing for autograd."""
    _check_inputs(x, a1, b1, w1)
    xk, a1k, b1k, w1k = _k2_operands(x, a1, b1, w1)
    return torch.ops.fdgan.h_stats(xk, a1k, b1k, w1k, pixel_stride(xk))


def twin_into(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo) -> None:
    """``fdgan::dense_layer`` on the CPU: the twin written into ``out``, with
    the halo rows at pixel offsets ``top`` / ``bot`` from x read from x's
    buffer where the kernel reads them."""
    check_stride(x, ld, "x")
    check_stride(out, ldo, "out")
    bsz, _, w, c = x.shape
    rows = tuple(None if p < 0 else x.as_strided((bsz, 1, w, c), (w * ld, w * ld, ld, 1), x.storage_offset() + p * ld)
                 for p in (top, bot))
    out.copy_(layer_reference(x, a1, b1, w1, a2, b2, w2, halo=None if rows == (None, None) else rows))


def _launch_k1(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo) -> None:
    """``fdgan::dense_layer`` on CUDA: check the operands the op was given
    (layouts, sizes, addresses) and launch K1; raises on a CUDA error."""
    global k1_launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_layer runs its kernel on cuda, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES or out.dtype != x.dtype or out.device != x.device:
        raise TypeError(f"x and out must be float32 or bfloat16 on one device, got {x.dtype}, {out.dtype}")
    check_stride(x, ld, "x")
    check_stride(out, ldo, "out")
    bsz, h, w, c = x.shape
    f32 = x.dtype == torch.float32
    c32 = -(-c // 32) * 32
    for t, numel, name in ((a1, c32 if f32 else c, "a1"), (b1, c32 if f32 else c, "b1"), (a2, INTER, "a2"),
                           (b2, INTER, "b2")):
        _check_operand(t, x, torch.float32, numel, name)
    _check_operand(w1, x, x.dtype, 2 * c32 * INTER if f32 else c * INTER, "w1")
    _check_operand(w2, x, x.dtype, (2 if f32 else 1) * 9 * INTER * GROWTH, "w2")
    _check_address(x, "x")
    if not f32:  # the fp32 kernel stores f with scalar writes: any ldo, any address
        _check_address(out, "out")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    entry = f"fdgan_dense_layer_{_KERNEL_DTYPES[x.dtype]}"
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            x.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1.data_ptr(),
            a2.data_ptr(), b2.data_ptr(), w2.data_ptr(), out.data_ptr(),
            bsz, h, w, c, ld, ldo, top, bot, _stream(x),
        )
    build.check(lib, err, entry)
    k1_launches += 1


def _reduce_partials(part: torch.Tensor, npix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) in fp32 from K2's per-block sums of h and of h·h,
    reduced in float64: at 8×512² the count is 2.1 M, and E[h²]−μ² in fp32
    would lose the variance to cancellation."""
    mom = part.double().sum(dim=1).div_(npix)
    mom[1].addcmul_(mom[0], mom[0], value=-1.0).clamp_min_(0.0)
    mean, var = mom.float()
    return mean, var


def _launch_k2(x, a1, b1, w1, ld) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fdgan::h_stats`` on CUDA: launch K2 (its ``wgmma`` kernel: 3×TF32
    products in fp32, bf16 ones in bf16) and reduce its per-block partials;
    raises on a CUDA error and on operands it was not given."""
    global k2_launches
    if x.device.type != "cuda":
        raise ValueError(f"h_batch_stats runs its kernel on cuda, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_stride(x, ld, "x")
    c = x.shape[-1]
    f32 = x.dtype == torch.float32
    ck = -(-c // (32 if f32 else 64)) * (32 if f32 else 64)
    for t, name in ((a1, "a1"), (b1, "b1")):
        _check_operand(t, x, torch.float32, ck if f32 else c, name)
    _check_operand(w1, x, x.dtype, (2 if f32 else 1) * ck * INTER, "w1")
    _check_address(x, "x")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    npix = x.numel() // c
    entry = f"fdgan_h_stats_{_KERNEL_DTYPES[x.dtype]}"
    with torch.cuda.device(x.device):
        rows = getattr(lib, f"{entry}_blocks")(npix)  # one row per persistent block
        build.check(lib, -min(rows, 0), f"{entry}_blocks")
        part = torch.empty((2, rows, INTER), device=x.device, dtype=torch.float64)  # sums of h, of h·h
        err = getattr(lib, entry)(x.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1.data_ptr(),
                                  part[0].data_ptr(), part[1].data_ptr(), npix, c, ld, _stream(x))
    build.check(lib, err, entry)
    k2_launches += 1
    return _reduce_partials(part, npix)


def _launch_k2_mma(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's earlier bf16 body (``mma.sync`` fragments, one block per 192
    pixels, fp32 partials), kept so that one run can time it beside the
    ``wgmma`` kernel that ``h_batch_stats`` launches. No model path calls it
    and it moves no launch count."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the mma.sync body is bfloat16 only, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"h_batch_stats runs its kernel on cuda, got {x.device}")
    c, ldx = _check_inputs(x, a1, b1, w1)
    _check_address(x, "x")
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    npix = x.numel() // c
    with torch.cuda.device(x.device):
        a1k, b1k = (_on_device(t, x, torch.float32) for t in (a1, b1))
        w1k = _on_device(w1, x, x.dtype).t().contiguous()  # the mma.sync body stages W1 as (128, C)
        rows = -(-npix // lib.fdgan_h_stats_rows())  # one row per block of 192 pixels
        part = torch.empty((2, rows, INTER), device=x.device, dtype=torch.float32)
        err = lib.fdgan_h_stats_bf16_mma(x.data_ptr(), a1k.data_ptr(), b1k.data_ptr(), w1k.data_ptr(),
                                         part[0].data_ptr(), part[1].data_ptr(), npix, c, ldx, _stream(x))
    build.check(lib, err, "fdgan_h_stats_bf16_mma")
    return _reduce_partials(part, npix)


def tf32x3_selfcheck(a: torch.Tensor, b: torch.Tensor, reps: int = 1, blocks: int = 1) -> torch.Tensor:
    """(64, N) fp32 = reps · a · b for fp32 a (64, K) and b (K, N), N 96 or 128,
    K 32 or 64: one tile through the fp32 kernels' 3×TF32 helpers
    (``csrc/wgmma_tf32.cuh``: a split in registers into the A fragments of
    ``wgmma``, b as ``w1_tf32x3_planes`` lays it out). ``reps`` and ``blocks``
    repeat the product, per block and over blocks: a launch to time. No path
    runs it and it moves no launch count. The plain version (a float64
    product) on the CPU."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype} and {b.dtype}")
    k, n = b.shape
    if tuple(a.shape) != (64, k) or n not in (96, 128) or k not in (32, 64):
        raise ValueError(f"a (64, K) and b (K, N), N 96 or 128, K 32 or 64; got {tuple(a.shape)} and {tuple(b.shape)}")
    if reps < 1 or blocks < 1:
        raise ValueError(f"reps and blocks must be positive, got {reps} and {blocks}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return (reps * (a.double() @ b.double())).float()
    from fdgan_tpu_torch.ops import build

    lib = build.load()
    d = torch.empty((64, n), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        a = a.contiguous()
        planes = w1_tf32x3_planes(b)
        err = lib.fdgan_tf32x3_selfcheck(a.data_ptr(), planes.data_ptr(), d.data_ptr(), n, k, reps, blocks, _stream(a))
    build.check(lib, err, "fdgan_tf32x3_selfcheck")
    return d


def _layer_reference_halo(x, top, bottom, a1, b1, w1, a2, b2, w2) -> torch.Tensor:
    return layer_reference(x, a1, b1, w1, a2, b2, w2, halo=(top, bottom))


class _FusedLayerHalo(torch.autograd.Function):
    """K1 with halo rows, differentiable in x, in the rows and in the
    weights: the forward runs ``fdgan::dense_layer`` with the rows' offsets
    (the twin on the CPU), the backward is the twin's VJP with the rows. The
    op sees the rows only as offsets into x's buffer, so their gradient
    needs this Function of its own."""

    @staticmethod
    def forward(ctx, x, top, bottom, a1, b1, w1, a2, b2, w2):
        ctx.save_for_backward(x, top, bottom, a1, b1, w1, a2, b2, w2)
        return k1(x, a1, b1, w1, a2, b2, w2, halo=(top, bottom))

    @staticmethod
    def backward(ctx, ct):
        return twin_vjp(_layer_reference_halo, ctx, (ct,))


class _HaloPack(torch.autograd.Function):
    """The concat along channels of k parts of a halo'd x, with their halo
    rows, in one new ``halo_buffer``: (x, top, bottom) views of it. One
    autograd-recorded copy, as ``torch.cat``; the backward splits the
    cotangents by channels."""

    @staticmethod
    def forward(ctx, k: int, *parts):
        xs, tops, bottoms = parts[:k], parts[k:2 * k], parts[2 * k:]
        ctx.widths = [t.shape[-1] for t in xs]
        x, top, bottom = halo_buffer(*xs[0].shape[:3], sum(ctx.widths), device=xs[0].device, dtype=xs[0].dtype)
        for into, src in ((x, xs), (top, tops), (bottom, bottoms)):
            torch.cat(src, dim=-1, out=into)
        return x, top, bottom

    @staticmethod
    def backward(ctx, ct_x, ct_top, ct_bottom):
        return (None,) + tuple(p for ct in (ct_x, ct_top, ct_bottom) for p in ct.split(ctx.widths, dim=-1))


def _records(*tensors) -> bool:
    """Whether autograd would record an op on these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_dense_layer(x, a1, b1, w1, a2, b2, w2, out: Optional[torch.Tensor] = None, halo=None) -> torch.Tensor:
    """One fused dense layer (differentiable): x (B,H,W,C) → f (B,H,W,32)
    in x's dtype.

    a1, b1 (C) and a2, b2 (128) are the folded norm1 and norm2 affines,
    w1 (C, 128), w2 (3, 3, 128, 32). x may be a channel slice of a wider
    NHWC buffer (``pixel_stride``). With ``out``, a (B,H,W,32) tensor that
    may be such a slice too, f is written into it and ``out`` is returned:
    a write in place, which autograd cannot record, so it raises where
    autograd would record the call.

    ``halo`` (top, bottom) gives the rows of x's channels just above and
    below x, from the neighbouring shards of a spatially sharded image,
    each None at an end of the image (g = 0 there, as without ``halo``):
    (B, 1, W, C) views in x's buffer after its pixels (:func:`halo_buffer`).
    K1 reads them where its tiles' halo ring leaves x. Without ``out`` the
    call is differentiable in x, the rows and the weights (the twin's VJP,
    ``layer_reference(halo=)``).

    Where autograd records the call, it runs ``fdgan::fused_dense_layer``
    (the twin's VJP over the plain weights); otherwise ``fdgan::dense_layer``
    on the operands laid out for x's device (:func:`k1`), which is what an
    exported program holds."""
    if halo is not None and all(r is None for r in halo):
        halo = None
    rows = () if halo is None else tuple(halo)
    if out is not None:
        if _records(x, a1, b1, w1, a2, b2, w2, out, *rows):
            raise RuntimeError("fused_dense_layer(out=...) writes in place, which autograd cannot record: "
                               "call it under torch.no_grad() or torch.inference_mode()")
        return k1(x, a1, b1, w1, a2, b2, w2, out=out, halo=halo)
    if halo is not None:
        return _FusedLayerHalo.apply(x, halo[0], halo[1], a1, b1, w1, a2, b2, w2)
    if _records(x, a1, b1, w1, a2, b2, w2):
        return torch.ops.fdgan.fused_dense_layer(x, a1, b1, w1, a2, b2, w2)
    return k1(x, a1, b1, w1, a2, b2, w2)


def h_batch_stats(x, a1, b1, w1) -> Tuple[torch.Tensor, torch.Tensor]:
    """norm2's batch statistics (differentiable): per-channel fp32 (mean,
    biased var) of h = relu(a1·x + b1)·W1 over B, H and W. x may be a
    channel slice of a wider NHWC buffer (``pixel_stride``). Where autograd
    records the call, ``fdgan::h_batch_stats``; else ``fdgan::h_stats``
    (:func:`k2`)."""
    if _records(x, a1, b1, w1):
        return torch.ops.fdgan.h_batch_stats(x, a1, b1, w1)
    return k2(x, a1, b1, w1)


# ---------------------------------------------------------------------------
# Full dense block
# ---------------------------------------------------------------------------

def _reference_into(*args, out: torch.Tensor, halo=None) -> torch.Tensor:
    """``layer_reference`` written into ``out``: the plain buffer path."""
    return out.copy_(layer_reference(*args, halo=halo))


def _layer_core(layer, mode: str, layer_fn, stats_fn, x, a1, b1, *halo):
    """One dense layer after its folded norm1 (a1, b1): norm2's statistics
    (K2 in batch mode, the running ones otherwise), its fold, and the layer
    (K1, with x's ``halo`` rows (top, bottom) where given: arguments, so
    that a checkpoint's recompute gets the rows of its own recomputed
    buffer). Returns ``(f, m2, v2)``: the statistics are outputs, not
    writes, so that a checkpoint's recompute records nothing twice."""
    w1 = layer.conv1.weight.reshape(INTER, -1).t()
    if mode == "batch":
        m2, v2, _ = global_stats(*stats_fn(x, a1, b1, w1), x.shape[0] * x.shape[1] * x.shape[2])
    else:
        m2, v2 = layer.norm2.running_mean, layer.norm2.running_var
    a2, b2 = fold_bn(layer.norm2.weight, layer.norm2.bias, m2, v2)
    kw = {"halo": halo} if halo else {}
    return layer_fn(x, a1, b1, w1, a2, b2, layer.conv2.weight.permute(2, 3, 1, 0), **kw), m2, v2


def dense_block_fused(
    layers,
    x: torch.Tensor,
    mode: str = "batch",
    impl: str = "kernels",
    stats_out: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
    prefix: str = "",
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[tuple]]:
    """A DenseNet block over NHWC x: ``layers`` are the block's DenseLayer
    modules (norm1, conv1, norm2, conv2). Returns ``(concat, stats)``: the
    concat of x and every layer's 32 new channels, and in batch mode its
    per-channel batch statistics ``(mean, var, n)`` with their count of
    pixels (None in running mode), which the transition after the block
    reuses (``models/fdgan_fast.py``, as ``fdgan_fast._SegStats``).

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
    from K2. Inside a data-parallel step each segment's statistics and K2's
    are combined over the ranks where they are made
    (``dist.stats.combine``; the concatenations combine nothing), and n is
    the global count. With ``stats_out``,
    batch mode records every BN's (mean, unbiased var), detached, under
    ``{prefix}denselayerN.norm1`` / ``.norm2``, as ``pallas_dense.py:411-413``.
    ``impl='plain'`` runs the twins on any device. ``remat`` (with grad
    enabled) checkpoints each layer's core (``_layer_core``, as JAX
    ``fdgan_fast._dense_layer_fast`` wraps its core in ``jax.checkpoint``):
    the backward recomputes K2 and K1 from the layer's input.

    With H sharded (``dist.halo_exchange.spatial_sharding``) the buffer
    also holds the row above and the row below x from the neighbouring
    shards (``halo_buffer``): the block input's boundary rows are exchanged
    once, then each layer's 32 new channels (but the last layer's, which no
    3×3 conv reads), and each K1 reads its slice of those rows as its halo.
    The statistics take x alone. With grad enabled each layer's concat is a
    new ``halo_buffer`` with its rows (``_HaloPack``, one copy, as
    ``torch.cat``), the exchanges are differentiable
    (``halo_exchange.halo_rows``) and K1 with its rows too; under ``remat``
    the recompute of a layer's core re-issues its K2 statistics'
    all-reduce, and no exchange."""
    if mode not in ("batch", "running"):
        raise ValueError(f"unknown BN mode {mode!r}")
    shard = halo_exchange.current()
    if impl == "kernels":
        layer_fn, stats_fn, seg_fn = fused_dense_layer, h_batch_stats, channel_stats
    elif impl == "plain":
        layer_fn, stats_fn, seg_fn = layer_reference, h_stats_reference, stats_reference
    else:
        raise ValueError(f"unknown impl {impl!r}")
    npix = x.shape[0] * x.shape[1] * x.shape[2]  # every segment's pixels on this rank
    n = npix  # and over the ranks of a data-parallel step (dist/stats.py)
    buf = rows = None
    sharded_grad = shard is not None and torch.is_grad_enabled()
    if not torch.is_grad_enabled():
        c0 = x.shape[-1]
        width = c0 + GROWTH * len(layers)
        if shard is None:
            buf = torch.empty(tuple(x.shape[:3]) + (width,), device=x.device, dtype=x.dtype)
        else:
            buf, top, bottom = halo_buffer(*x.shape[:3], width, device=x.device, dtype=x.dtype)
            # the rows this rank has neighbours for: K1 sets g to 0 on the others
            rows = (top if shard.prev is not None else None, bottom if shard.next is not None else None)
        buf[..., :c0] = x
        x = buf[..., :c0]
        if shard is not None:
            halo_exchange.exchange_rows(x, top[..., :c0], bottom[..., :c0], shard)
    if mode == "batch":
        mean_cat, var_cat, n = global_stats(*seg_fn(x), npix)
    if sharded_grad:
        x, top, bottom = _HaloPack.apply(1, x, *halo_exchange.halo_rows(x, 1, 1, shard=shard))
    for i, layer in enumerate(layers):
        if mode == "batch":
            m1, v1 = mean_cat, var_cat
        else:
            m1, v1 = layer.norm1.running_mean, layer.norm1.running_var
        a1, b1 = fold_bn(layer.norm1.weight, layer.norm1.bias, m1, v1)
        if buf is None:
            # with H sharded, the rows this rank has neighbours for: g is 0 on the others
            args = (x, a1, b1) + ((top if shard.prev is not None else None,
                                   bottom if shard.next is not None else None) if sharded_grad else ())
            core = functools.partial(_layer_core, layer, mode, layer_fn, stats_fn)
            f, m2, v2 = checkpoint(core, *args, use_reentrant=False) if remat else core(*args)
        else:
            c = x.shape[-1]
            f = buf[..., c:c + GROWTH]
            halo = None if rows is None else tuple(None if r is None else r[..., :c] for r in rows)
            write = functools.partial(fused_dense_layer if impl == "kernels" else _reference_into, out=f, halo=halo)
            _, m2, v2 = _layer_core(layer, mode, write, stats_fn, x, a1, b1)
            if shard is not None and i + 1 < len(layers):
                halo_exchange.exchange_rows(f, top[..., c:c + GROWTH], bottom[..., c:c + GROWTH], shard)
        if stats_out is not None and mode == "batch":
            key = f"{prefix}denselayer{i + 1}"
            stats_out[f"{key}.norm1"] = (m1.detach(), unbiased(v1.detach(), n))
            stats_out[f"{key}.norm2"] = (m2.detach(), unbiased(v2.detach(), n))
        if mode == "batch":
            mf, vf, _ = global_stats(*seg_fn(f), npix)
            mean_cat = torch.cat([mean_cat, mf])
            var_cat = torch.cat([var_cat, vf])
        if buf is not None:
            x = buf[..., :c + GROWTH]
        elif sharded_grad and i + 1 < len(layers):
            f_top, f_bottom = halo_exchange.halo_rows(f, 1, 1, shard=shard)
            x, top, bottom = _HaloPack.apply(2, x, f, top, f_top, bottom, f_bottom)
        else:
            x = torch.cat([x, f], dim=-1)
    return x, ((mean_cat, var_cat, n) if mode == "batch" else None)
