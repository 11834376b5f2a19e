"""The port's CUDA kernels, serving path, train step and kernel probes on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. The module imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import copy
import json

import numpy as np
import pytest
import torch

from fdgan_tpu_torch.losses.composite import LossWeights
from fdgan_tpu_torch.models import fdgan_fast
from fdgan_tpu_torch.models.densenet import DenseBlock
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.nn import layers
from fdgan_tpu_torch.ops import dense, filters, freq, probes, stats
from fdgan_tpu_torch.ops import window_attention as wattn
from fdgan_tpu_torch.serve import InferenceEngine
from fdgan_tpu_torch.tools import probes as probe_tool
from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

pytestmark = pytest.mark.cuda

K1_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_pallas_dense.py:52
# bf16: kernel and twin round t, g and f at the same points; fp32 sums in
# another order can move a value by one bf16 step (2^-8 relative)
K1_TOL_BF16 = dict(atol=1e-2, rtol=1.6e-2)
# K3 and its plain version normalise in x's dtype and sum in fp32 in the same
# order without fused multiply-adds; fp32 is held at the JAX suite's atol
# (tests/test_pallas_filters.py:17), bf16 at one bf16 step (2^-8 relative)
K3_TOL = {torch.float32: dict(atol=2e-4, rtol=0), torch.bfloat16: dict(atol=2.0**-8, rtol=2.0**-8)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def exact():
    """fp32 references without TF32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


def _layer_args(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    args = [
        rng.uniform(size=shape),
        rng.uniform(0.5, 1.5, c),
        rng.normal(0, 0.3, c),
        rng.standard_normal((c, 128)) / np.sqrt(c),
        rng.uniform(0.5, 1.5, 128),
        rng.normal(0, 0.3, 128),
        rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128),
    ]
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in args]
    for i in (0, 3, 6):  # x, w1, w2 in the kernel's dtype; affines stay fp32
        out[i] = out[i].to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 10, 17, 40), (2, 24, 40, 992)])
def test_kernels_match_twins(cuda, exact, shape, dtype):
    args = _layer_args(shape, 6, cuda, dtype)
    dense.reset_launch_counts()
    f = dense.fused_dense_layer(*args)
    m, v = dense.h_batch_stats(*args[:4])
    torch.cuda.synchronize()
    assert (dense.k1_launches, dense.k2_launches) == (1, 1)
    ref = dense.layer_reference(*args)
    torch.testing.assert_close(f.float(), ref.float(), **(K1_TOL if dtype == torch.float32 else K1_TOL_BF16))
    mr, vr = dense.h_stats_reference(*args[:4])
    torch.testing.assert_close(m, mr, atol=1e-4, rtol=1e-4)  # test_pallas_dense.py:67-68
    torch.testing.assert_close(v, vr, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", [
    (2, 16, 24, 64), (1, 10, 17, 40), (2, 24, 40, 992),   # the shapes above
    (1, 5, 7, 64),      # smaller than one 8x16 tile
    (1, 37, 53, 96),    # neither H nor W a multiple of the tile, C not a multiple of a 64-channel step
    (2, 64, 64, 128),   # more tiles than one round of the persistent blocks' first tiles
])
def test_k1_wgmma_matches_twin_and_mma_body(cuda, shape):
    """K1's bf16 kernel (wgmma) against its twin, the same bits on every
    launch. (Its mma.sync body, which it was also held against, is gone.)"""
    args = _layer_args(shape, 6, cuda, torch.bfloat16)
    dense.reset_launch_counts()
    got = dense.fused_dense_layer(*args)
    torch.cuda.synchronize()
    assert dense.k1_launches == 1
    torch.testing.assert_close(got.float(), dense.layer_reference(*args).float(), **K1_TOL_BF16)
    assert torch.equal(got, dense.fused_dense_layer(*args))  # no race: the same bits every launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,shards", [((2, 40, 24, 64), [16, 8, 16]), ((1, 24, 40, 96), [8, 16])])
def test_k1_with_halo_rows_is_k1_on_the_whole_image(cuda, exact, shape, shards, dtype):
    """K1 on shards of whole 8-row tiles, each with its neighbours' rows
    (ops.dense.halo_buffer), gives the bits of K1 on the whole image, and
    stays within the twin's tolerance (the twin with the same halo rows)."""
    args = _layer_args(shape, 9, cuda, dtype)
    x, rest = args[0], args[1:]
    b, h, w, c = shape
    whole = dense.fused_dense_layer(x, *rest)
    parts, start = [], 0
    with torch.inference_mode():
        for n in shards:
            xs, top, bottom = dense.halo_buffer(b, n, w, c, device=cuda, dtype=dtype)
            xs.copy_(x[:, start:start + n])
            top.copy_(x[:, max(start - 1, 0):max(start, 1)])
            bottom.copy_(x[:, min(start + n, h - 1):min(start + n, h - 1) + 1])
            halo = (top if start > 0 else None, bottom if start + n < h else None)
            got = dense.fused_dense_layer(xs, *rest, halo=halo)
            torch.testing.assert_close(got.float(), dense.layer_reference(xs, *rest, halo=halo).float(),
                                       **(K1_TOL if dtype == torch.float32 else K1_TOL_BF16))
            parts.append(got)
            start += n
    assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bands", [((2, 40, 24, 3), [16, 8, 16]), ((1, 64, 200, 3), [24, 40])])
def test_k3_with_halo_rows_is_k3_on_the_whole_image(cuda, exact, shape, bands, dtype):
    """K3's halo variant on bands of rows, each with its neighbours' 7 rows
    a side (none at the image's ends, where it reflects), gives the bits of
    K3 on the whole image, and its twin's within K3_TOL."""
    x = torch.tensor(np.random.default_rng(12).uniform(size=shape), dtype=dtype, device=cuda)
    h = shape[1]
    whole = freq.frequency_fuse(x)
    parts, start = [], 0
    for n in bands:
        halo = (x[:, start - 7:start] if start else None, x[:, start + n:start + n + 7] if start + n < h else None)
        xs = x[:, start:start + n].contiguous()
        got = freq.frequency_fuse(xs, halo=halo)
        torch.testing.assert_close(got.float(), filters.frequency_fuse(xs, halo=halo).float(), **K3_TOL[dtype])
        parts.append(got)
        start += n
    assert torch.equal(torch.cat(parts, dim=1), whole)


def _buffer_view(x, ld):
    """x as the first C channels of a (B, H, W, ld) buffer, and the 32 after them."""
    c = x.shape[-1]
    buf = torch.full(tuple(x.shape[:3]) + (ld,), 3.0, device=x.device, dtype=x.dtype)
    buf[..., :c] = x
    return buf, buf[..., :c], buf[..., c:c + 32]


# chip_smoke.SHAPES: a layer per dense block of the 8x512^2 serving path, a ragged
# C and a ragged W, and the 4x256^2 train path's blocks
SHAPES = [(8, 512, 512, 64), (8, 256, 256, 128), (8, 128, 128, 256), (8, 128, 128, 992), (8, 120, 200, 64),
          (4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256), (4, 64, 64, 992)]


@pytest.mark.parametrize("shape", SHAPES + [(1, 5, 7, 96), (1, 37, 53, 544), (3, 17, 29, 32)])
def test_k2_wgmma_matches_twin_and_mma_body(cuda, shape):
    """K2's bf16 kernel (wgmma) against its twin and its mma.sync body, at
    the tolerances of test_pallas_dense.py:67-68 (the bodies sum the same fp32
    products in other orders); from a buffer view and on a second launch the
    same bits: the addresses change, not the arithmetic, and the tile walk is
    static. C = 544 and 992 bring W1 past its resident 512 channels in through
    the ring; C = 96 and 544 end in a half chunk; 5x7 and 17x29 images end in
    a partial tile."""
    args = _layer_args(shape, 8, cuda, torch.bfloat16)[:4]
    dense.reset_launch_counts()
    m, v = dense.h_batch_stats(*args)
    assert dense.k2_launches == 1
    mo, vo = dense._launch_k2_mma(*args)
    assert dense.k2_launches == 1  # the old body moves no count
    mr, vr = dense.h_stats_reference(*args)
    for mean, var in ((mr, vr), (mo, vo)):
        torch.testing.assert_close(m, mean, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(v, var, atol=1e-4, rtol=1e-3)
    _, xv, _ = _buffer_view(args[0], max(256, shape[-1] + 32))
    for got in (dense.h_batch_stats(xv, *args[1:]), dense.h_batch_stats(*args)):
        assert torch.equal(got[0], m) and torch.equal(got[1], v)


@pytest.mark.parametrize("shape", [
    (2, 16, 24, 64), (1, 10, 17, 40), (2, 24, 40, 992),   # test_kernels_match_twins' shapes
    (1, 5, 7, 64),      # smaller than one 8x16 tile
    (1, 37, 53, 96),    # neither H nor W a multiple of the tile, C three chunks of 32
    (2, 64, 64, 128),   # more tiles than one round of the persistent blocks' first tiles
])
def test_f32_kernels_match_twins_and_repeat_their_bits(cuda, exact, shape):
    """fp32 K1 and K2 (3xTF32 products on wgmma) against their twins in
    full fp32, at the JAX suite's fp32 tolerances; a second launch and a
    launch from a buffer view give the same bits (static tile walks; the
    addresses change, not the arithmetic)."""
    args = _layer_args(shape, 6, cuda, torch.float32)
    dense.reset_launch_counts()
    f = dense.fused_dense_layer(*args)
    m, v = dense.h_batch_stats(*args[:4])
    torch.cuda.synchronize()
    assert (dense.k1_launches, dense.k2_launches) == (1, 1)
    torch.testing.assert_close(f, dense.layer_reference(*args), **K1_TOL)
    mr, vr = dense.h_stats_reference(*args[:4])
    torch.testing.assert_close(m, mr, atol=1e-4, rtol=1e-4)  # test_pallas_dense.py:67-68
    torch.testing.assert_close(v, vr, atol=1e-4, rtol=1e-3)
    assert torch.equal(dense.fused_dense_layer(*args), f)
    again = dense.h_batch_stats(*args[:4])
    assert torch.equal(again[0], m) and torch.equal(again[1], v)
    _, xv, out = _buffer_view(args[0], shape[-1] + 64)
    with torch.inference_mode():
        dense.fused_dense_layer(xv, *args[1:], out=out)
    view = dense.h_batch_stats(xv, *args[1:4])
    assert torch.equal(out, f) and torch.equal(view[0], m) and torch.equal(view[1], v)


@pytest.mark.parametrize("c,ld", [(20, 52), (20, 53), (21, 53), (36, 70)])
def test_f32_kernels_take_any_c_and_pixel_stride(cuda, exact, c, ld):
    """fp32 inputs that the kernels' 16-byte loads cannot take as they are:
    C = 20 in a buffer of ld 52 goes to the kernels directly; an odd ld, or
    C % 4 != 0, makes the wrapper pad x to C % 4 == 0. Against the twins, and
    from and into the buffer (ld 53: an odd ldo, stored element by element)
    the bits of the contiguous launch, nothing else of the buffer written."""
    args = _layer_args((2, 19, 37, c), 15, cuda, torch.float32)
    f = dense.fused_dense_layer(*args)
    m, v = dense.h_batch_stats(*args[:4])
    torch.testing.assert_close(f, dense.layer_reference(*args), **K1_TOL)
    mr, vr = dense.h_stats_reference(*args[:4])
    torch.testing.assert_close(m, mr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(v, vr, atol=1e-4, rtol=1e-3)
    buf, xv, out = _buffer_view(args[0], ld)
    before = buf.clone()
    dense.reset_launch_counts()
    with torch.inference_mode():
        dense.fused_dense_layer(xv, *args[1:], out=out)
    view = dense.h_batch_stats(xv, *args[1:4])
    torch.cuda.synchronize()
    assert (dense.k1_launches, dense.k2_launches) == (1, 1)
    assert torch.equal(out, f) and torch.equal(view[0], m) and torch.equal(view[1], v)
    assert torch.equal(buf[..., :c], before[..., :c]) and torch.equal(buf[..., c + 32:], before[..., c + 32:])


def test_k2_mma_body_is_bf16_only(cuda):
    args = _layer_args((1, 8, 8, 32), 7, cuda, torch.float32)
    with pytest.raises(TypeError, match="bfloat16 only"):
        dense._launch_k2_mma(*args[:4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 37, 53, 96), (2, 24, 40, 992)])
def test_k1_into_a_buffer_slice_is_bit_exact(cuda, shape, dtype):
    """K1 reading x as a channel slice of a buffer and writing its 32
    channels after it: the bits of the contiguous launch, and nothing else of
    the buffer written."""
    args = _layer_args(shape, 9, cuda, dtype)
    want = dense.fused_dense_layer(*args)
    buf, xv, out = _buffer_view(args[0], shape[-1] + 64)
    before = buf.clone()
    with torch.inference_mode():
        dense.fused_dense_layer(xv, *args[1:], out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    c = shape[-1]
    assert torch.equal(buf[..., :c], before[..., :c]) and torch.equal(buf[..., c + 32:], before[..., c + 32:])


def test_wgmma_selfcheck_on_the_card(cuda):
    """One tile through the descriptor helper and the three wgmma shapes against
    torch.matmul, at the row offsets a conv tap produces, padded planes and
    unpadded; and the rate launch, which repeats the product."""
    assert probe_tool.wgmma_selfcheck(device=cuda) <= 1e-3
    rows = probe_tool.wgmma_rates()
    assert [(r["wgmma"], r["warpgroups_per_sm"]) for r in rows] == [(f"m64n{n}k16", w) for n in (32, 96, 128) for w in (1, 2, 3)]
    assert all(r["ns"] > 0 and 0 < r["tflops"] < 1200 for r in rows)


@pytest.mark.parametrize("n", [96, 128])
@pytest.mark.parametrize("k", [32, 64])
def test_tf32x3_selfcheck_on_the_card(cuda, n, k):
    """One tile through the fp32 kernels' 3xTF32 helpers against a float64
    product: within 3xTF32's error (~2^-21 of each product; one tf32
    product would be ~2^-11), so the fragment layout, the channel order and
    the weight planes agree; and the rate launch, which repeats it."""
    rng = np.random.default_rng(n + k)
    a = torch.tensor(rng.standard_normal((64, k)), dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32, device=cuda)
    want = a.double() @ b.double()
    got = dense.tf32x3_selfcheck(a, b)
    assert (got.double() - want).abs().max().item() <= 2.0**-18 * (a.double().abs() @ b.double().abs()).max().item()
    again = dense.tf32x3_selfcheck(a, b, reps=5, blocks=3)
    torch.testing.assert_close(again.double(), 5 * want, rtol=1e-5, atol=1e-4)


def test_tf32x3_rates_on_the_card(cuda):
    rows = probe_tool.tf32x3_rates()
    assert [(r["tf32x3"], r["warpgroups_per_sm"]) for r in rows] == [
        (f"m64n{n}k8 x3", w) for n in (96, 128) for w in (1, 2, 3)]
    assert all(r["ns"] > 0 and 0 < r["tflops"] < 200 for r in rows)


def test_wrappers_reject_bad_inputs(cuda):
    x, a1, b1, w1, a2, b2, w2 = _layer_args((1, 8, 8, 32), 7, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        dense.fused_dense_layer(x.transpose(1, 2), a1, b1, w1, a2, b2, w2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dense.h_batch_stats(x.half(), a1, b1, w1)
    with pytest.raises(ValueError, match="w1"):
        dense.h_batch_stats(x, a1, b1, w1[:, :64])
    with pytest.raises(ValueError, match="C % 8"):
        dense.h_batch_stats(x[..., :28].contiguous().bfloat16(), a1[:28], b1[:28], w1[:28].bfloat16())
    with pytest.raises(ValueError, match="x on cuda"):
        dense.fused_dense_layer(x, a1.cpu(), b1, w1, a2, b2, w2)


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_generator_buffer_path_matches_cat_path(cuda, exact, mode):
    """The generator with each dense block's concat in one buffer
    (inference_mode) against the same forward with grad enabled, where every
    layer concatenates: the same kernels on the same values, addressed
    differently."""
    model = FDGAN(device=cuda, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(2).uniform(size=(2, 40, 56, 3)), dtype=torch.float32, device=cuda)
    with torch.inference_mode():
        buffered = model(x, bn_mode=mode)
    concatenated = model(x, bn_mode=mode).detach()
    torch.testing.assert_close(buffered, concatenated, atol=5e-4, rtol=1e-3)  # test_pallas_dense.py:132


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_generator_kernels_match_plain(cuda, exact, mode):
    model = FDGAN(device=cuda, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(1).uniform(size=(2, 32, 48, 3)), dtype=torch.float32, device=cuda)
    dense.reset_launch_counts()
    with torch.inference_mode():
        got = model(x, bn_mode=mode)
        ref = model(x, bn_mode=mode, impl="plain")
    assert (dense.k1_launches, dense.k2_launches) == (42, 42 if mode == "batch" else 0)
    torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)  # test_pallas_dense.py:132


@pytest.mark.parametrize("shape,ld,c0", [
    ((1, 64, 64, 32), None, 0),      # a dense layer's output alone
    ((1, 64, 64, 32), 256, 96),      # the same channels as a slice of block 1's concat
    ((2, 32, 32, 32), 1024, 992),    # block 3's last slice, the widest pixel stride
    ((1, 64, 64, 64), 256, 0),       # block 1's input at the front of its buffer
    ((2, 16, 24, 256), None, 0),     # block 3's input: one window of 256 channels
    ((1, 9, 13, 992), None, 0),      # four windows, the last of 224 channels; a ragged pixel count
    ((3, 17, 29, 40), 48, 8),        # 5 channel groups (not a power of two), a ragged tail tile
    ((1, 1, 1, 512), None, 0),       # a U-Net's innermost BN at batch 1: one pixel
    ((1, 2, 2, 512), None, 0),       # DenseG's decoder and unetg's innermost: four pixels
])
def test_channel_stats_matches_twin(cuda, shape, ld, c0):
    """The kernel against its twin (the one-pass formula in fp32 on the
    card): mean at test_pallas_dense.py:67's tolerance, var at :68's; the
    kernel's float64 partials are the more exact. From a buffer slice and on
    a second launch the same bits."""
    x = torch.tensor(np.random.default_rng(13).standard_normal(shape) * 1.5 + 0.7, device=cuda).bfloat16()
    if ld is not None:
        buf = torch.full(tuple(shape[:3]) + (ld,), 5.0, device=cuda, dtype=torch.bfloat16)
        buf[..., c0:c0 + shape[-1]] = x
        x = buf[..., c0:c0 + shape[-1]]
    stats.reset_launch_count()
    mean, var = stats.channel_stats(x)
    torch.cuda.synchronize()
    assert stats.launches == 1 and mean.shape == var.shape == (shape[-1],)
    mr, vr = stats.one_pass_reference(x)
    torch.testing.assert_close(mean, mr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(var, vr, atol=1e-4, rtol=1e-3)
    again = stats.channel_stats(x.contiguous())
    assert torch.equal(again[0], mean) and torch.equal(again[1], var)


@pytest.mark.parametrize("shape", [(1, 20, 64, 64), (4, 20, 3, 5)])
def test_batch_stats_pads_channels_to_eight_on_the_card(cuda, shape):
    """A bf16 BN input whose C is not a multiple of 8 (DCPDN's batchnorm20):
    batch_stats sends it to the kernel zero-padded to 24 channels and drops
    the padding's statistics; against the plain statistics at
    test_channel_stats_matches_twin's tolerances."""
    x = torch.tensor(np.random.default_rng(14).standard_normal(shape) * 1.5 + 0.7, device=cuda).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    stats.reset_launch_count()
    mean, var = layers.batch_stats(x)
    torch.cuda.synchronize()
    assert stats.launches == 1 and mean.shape == var.shape == (shape[1],)
    mr, vr = layers.batch_stats(x, impl="plain")
    torch.testing.assert_close(mean, mr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(var, vr, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("shape,ld,c0", [
    ((2, 31, 31, 32), 256, 96),      # a dense layer's slice of block 1's concat
    ((1, 31, 31, 512), None, 0),     # D's last BatchNorm input: two windows, a ragged pixel count
])
def test_channel_stats_gradient_on_the_card(cuda, shape, ld, c0):
    """The closed-form backward, computed in fp32 and stored in bf16 by one
    elementwise kernel, against the exact VJP in float64 (one bf16 rounding,
    2^-8, plus fp32's error on b + a·x) and against the twin's VJP by
    autograd, which rounds its two terms before it adds them
    (tests/test_torch_stats.py states both bounds)."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.standard_normal(shape) * 1.5 + 0.7, device=cuda).bfloat16()
    if ld is not None:
        buf = torch.zeros(tuple(shape[:3]) + (ld,), device=cuda, dtype=torch.bfloat16)
        buf[..., c0:c0 + shape[-1]] = x
        x = buf[..., c0:c0 + shape[-1]]
    cm, cv = (torch.tensor(rng.standard_normal(shape[-1]), device=cuda, dtype=torch.float32) for _ in range(2))
    xg, xt = x.detach().clone().requires_grad_(True), x.detach().clone().requires_grad_(True)
    mean, var = stats.channel_stats(xg)
    (mean * cm + var * cv).sum().backward()
    m, v = stats.one_pass_reference(xt)
    (m * cm + v * cv).sum().backward()
    assert xg.grad.dtype == torch.bfloat16
    n = x.numel() // shape[-1]
    xd, md = x.double(), mean.detach().double()
    exact = cm.double() / n + cv.double() * 2 * (xd - md) / n
    torch.testing.assert_close(xg.grad.double(), exact, rtol=2.0**-8, atol=2.0**-16 * exact.abs().max().item())
    terms = ((cm.double() - 2 * cv.double() * md).abs().max() + (2 * cv.double() * xd).abs().max()).item() / n
    torch.testing.assert_close(xg.grad.double(), xt.grad.double(), rtol=2.0**-7, atol=2.0**-8 * terms)


def test_channel_stats_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 8"):
        stats.channel_stats(x[..., :28])
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        stats.channel_stats(x.transpose(1, 2))
    nchw = torch.zeros(1, 32, 8, 8, device=cuda, dtype=torch.bfloat16)  # not channels_last: no quiet copy
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        layers.batch_stats(nchw)
    assert torch.equal(stats.channel_stats(x.float())[1], torch.zeros(32, device=cuda))  # fp32: two-pass


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_fast_forward_kernels_match_plain(cuda, exact, mode):
    """``fdgan_fast.apply`` on the kernel path against its plain path in
    fp32 (test_pallas_dense.py:132's tolerance), and against
    ``FDGAN.forward``; in bf16 the launches per forward: K1 42, K2 42 and
    channel_stats 45 (3 block inputs, 42 new slices) in batch mode, 0 and 0
    in running mode."""
    model = FDGAN(device=cuda, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(1).uniform(size=(2, 32, 48, 3)), dtype=torch.float32, device=cuda)
    with torch.inference_mode():
        got = fdgan_fast.apply(model, x, bn_mode=mode)
        ref = fdgan_fast.apply(model, x, bn_mode=mode, impl="plain")
        module = model(x, bn_mode=mode)
        torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(got, module, atol=5e-4, rtol=1e-3)
        dense.reset_launch_counts()
        stats.reset_launch_count()
        y = fdgan_fast.apply(model, x.bfloat16(), bn_mode=mode)
        torch.cuda.synchronize()
    batch = mode == "batch"
    assert (dense.k1_launches, dense.k2_launches, stats.launches) == (42, 42 if batch else 0, 45 if batch else 0)
    assert bool(torch.isfinite(y.float()).all()) and float((y.float() - ref).abs().mean()) < 2e-2


@pytest.mark.parametrize("shape", [(1, 24, 40, 3), (2, 120, 200, 3), (1, 130, 135, 3), (3, 9, 8, 3), (1, 300, 17, 3)])
def test_k3_fp32_is_bit_equal_to_plain(cuda, shape):
    """K3 in fp32 is the plain version bit for bit, also where H and W are
    not multiples of its tile and W is not a multiple of its vectors."""
    x = torch.tensor(np.random.default_rng(14).uniform(size=shape), dtype=torch.float32, device=cuda)
    got = freq.frequency_fuse(x)
    torch.testing.assert_close(got, filters.frequency_fuse(x), rtol=0, atol=0)


def test_engine_on_cuda_matches_cpu_engine(cuda):
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    imgs = [np.random.default_rng(i).integers(0, 256, size=s, dtype=np.uint8)
            for i, s in enumerate([(40, 56, 3), (33, 20, 3), (16, 16, 3)])]
    gpu = InferenceEngine(model, device=cuda, precision="fp32", bucket=8, batch_sizes=(1, 2, 4))
    got = list(gpu.stream(iter(imgs), depth=2))  # fp32 engines run cuDNN without TF32
    cpu = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1, 2, 4))
    want = cpu.predict_batch(imgs)
    for a, b, img in zip(got, want, imgs):
        assert a.shape == img.shape
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3)
    assert gpu.stats["k1_launches"] == 42 * gpu.stats["batches"] and gpu.stats["k2_launches"] == 0


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_demo_core_kernels_match_plain(cuda, precision):
    """``cli.demo.dehaze`` at batch 1 on a ragged 150×203 image
    (reflect-padded to 152×208: the dense blocks run at 152×208, 76×104 and
    38×52): kernels against plain (fp32: the generator's tolerance; bf16:
    mean error), launches per image K1 42, K2 42, channel_stats 45 in bf16
    and 0 in fp32 (its kernel is bf16 only)."""
    from fdgan_tpu_torch.cli.demo import dehaze
    from fdgan_tpu_torch.data.h5 import DataLoader

    model = FDGAN(device=cuda, generator=torch.Generator().manual_seed(0))
    haze = np.random.default_rng(3).uniform(size=(150, 203, 3)).astype(np.float32)
    loader = DataLoader([(haze, haze)], batch_size=1)
    dense.reset_launch_counts()
    stats.reset_launch_count()
    ((_, _, got),) = dehaze(model, loader, precision=precision, device=cuda)
    launches = (dense.k1_launches, dense.k2_launches, stats.launches)
    ((_, _, ref),) = dehaze(model, loader, precision=precision, device=cuda, impl="plain")
    assert got.shape == haze.shape and got.dtype == np.float32 and np.isfinite(got).all()
    assert launches == (42, 42, 45 if precision == "bf16" else 0)
    if precision == "fp32":
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    else:
        assert float(np.abs(got - ref).mean()) < 2e-2


def test_engine_tiled_route_on_the_card(cuda):
    """The engine's tiled route (tile 64, halo 16) on a 96×136 image against
    the demo's tiled core over the same model, fp32, running BN."""
    from fdgan_tpu_torch.cli.demo import dehaze
    from fdgan_tpu_torch.data.h5 import DataLoader

    model = FDGAN(device=cuda, generator=torch.Generator().manual_seed(0))
    haze = np.random.default_rng(4).uniform(size=(96, 136, 3)).astype(np.float32)
    engine = InferenceEngine(model, device=cuda, precision="fp32", bn_mode="running", tile=64, halo=16)
    dense.reset_launch_counts()
    got = engine.predict(haze)
    ((_, _, want),) = dehaze(model, DataLoader([(haze,)]), bn_mode="running", tile=64, halo=16, device=cuda)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # 2 × 4 tiles of 64² (starts 0, 32; 0, 32, 64, 72), each a forward
    assert engine.stats["k1_launches"] == 42 * 2 * 4 and engine.stats["batches"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 256, 256, 3), (1, 24, 40, 3), (2, 120, 200, 3)])
def test_k3_matches_plain(cuda, shape, dtype):
    x = torch.tensor(np.random.default_rng(9).uniform(size=shape), dtype=dtype, device=cuda)
    freq.reset_launch_count()
    got = freq.frequency_fuse(x)
    torch.cuda.synchronize()
    assert freq.k3_launches == 1 and got.shape == shape[:3] + (9,) and got.dtype == dtype
    torch.testing.assert_close(got.float(), filters.frequency_fuse(x).float(), **K3_TOL[dtype])


def test_k3_rejects_bad_inputs(cuda):
    """The launcher refuses what K3 cannot read. ``frequency_fuse`` itself
    takes any layout: it passes x on contiguous (a band of a batch's rows is
    a strided view), so the layout's refusal is the launcher's."""
    x = torch.zeros(1, 16, 16, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        freq._launch_k3(x.transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        freq.frequency_fuse(x.half())
    with pytest.raises(ValueError, match="reflect pad"):
        freq.frequency_fuse(x[:, :7].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_on_a_strided_band_is_its_contiguous_copy(cuda, dtype):
    """A band of rows of a batch (``x[:, r0:r1]``, a strided view, as a rank
    with H sharded holds it) through ``frequency_fuse``: the same bits as its
    contiguous copy, with and without halo rows."""
    x = torch.tensor(np.random.default_rng(16).uniform(size=(3, 64, 40, 3)), dtype=dtype, device=cuda)
    band = x[:, 16:40]
    assert not band.is_contiguous()
    halo = (x[:, 9:16], x[:, 40:47])
    for h in (None, halo):
        assert torch.equal(freq.frequency_fuse(band, halo=h), freq.frequency_fuse(band.contiguous(), halo=h))


def test_gradients_through_the_kernels_match_plain(cuda, exact):
    """K1 and K2 inside a 2-layer fp32 block (their 3xTF32 kernels), K3 on
    its own: the backward is the plain version's VJP on both sides; the
    forwards differ by K1's fp32 error (≤ 6e-6), which the later layer
    carries."""
    torch.manual_seed(0)
    block = DenseBlock(64, 2, device=cuda)
    x = torch.tensor(np.random.default_rng(10).uniform(size=(2, 16, 16, 64)), dtype=torch.float32, device=cuda)
    grads = {}
    for impl in ("kernels", "plain"):
        block.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        dense.reset_launch_counts()
        y, _ = dense.dense_block_fused(list(block.children()), xi, mode="batch", impl=impl)
        y.square().mean().backward()
        grads[impl] = [xi.grad] + [p.grad for p in block.parameters()]
        if impl == "kernels":
            assert (dense.k1_launches, dense.k2_launches) == (2, 2)
    for a, b in zip(grads["kernels"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)), (torch.bfloat16, dict(atol=0, rtol=0))):
        xs = torch.tensor(np.random.default_rng(11).uniform(size=(2, 40, 56, 3)), dtype=dtype, device=cuda)
        ct = torch.randn(2, 40, 56, 9, device=cuda, dtype=dtype)
        xk, xp = xs.clone().requires_grad_(True), xs.clone().requires_grad_(True)
        (freq.frequency_fuse(xk).float() * ct.float()).sum().backward()
        (filters.frequency_fuse(xp).float() * ct.float()).sum().backward()
        torch.testing.assert_close(xk.grad, xp.grad, **tol)


def test_fp32_train_step_kernels_match_plain(cuda, exact):
    """One fp32 step from one state and batch: impl='kernels' against
    impl='plain'. Losses agree closely; parameters agree to 1e-6 except
    where Adam's first step turns gradient noise around 0 into ±lr (see
    tests/test_torch_train.py): there by at most 2·lr, on under 0.5 %."""
    state, tx_g, tx_d = create_train_state(0, device=cuda)
    states = {"kernels": state, "plain": copy.deepcopy(state)}
    gt = np.random.default_rng(12).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    haze = torch.tensor(np.clip(0.6 * gt + 0.3, 0, 1), device=cuda)
    gt = torch.tensor(gt, device=cuda)
    metrics = {}
    for impl, st in states.items():
        dense.reset_launch_counts()
        freq.reset_launch_count()
        _, metrics[impl] = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), impl=impl)(st, haze, gt)
        torch.cuda.synchronize()
        launches = (dense.k1_launches, dense.k2_launches, freq.k3_launches)
        assert launches == ((42, 42, 3) if impl == "kernels" else (0, 0, 0))
    for k, v in metrics["kernels"].items():
        assert torch.isfinite(v), k
        torch.testing.assert_close(v, metrics["plain"][k], atol=1e-5, rtol=1e-4, msg=k)
    for net in ("g", "d"):
        got, want = getattr(states["kernels"], net).state_dict(), getattr(states["plain"], net).state_dict()
        n = off = 0
        for k, w in want.items():
            diff = (got[k] - w).abs()
            tol = 1e-5 if "running" in k else 2 * 2e-4 + 1e-6
            assert float(diff.max()) <= tol, k
            n, off = n + diff.numel(), off + int((diff > 1e-6).sum())
        assert off / n < 5e-3, (net, off, n)


def _train_batch(cuda, b, size, seed):
    gt = np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)
    return torch.tensor(np.clip(0.6 * gt + 0.3, 0, 1), device=cuda), torch.tensor(gt, device=cuda)


@pytest.mark.parametrize("remat", [True, "stages"])
def test_remat_with_the_kernels_matches_no_remat(cuda, exact, remat):
    """One fp32 step with the kernels under remat against one without: the
    recompute launches the same kernels on the same inputs. The losses and
    running statistics come from the forward; the parameters are compared as
    test_fp32_train_step_kernels_match_plain compares them, since cuDNN's
    weight gradients may sum in another order from one step to the next and
    Adam's first step turns noise around 0 into ±lr."""
    haze, gt = _train_batch(cuda, 2, 64, 13)
    runs = {}
    for mode in (False, remat):
        state, tx_g, tx_d = create_train_state(0, device=cuda)
        _, metrics = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), remat=mode)(state, haze, gt)
        runs[mode] = (state, metrics)
    for k, v in runs[remat][1].items():
        assert torch.isfinite(v), k
        torch.testing.assert_close(v, runs[False][1][k], atol=1e-6, rtol=1e-6, msg=k)
    for net in ("g", "d"):
        got, want = getattr(runs[remat][0], net).state_dict(), getattr(runs[False][0], net).state_dict()
        n = off = 0
        for k, w in want.items():
            diff = (got[k] - w).abs()
            assert float(diff.max()) <= (1e-6 if "running" in k else 2 * 2e-4 + 1e-6), k
            n, off = n + diff.numel(), off + int((diff > 1e-6).sum())
        assert off / n < 5e-3, (net, off, n)


@pytest.mark.parametrize("mode, kw, want", [
    ("none", {}, (42, 42, 3, 54)),
    ("remat", {"remat": True}, (84, 84, 3, 54)),  # each layer core's recompute: K2 and K1 again
    ("stages", {"remat": "stages"}, (126, 126, 3, 99)),  # and each encoder stage's: its 45 statistics
    ("accum2", {"accum_steps": 2}, (84, 84, 4, 102)),  # G's forward and G loss's D forward per microbatch
])
def test_launches_per_bf16_step_under_remat(cuda, mode, kw, want):
    haze, gt = _train_batch(cuda, 2, 64, 14)
    state, tx_g, tx_d = create_train_state(0, device=cuda)
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), compute_dtype=torch.bfloat16, **kw)
    dense.reset_launch_counts()
    freq.reset_launch_count()
    stats.reset_launch_count()
    _, metrics = step(state, haze, gt)
    torch.cuda.synchronize()
    assert (dense.k1_launches, dense.k2_launches, freq.k3_launches, stats.launches) == want
    assert torch.isfinite(metrics["g_total"])


def test_train_cli_core_on_the_card(cuda, tmp_path, capsys):
    """cli.train.train over in-memory pairs on the card, resumed once, the
    best generator served (chip_smoke.py phase 8 at the CLI's sizes)."""
    from fdgan_tpu_torch.cli import train as cli
    from fdgan_tpu_torch.cli._common import load_generator
    from fdgan_tpu_torch.data.h5 import DataLoader

    rng = np.random.default_rng(15)
    gts = [rng.uniform(size=(64, 64, 3)).astype(np.float32) for _ in range(6)]
    items = [(np.clip(0.6 * g + 0.3, 0, 1).astype(np.float32), g) for g in gts]
    args = ["--exp", str(tmp_path), "--precision", "bf16", "--batchSize", "2", "--imageSize", "64", "--epochs", "1",
            "--evalIter", "2", "--keepBest", "--logEvery", "1", "--lambdaPerceptual", "0"]
    for _ in range(2):
        state = cli.train(cli.build_parser().parse_args(args), DataLoader(items[:4], batch_size=2),
                          DataLoader(items[4:], batch_size=1), "cuda")
    assert "resumed from" in capsys.readouterr().out and state.step == 4
    y = InferenceEngine(load_generator(str(tmp_path / "netG_best.pth"), device=cuda), device=cuda).predict(items[4][0])
    assert y.shape == (64, 64, 3) and np.isfinite(y).all()


def test_stamp_k2_reports_every_phase(cuda):
    """The stamped build runs in a process of its own (this one has the
    kernels loaded without stamps)."""
    import subprocess
    import sys

    from fdgan_tpu_torch.tools import stamp_k2

    out = subprocess.run([sys.executable, "-m", "fdgan_tpu_torch.tools.stamp_k2", "--shapes", "1,40,56,96",
                          "4,64,64,544", "--launches", "2"], capture_output=True, text=True, timeout=600, check=True)
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()[1:]]
    assert [r["shape"] for r in rows] == [[1, 40, 56, 96], [4, 64, 64, 544]]
    for r in rows:
        assert list(r["cycles_per_step"]) == list(stamp_k2.PHASES) and r["ms"] > 0
        assert r["kernel_cycles_per_warp"] > sum(r["cycles_per_step"].values()) and r["steps_per_warp"] >= 2
    assert rows[1]["cycles_per_step"]["w1_ring"] > 0  # C = 544 reads W1 past its resident chunks


def test_prof_serve_reports_the_dense_kernels(cuda, capsys):
    from fdgan_tpu_torch.tools import prof_serve

    assert prof_serve.main(["--batch", "1", "--size", "64", "--impl", "kernels", "--warmup", "1",
                            "--forwards", "1", "--prof-forwards", "1"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()[1:]]
    assert [(r["impl"], r["bn_mode"]) for r in recs] == [("kernels", "running"), ("kernels", "batch")]
    for r in recs:
        assert r["wall_ms"] > 0 and 0 < r["k1_ms"] < r["device_ms"] and r["cat_ms"] > 0
        assert (r["k2_ms"] > 0) == (r["bn_mode"] == "batch") and len(r["top"]) == 10


@pytest.mark.parametrize("size", ["full", "ragged", "tiny"])
@pytest.mark.parametrize("name", list(probe_tool.PROBES))
def test_probe_kernel_matches_plain(cuda, name, size):
    """Each probe kernel against its plain version at the probes' own size
    (2²¹ rows; 8×512×512), at M = 2²¹ − 24 and a 120×200 image, and at a few
    hundred values; tolerances and their reasons are in tools/probes.py."""
    probes.reset_launch_counts()
    probe_tool.check(name, size, device=cuda)
    assert probes.launches[name] == 1 and sum(probes.launches.values()) == 1


@pytest.mark.parametrize("tile_rows", probes.MM_TILES)
def test_probe_mm_row_tiles_match_plain(cuda, tile_rows):
    a, b = probe_tool.make_mm("ragged", np.random.default_rng(1), cuda)
    probe_tool.compare(probes.probe_mm(a, b, tile_rows), probes.mm_reference(a, b), probe_tool.PRODUCT_TOL, "probe_mm")
    assert probes.probe_mm(a[:40], b, tile_rows).shape == (40, 128)  # fewer rows than one tile


@pytest.mark.parametrize("size", ["ragged", "tiny"])
def test_probe_conv2_bodies_agree(cuda, size):
    """taps9, packed and wgmma add the nine terms in different orders: one bf16 step."""
    g, w2 = probe_tool.make_conv2(size, np.random.default_rng(2), cuda)
    taps9 = probes.conv2(g, w2, "taps9")
    for mode in ("packed", "wgmma"):
        probe_tool.compare(probes.conv2(g, w2, mode), taps9, probe_tool.PRODUCT_TOL, f"conv2 {mode}")


@pytest.mark.parametrize("mode", probes.CONV1_MODES)
@pytest.mark.parametrize("widths", [(160,), (64, 32, 32, 32), (8,) * 8, (24, 104), (256, 256, 32)])
def test_probe_conv1_segmentations_agree(cuda, widths, mode):
    """The same channels cut differently give the same result bit for bit:
    the segments change the reads, not the arithmetic. 544 channels take the
    wgmma body past its 256 resident channels of W1."""
    segs, a, b, w1 = probe_tool.make_conv1("ragged", np.random.default_rng(3), cuda, widths)
    got = probes.conv1_segments(segs, a, b, w1, mode)
    mono = probes.conv1_segments([torch.cat(segs, dim=-1)], a, b, w1, mode)
    assert torch.equal(got, mono)
    probe_tool.compare(got, probes.conv1_reference(segs, a, b, w1), probe_tool.CONV1_TOL, "conv1")


@pytest.mark.parametrize("size", ["full", "ragged", "tiny"])
def test_probe_conv1_bodies_agree(cuda, size):
    """wgmma and mma round the same fp32 sums of the same products once; a
    fused multiply-add in t can differ by a step: CONV1_TOL."""
    segs, a, b, w1 = probe_tool.make_conv1(size, np.random.default_rng(4), cuda)
    probe_tool.compare(probes.conv1_segments(segs, a, b, w1, "wgmma"), probes.conv1_segments(segs, a, b, w1, "mma"),
                       probe_tool.CONV1_TOL, "conv1 wgmma vs mma")


COPY_BODIES = {"probe_scale_copy": probes.scale_copy, "probe_scale_copy_staged": probes.scale_copy_staged,
               "probe_scale_copy_bulk": probes.scale_copy_bulk}


COPY_CHUNK = 2048  # values in 4 KB: a plain block's, and a stage of the staged and bulk bodies
COPY_BLOCK = {"probe_scale_copy": COPY_CHUNK, "probe_scale_copy_staged": 3 * COPY_CHUNK,
              "probe_scale_copy_bulk": 4 * COPY_CHUNK}  # values a block takes (csrc/probes.cu)
COPY_SIZES = {
    "13": lambda block: 13,
    "8k+5": lambda block: 8 * 1000 + 5,
    "one chunk": lambda block: COPY_CHUNK,
    "one chunk + 8": lambda block: COPY_CHUNK + 8,
    # five whole blocks, then a block with one whole chunk, one of three
    # vectors, and five values after them
    "blocks + short block + tail": lambda block: 5 * block + COPY_CHUNK + 8 * 3 + 5,
    "(2^21 - 24) x 128": lambda block: (2**21 - 24) * 128,
}


@pytest.mark.parametrize("size", list(COPY_SIZES))
@pytest.mark.parametrize("name", list(COPY_BODIES))
def test_copy_body_bit_equal_to_plain(cuda, name, size):
    """Each copy body against scale_copy_reference, bit for bit, at sizes that
    reach the edges of its blocks: fewer values than two vectors, a ragged
    tail, one whole chunk, a chunk and one vector, whole blocks and a short
    last one, and the probes' ragged size; a second launch gives the same
    bits."""
    n = COPY_SIZES[size](COPY_BLOCK[name])
    gen = torch.Generator(device=cuda).manual_seed(n % 9973)
    a = torch.randn(n, generator=gen, device=cuda).bfloat16()
    probes.reset_launch_counts()
    got = COPY_BODIES[name](a)
    assert torch.equal(got, probes.scale_copy_reference(a))
    assert torch.equal(COPY_BODIES[name](a), got) and probes.launches[name] == 2


@pytest.mark.parametrize("name", list(COPY_BODIES))
def test_copy_body_reads_a_view_into_a_larger_buffer(cuda, name):
    """From a 16-byte-aligned view at an offset into a larger buffer, the same
    bits as from a contiguous copy of it."""
    n = 2 * COPY_BLOCK[name] + 8 * 7 + 3
    buf = torch.randn(n + 8 * 40, device=cuda).bfloat16()
    view = buf[8 * 13:8 * 13 + n]
    assert view.data_ptr() % 16 == 0 and view.data_ptr() != buf.data_ptr()
    assert torch.equal(COPY_BODIES[name](view), COPY_BODIES[name](view.clone()))


def test_probe_wrappers_launch_or_raise_on_cuda(cuda):
    a = torch.zeros(64, 128, device=cuda, dtype=torch.bfloat16)
    for copy in COPY_BODIES.values():
        with pytest.raises(TypeError, match="bfloat16"):
            copy(a.float())
        with pytest.raises(ValueError, match="aligned"):
            copy(torch.zeros(64 * 128 + 4, device=cuda, dtype=torch.bfloat16)[4:])
    with pytest.raises(ValueError, match="tile_rows"):
        probes.probe_mm(a, torch.zeros(128, 128, device=cuda, dtype=torch.bfloat16), tile_rows=512)
    with pytest.raises(ValueError, match="x on cuda"):
        probes.probe_mm(a, torch.zeros(128, 128, dtype=torch.bfloat16))
    y = probes.scale_copy(torch.ones(13, device=cuda, dtype=torch.bfloat16))  # fewer values than two vectors
    assert y.tolist() == [2.0] * 13


def test_probe_tool_prints_rows_and_answers(cuda, capsys):
    assert probe_tool.main(["--size", "ragged"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()[1:]]
    rows = [r for r in lines if "name" in r]
    assert [r["name"] for r in rows] == list(probe_tool.PROBES)
    for r in rows:
        assert r["ms"] > 0 and r["plain_ms"] > 0 and 0 < r["share"] and r["bound_by"] in ("bytes", "operations")
        assert "NVIDIA" in r["card"] and r["device"] == torch.cuda.get_device_name(0)
        if r["library"] is not None:  # kernel and library in turns: each median within its spread
            for key in ("ms", "library_ms"):
                assert r[f"{key}_spread"][0] <= r[key] <= r[f"{key}_spread"][1]
    assert len([r for r in lines if "question" in r]) == 8  # P1, P2/P3b, P3a, P4, P5 Q1-Q3, wgmma
    assert lines[-1]["wgmma_selfcheck_max_abs_err"] <= 1e-3 and len(lines[-1]["wgmma_rates"]) == 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [400, 456])
def test_k1_k2_at_channels_that_are_not_multiples_of_32(cuda, exact, c, dtype):
    """densenet_dehaze's layer inputs reach C = 400 + 32k and 456 + 32k,
    which are 16 and 8 modulo 32: K1's t·W1 chunks and bf16 K2's 64-channel
    W1 padding (``ops.dense.w1_tw1_planes``) end mid-chunk. Both against
    their twins, from a contiguous tensor and from a channel slice of a
    wider buffer (ld = C + 64), where they must give the same bits."""
    args = _layer_args((2, 24, 40, c), 12, cuda, dtype)
    f = dense.fused_dense_layer(*args)
    m, v = dense.h_batch_stats(*args[:4])
    buf, xv, out = _buffer_view(args[0], c + 64)
    with torch.inference_mode():
        dense.fused_dense_layer(xv, *args[1:], out=out)
    mv, vv = dense.h_batch_stats(xv, *args[1:4])
    torch.cuda.synchronize()
    torch.testing.assert_close(f.float(), dense.layer_reference(*args).float(),
                               **(K1_TOL if dtype == torch.float32 else K1_TOL_BF16))
    mr, vr = dense.h_stats_reference(*args[:4])
    torch.testing.assert_close(m, mr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(v, vr, atol=1e-4, rtol=1e-3)
    assert torch.equal(out, f) and torch.equal(mv, m) and torch.equal(vv, v)



# --- the device-resident loop -------------------------------------------------------

@pytest.fixture
def sync_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block: any
    operation that makes the host wait on the device raises."""
    from contextlib import contextmanager

    @contextmanager
    def block():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return block


@pytest.mark.parametrize("pool", [0, 4])
def test_device_chunk_makes_no_host_sync(cuda, sync_errors, pool):
    """A chunk of 3 bf16 steps (with pool: the G step, the device pool's
    query, the D step) over 2 staged 2×64² batches runs under sync debug
    mode "error": the host never waits on the device inside it. One step
    first outside it builds the kernels and lets cuDNN and the allocator
    settle. Then the chunk's metrics are finite."""
    from fdgan_tpu_torch.train.loop import make_device_loop, make_device_pool_loop, make_gd_steps
    from fdgan_tpu_torch.train.pool import device_pool_init

    batches = [_train_batch(cuda, 2, 64, 30 + i) for i in range(2)]
    haze_all = torch.stack([h for h, _ in batches]).bfloat16()
    gt_all = torch.stack([g for _, g in batches]).bfloat16()
    idx = torch.tensor([1, 0, 1], device=cuda)
    state, tx_g, tx_d = create_train_state(0, device=cuda)
    weights = LossWeights(perceptual=0.0)
    if pool:
        g_step, d_step = make_gd_steps(tx_g, tx_d, weights, compute_dtype=torch.bfloat16)
        buf, n = device_pool_init(pool, haze_all.shape[1:], torch.bfloat16, cuda)
        gen = torch.Generator(device=cuda).manual_seed(3)
        run = make_device_pool_loop(g_step, d_step, 3)
        state, buf, n, _ = make_device_pool_loop(g_step, d_step, 1)(state, buf, n, haze_all, gt_all, idx[:1], gen)
        with sync_errors():
            state, buf, n, ms = run(state, buf, n, haze_all, gt_all, idx, gen)
        assert int(n) == 4
    else:
        step = make_train_step(tx_g, tx_d, weights, compute_dtype=torch.bfloat16)
        state, _ = step(state, haze_all[0], gt_all[0])
        with sync_errors():
            state, ms = make_device_loop(step, 3)(state, haze_all, gt_all, idx)
    assert state.step == 4 and all(bool(torch.isfinite(v).all()) for v in ms.values())


def test_device_pool_query_with_a_card_generator(cuda):
    """``device_pool_query`` on the card, its draws from a CUDA generator: the
    same as ``pool_update`` with those draws taken from a twin generator
    (uniform, then randint, each query), and the pool's semantics: the fill
    phase stores and passes, the count saturates, a swap hands back a stored
    batch."""
    from fdgan_tpu_torch.train.pool import device_pool_init, device_pool_query, pool_update

    gen, twin = (torch.Generator(device=cuda).manual_seed(5) for _ in range(2))
    a, na = device_pool_init(2, (1, 4, 4, 3), torch.bfloat16, cuda)
    b, nb = device_pool_init(2, (1, 4, 4, 3), torch.bfloat16, cuda)
    outs = set()
    for k in range(12):
        img = torch.full((1, 4, 4, 3), float(k), dtype=torch.bfloat16, device=cuda)
        a, na, out = device_pool_query(a, na, img, gen)
        swap = torch.rand((), generator=twin, device=cuda) > 0.5
        slot = torch.randint(2, (), generator=twin, device=cuda)
        b, nb, want = pool_update(b, nb, img, swap, slot)
        assert torch.equal(a, b) and torch.equal(out, want) and int(na) == int(nb) == min(k + 1, 2)
        outs.add("pass" if float(out[0, 0, 0, 0]) == k else "swap")
    assert outs == {"pass", "swap"}


def test_async_checkpoint_of_card_state_is_the_state_at_save(cuda, tmp_path):
    """``AsyncCheckpointer`` on a train state on the card: a bf16 step right
    after ``save()`` updates the parameters and Adam's moments in place
    while the writer fetches the copy; the file holds the state at
    ``save()``, bit for bit."""
    from fdgan_tpu_torch.io.checkpoint import AsyncCheckpointer

    haze, gt = _train_batch(cuda, 2, 64, 17)
    state, tx_g, tx_d = create_train_state(0, device=cuda)
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), compute_dtype=torch.bfloat16)
    state, _ = step(state, haze, gt)
    want = {net: {k: v.detach().cpu().clone() for k, v in getattr(state, net).state_dict().items()}
            for net in ("g", "d")}
    moments = {i: e["exp_avg"].cpu().clone() for i, e in state.g_opt.state_dict()["state"].items()}
    saver = AsyncCheckpointer()
    saver.save(str(tmp_path), state, step=state.step)
    state, _ = step(state, haze, gt)
    assert saver.wait() is True
    blob = torch.load(tmp_path / "ckpt_1.pt", weights_only=True)
    assert blob["step"] == 1
    for net in ("g", "d"):
        assert all(torch.equal(blob[net][k].cpu(), v) for k, v in want[net].items()), net
    assert all(torch.equal(blob["g_opt"]["state"][i]["exp_avg"].cpu(), v) for i, v in moments.items())
    assert not torch.equal(state.g.conv_refin1.weight.cpu(), want["g"]["conv_refin1.weight"])


# DehazeFormer-B's three attending stages at a batch of 8 at 460x620 (the
# bulk cell's launch shape): (B, H, W, C, heads)
WATTN_SHAPES = [(8, 460, 620, 24, 2), (8, 230, 310, 48, 4), (8, 115, 155, 96, 6)]
# bf16 in and out on both sides; the kernel rounds the unnormalised
# probabilities to bf16 for P.V (2^-9 relative each) where the plain version
# keeps fp32, and each side rounds O to bf16 once (2^-8 relative): a value
# may differ by a bf16 step and a little more
WATTN_TOL = dict(atol=1.5e-2, rtol=1.6e-2)


def _wattn_operands(shape, seed, device):
    b, h, w, c, heads = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    qk = torch.randn((b, h, w, 2 * c), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((b, h, w, c), generator=gen, device=device).to(torch.bfloat16)
    bias = 0.5 * torch.randn((heads, 64, 64), generator=gen, device=device)
    return qk, v, bias, heads


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("shape", WATTN_SHAPES)
def test_window_attention_kernel_matches_plain(cuda, shape, shift):
    """The window attention kernel against its plain version at the bulk
    cell's three stage shapes, both shifts: every pixel written, within a
    bf16 step, one launch a call."""
    qk, v, bias, heads = _wattn_operands(shape, 7 + shift, cuda)
    before = wattn.launches
    got = wattn.window_attention(qk, v, bias, heads, shift)
    torch.cuda.synchronize()
    assert wattn.launches == before + 1
    want = wattn.reference(qk, v, bias, heads, shift)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **WATTN_TOL)


def test_window_attention_kernel_refuses_what_it_does_not_take(cuda):
    qk, v, bias, heads = _wattn_operands((1, 16, 16, 24, 2), 3, cuda)
    with pytest.raises(TypeError, match="bfloat16 only"):
        wattn.window_attention(qk.float(), v.float(), bias, heads, 0)
    with pytest.raises(ValueError, match="head dims"):
        wattn.window_attention(qk, v, bias.repeat(2, 1, 1)[:3], 3, 0)
    with pytest.raises(ValueError, match="contiguous"):
        wattn.window_attention(qk.transpose(1, 2), v.transpose(1, 2), bias, heads, 0)


def test_dehazeformer_b_forward_on_the_card(cuda):
    """DehazeFormer-B in bf16 on the card: 24 kernel launches a forward, and
    the forward through the kernel against the same forward with the plain
    window attention, by PSNR over [-1, 1]."""
    from fdgan_tpu_torch.models.dehazeformer import dehazeformer_b

    model = dehazeformer_b(device=cuda, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.rand((2, 116, 156, 3), generator=gen, device=cuda) * 2 - 1).to(torch.bfloat16)
    before = wattn.launches
    with torch.inference_mode():
        got = model(x)
        torch.cuda.synchronize()
        assert wattn.launches == before + 24
        want = model(x, impl="plain")
    mse = float((got.clamp(-1, 1) - want.clamp(-1, 1)).square().mean())
    assert 10 * np.log10(4.0 / max(mse, 1e-20)) > 45.0, mse
