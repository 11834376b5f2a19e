"""The port's dense-layer ops (fdgan_tpu_torch.ops.dense) against the JAX
package's Pallas kernels, run in interpret mode as its own tests run them.

On the CPU the wrappers take the plain twins; the kernels themselves run
only on a CUDA card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.models import densenet as jdensenet
from fdgan_tpu.ops import pallas_dense as jpd
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.models.densenet import DenseBlock
from fdgan_tpu_torch.ops import dense

K1_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_pallas_dense.py:52


def _layer_args(seed=0, shape=(2, 16, 24, 64)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return {
        "x": rng.uniform(size=shape).astype(np.float32),
        "a1": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "b1": rng.normal(0, 0.3, c).astype(np.float32),
        "w1": (rng.standard_normal((c, 128)) / np.sqrt(c)).astype(np.float32),
        "a2": rng.uniform(0.5, 1.5, 128).astype(np.float32),
        "b2": rng.normal(0, 0.3, 128).astype(np.float32),
        "w2": (rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)).astype(np.float32),
    }


def _torch(args):
    return {k: torch.from_numpy(v) for k, v in args.items()}


def _jax(args):
    return {k: jnp.asarray(v) for k, v in args.items()}


@pytest.fixture(scope="module")
def layer_case():
    args = _layer_args()
    j = _jax(args)
    order = ("x", "a1", "b1", "w1", "a2", "b2", "w2")
    pallas = jpd._fused_layer_pallas(*(j[k] for k in order), tile_h=4, interpret=True)
    xla = jpd._layer_reference(*(j[k] for k in order))
    stats = jpd._h_stats_pallas(j["x"], j["a1"], j["b1"], j["w1"], tile_h=4, interpret=True)
    return args, {"pallas": np.asarray(pallas), "xla": np.asarray(xla),
                  "stats": tuple(np.asarray(s) for s in stats)}


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_layer_twin_matches_jax(layer_case, ref):
    args, refs = layer_case
    t = _torch(args)
    got = dense.layer_reference(t["x"], t["a1"], t["b1"], t["w1"], t["a2"], t["b2"], t["w2"])
    assert got.shape == (2, 16, 24, 32) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), refs[ref], **K1_TOL)


def test_h_stats_twin_matches_pallas(layer_case):
    args, refs = layer_case
    t = _torch(args)
    m, v = dense.h_stats_reference(t["x"], t["a1"], t["b1"], t["w1"])
    jm, jv = refs["stats"]
    np.testing.assert_allclose(m.numpy(), jm, atol=1e-4, rtol=1e-4)  # test_pallas_dense.py:67-68
    np.testing.assert_allclose(v.numpy(), jv, atol=1e-4, rtol=1e-3)


def test_layer_twin_bf16_rounding_points():
    """In bf16 the twin rounds t and g to bf16 and sums in fp32, as the
    Pallas kernel does: it matches the JAX twin run in bf16."""
    args = _layer_args(seed=1, shape=(1, 8, 8, 32))
    order = ("x", "a1", "b1", "w1", "a2", "b2", "w2")
    j = _jax(args)
    jb = [j[k].astype(jnp.bfloat16) if k in ("x", "w1", "w2") else j[k] for k in order]
    ref = np.asarray(jpd._layer_reference(*jb).astype(jnp.float32))
    t = _torch(args)
    tb = [t[k].bfloat16() if k in ("x", "w1", "w2") else t[k] for k in order]
    got = dense.layer_reference(*tb)
    assert got.dtype == torch.bfloat16
    # one bf16 step (2^-8 relative) either way where fp32 sums round differently
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=2.0 ** -7)


def test_wrappers_take_the_twin_on_cpu():
    t = _torch(_layer_args(seed=2, shape=(1, 8, 8, 32)))
    dense.reset_launch_counts()
    f = dense.fused_dense_layer(t["x"], t["a1"], t["b1"], t["w1"], t["a2"], t["b2"], t["w2"])
    m, v = dense.h_batch_stats(t["x"], t["a1"], t["b1"], t["w1"])
    assert (dense.k1_launches, dense.k2_launches) == (0, 0)
    ref = dense.layer_reference(t["x"], t["a1"], t["b1"], t["w1"], t["a2"], t["b2"], t["w2"])
    torch.testing.assert_close(f, ref, rtol=0, atol=0)
    torch.testing.assert_close((m, v), dense.h_stats_reference(t["x"], t["a1"], t["b1"], t["w1"]))


@pytest.mark.parametrize("c", [8, 40, 64, 96, 992])
def test_w1_planes_is_the_kernel_layout(c):
    """The bf16 K1 takes W1 as planes of eight input channels, (C/8, 128, 8)
    with planes[p, n, k] = w1[8p + k, n]: the shared-memory layout its wgmma
    descriptors name, so that a chunk of 64 channels is one contiguous block
    of 8 planes (16 KB in bf16) at byte offset 16 KB times the chunk's index,
    and a ragged last chunk is the planes that are left."""
    w1 = torch.arange(c * 128, dtype=torch.float32).reshape(c, 128).to(torch.bfloat16)
    planes = dense.w1_planes(w1)
    assert planes.shape == (c // 8, 128, 8) and planes.is_contiguous() and planes.dtype == w1.dtype
    p, n, k = np.meshgrid(np.arange(c // 8), np.arange(128), np.arange(8), indexing="ij")
    assert torch.equal(planes, w1[torch.from_numpy(8 * p + k), torch.from_numpy(n)])
    flat = planes.reshape(-1)  # element (channel ch, output n) lies at ((ch // 8) * 128 + n) * 8 + ch % 8
    for ch, out in ((0, 0), (c - 1, 127), (c // 2 + 3, 77)):
        assert flat[((ch // 8) * 128 + out) * 8 + ch % 8] == w1[ch, out]
    chunk = 64 * 128  # elements of a 64-channel chunk: chunk i starts at i * 64 * 128
    for i in range((c + 63) // 64):
        rows = w1[64 * i:64 * (i + 1)]
        assert torch.equal(flat[i * chunk:i * chunk + rows.numel()], dense.w1_planes(rows).reshape(-1))


def _tw1_order():
    """Logical k = 16s + kk of a 64-channel chunk is channel
    16·(kk % 8 // 2) + 4s + 2·(kk // 8) + kk % 2 (csrc/wgmma_bf16.cuh)."""
    k = torch.arange(64)
    kk = k % 16
    return 16 * (kk % 8 // 2) + 4 * (k // 16) + 2 * (kk // 8) + kk % 2


def test_tw1_order_puts_a_threads_fragment_on_16_channels():
    """wgmma's A fragment gives lane 4*gq + tq, at k-step s, the k pairs
    (2tq, 2tq+1) and (2tq+8, 2tq+9). In the tw1 order those are channels
    16tq + 4s .. 16tq + 4s + 3 of the chunk: a thread's four k-steps take
    its 16 consecutive channels, as its two 16-byte loads bring them."""
    order = _tw1_order().tolist()
    assert sorted(order) == list(range(64))
    for tq in range(4):
        for s in range(4):
            ks = [16 * s + 2 * tq, 16 * s + 2 * tq + 1, 16 * s + 2 * tq + 8, 16 * s + 2 * tq + 9]
            assert [order[k] for k in ks] == [16 * tq + 4 * s + i for i in range(4)]


@pytest.mark.parametrize("c", [64, 96, 160, 992])
def test_w1_tw1_planes_keep_the_product(c):
    """Channels taken in the tw1 order against W1 rows in the same order (the
    planes, read back) give t·W1; the rows padded to whole chunks are zeros."""
    rng = np.random.default_rng(c)
    t = torch.from_numpy(rng.standard_normal((5, c)))
    w1 = torch.from_numpy(rng.standard_normal((c, 128)))
    planes = dense.w1_tw1_planes(w1)
    c64 = -(-c // 64) * 64
    assert planes.shape == (c64 // 8, 128, 8)
    w1_logical = planes.permute(0, 2, 1).reshape(c64, 128)  # row 8p + k = planes[p, :, k]
    chans = (torch.arange(c64 // 64).view(-1, 1) * 64 + _tw1_order().view(1, -1)).reshape(-1)
    t_logical = torch.cat([t, t.new_zeros(5, c64 - c)], dim=1)[:, chans]
    torch.testing.assert_close(t_logical @ w1_logical, t @ w1)
    assert not w1_logical[chans >= c].any()


def test_stamp_tool_needs_a_card():
    """The K2 stamp tool measures the card only: without one it runs nothing
    and exits non-zero (tests/test_torch_cuda.py runs it on the card)."""
    from fdgan_tpu_torch.tools import stamp_k2

    if not torch.cuda.is_available():
        assert stamp_k2.main([]) == 2


def test_fold_bn_and_channel_stats_match_jax(np_rng):
    x = np_rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    jm, jv = jpd.channel_stats(jnp.asarray(x))
    tm, tv = dense.channel_stats(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    p = [np_rng.uniform(0.5, 1.5, 6).astype(np.float32) for _ in range(4)]
    ja, jb = jpd.fold_bn(*(jnp.asarray(a) for a in p))
    ta, tb = dense.fold_bn(*(torch.from_numpy(a) for a in p))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


def _random_block(c, layers, seed):
    params = jdensenet.dense_block_init(jax.random.PRNGKey(seed), c, layers)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    # running stats that are not the identity, as test_pallas_dense.py:176-188
    for i in range(layers):
        for nk in ("norm1", "norm2"):
            bn = params[f"denselayer{i + 1}"][nk]
            bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
            bn["var"] = (1.0 + 0.1 * rng.uniform(size=bn["var"].shape)).astype(np.float32)
    block = DenseBlock(c, layers)
    block.load_state_dict(state_dict_from_jax(params), strict=True)
    return params, block


@pytest.fixture(scope="module", params=["batch", "running"])
def block_case(request):
    """A 3-layer block and its JAX output through the Pallas kernels in
    interpret mode, compiled once per BN mode."""
    mode, c, layers = request.param, 32, 3
    params, block = _random_block(c, layers, seed=3)
    x = np.random.default_rng(4).uniform(size=(1, 16, 16, c)).astype(np.float32)
    fused = jax.jit(lambda p, xx: jpd.dense_block_fused(p, xx, mode=mode, interpret=True))
    return mode, block, x, np.asarray(fused(params, jnp.asarray(x)))


@pytest.mark.parametrize("path", ["buffer", "cat"])
def test_dense_block_matches_jax(block_case, path, monkeypatch):
    """Under inference_mode the block's concat is one buffer that the layers
    read and write in slices (no per-layer torch.cat); with grad enabled each
    layer concatenates, and a backward runs through it."""
    mode, block, x, ref = block_case
    cats = []
    real_cat = torch.cat

    def counting_cat(tensors, *args, **kwargs):
        if kwargs.get("dim", args[0] if args else 0) == -1:
            cats.append(len(tensors))
        return real_cat(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "cat", counting_cat)
    layers = list(block.children())
    if path == "buffer":
        with torch.inference_mode():
            got, _ = dense.dense_block_fused(layers, torch.from_numpy(x), mode=mode)
        assert cats == []
    else:
        xt = torch.from_numpy(x).requires_grad_(True)
        got, _ = dense.dense_block_fused(layers, xt, mode=mode)
        assert cats == [2] * len(layers)
        got.square().sum().backward()
        assert xt.grad.shape == x.shape and torch.isfinite(xt.grad).all()
        assert all(p.grad is not None for p in block.parameters())
        block.zero_grad(set_to_none=True)
    assert got.shape == (1, 16, 16, x.shape[-1] + 32 * len(layers)) and got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_channel_slices_of_a_buffer(dtype):
    """x as the first C channels of a wider NHWC buffer and K1's out= as the
    32 after them: the same values as from contiguous tensors, written only
    where out lies."""
    t = _torch(_layer_args(seed=8, shape=(2, 6, 10, 32)))
    args = [t[k].to(dtype) if k in ("x", "w1", "w2") else t[k] for k in ("x", "a1", "b1", "w1", "a2", "b2", "w2")]
    x = args[0]
    buf = torch.full((2, 6, 10, 96), 7.0, dtype=dtype)
    buf[..., :32] = x
    xv, out = buf[..., :32], buf[..., 32:64]
    assert dense.pixel_stride(xv) == dense.pixel_stride(out) == 96
    with torch.inference_mode():
        got = dense.fused_dense_layer(xv, *args[1:], out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(buf[..., 32:64], dense.fused_dense_layer(*args))
    assert torch.equal(buf[..., :32], x) and bool((buf[..., 64:] == 7.0).all())
    torch.testing.assert_close(dense.h_batch_stats(xv, *args[1:4]), dense.h_batch_stats(*args[:4]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("shape, view, ld", [
    ((2, 3, 4, 8), lambda t: t, 8),
    ((2, 3, 4, 24), lambda t: t[..., 8:16], 24),   # a channel slice: ld is the buffer's width
    ((1, 1, 5, 24), lambda t: t[..., :16], 24),    # size-1 dimensions may have any stride
    ((3, 1, 1, 40), lambda t: t[..., 8:40], 40),
])
def test_pixel_stride(shape, view, ld):
    assert dense.pixel_stride(view(torch.zeros(shape))) == ld


def test_wrappers_reject_what_the_kernels_cannot_address():
    t = _torch(_layer_args(seed=9, shape=(1, 4, 4, 32)))
    rest = [t[k] for k in ("a1", "b1", "w1", "a2", "b2", "w2")]
    # pixels closer together than their channels: ld < C
    overlapping = torch.as_strided(torch.zeros(1024), (1, 4, 4, 32), (16 * 16, 4 * 16, 16, 1))
    with pytest.raises(ValueError, match="ld=16 below"):
        dense.h_batch_stats(overlapping, *rest[:3])
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        dense.fused_dense_layer(t["x"].transpose(1, 2), *rest)
    # bf16 pixels 36 channels apart break the kernels' 16-byte vectors
    bf = torch.zeros(1, 4, 4, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="ld % 8"):
        dense.h_batch_stats(bf, rest[0], rest[1], rest[2].bfloat16())
    with pytest.raises(ValueError, match="out must be"):
        with torch.inference_mode():
            dense.fused_dense_layer(t["x"], *rest, out=torch.zeros(1, 4, 4, 16))


def test_out_is_refused_where_autograd_records():
    """out= writes in place: refused with grad enabled and an input that needs
    a grad, accepted under no_grad."""
    t = _torch(_layer_args(seed=10, shape=(1, 4, 4, 32)))
    args = [t[k] for k in ("x", "a1", "b1", "w1", "a2", "b2", "w2")]
    out = torch.zeros(1, 4, 4, 32)
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        dense.fused_dense_layer(*args, out=out)
    with torch.no_grad():
        dense.fused_dense_layer(*args, out=out)
    torch.testing.assert_close(out, dense.layer_reference(*args).detach(), rtol=0, atol=0)


def test_dense_block_rejects_unknown_impl_and_mode():
    _, block = _random_block(32, 1, seed=5)
    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError, match="impl"):
        dense.dense_block_fused(list(block.children()), x, impl="xla")
    with pytest.raises(ValueError, match="BN mode"):
        dense.dense_block_fused(list(block.children()), x, mode="eval")
