"""The fp32 dense-layer kernels' arithmetic, on the CPU.

K1's and K2's fp32 bodies (csrc/dense_layer.cu) take their products as
3×TF32 on ``wgmma``: each fp32 operand v splits into big = rna_tf32(v) and
small = rna_tf32(v − big), and a product is a_small·b_big + a_big·b_small +
a_big·b_big (csrc/wgmma_tf32.cuh). The kernels run only on a card
(tests/test_torch_cuda.py); here the split of ``ops.dense`` is held against
a numpy model of ``cvt.rna.tf32.f32``, the weight planes against the product
they must keep, and an emulation of the kernels' arithmetic (operands split
as the kernels split them, the three products summed in float64) against the
JAX package's fp32 references at the JAX suite's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.ops import pallas_dense as jpd
from fdgan_tpu_torch.ops import dense

K1_TOL = dict(atol=2e-4, rtol=1e-3)        # tests/test_pallas_dense.py:52
K2_MEAN_TOL = dict(atol=1e-4, rtol=1e-4)   # tests/test_pallas_dense.py:67-68
K2_VAR_TOL = dict(atol=1e-4, rtol=1e-3)


def rna_tf32_model(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 in float64 arithmetic, not on the bits: |v| rounded to
    a multiple of 2^(e − 10), e the exponent of its leading bit (−126 for
    subnormals: tf32 keeps fp32's exponent range), halves away from zero;
    past fp32's range, inf; inf and NaN as they are."""
    v = np.asarray(v, dtype=np.float32)
    a = np.abs(v.astype(np.float64))
    _, e = np.frexp(a)                        # a = m·2^e, m in [0.5, 1): the leading bit is 2^(e−1)
    q = np.exp2(np.maximum(e - 1, -126) - 10.0)
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.copysign(np.floor(a / q + 0.5) * q, v).astype(np.float32)
    return np.where(np.isfinite(v), r, v)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


_CASES = {
    # exactly halfway between two tf32 values: away from zero, both signs
    "ties": _from_bits([0x3F801000, 0xBF801000, 0x3F803000, 0x00001000, 0x80003000, 0x4B7FF000]),
    # just below and above a half
    "near_ties": _from_bits([0x3F800FFF, 0x3F801001, 0xBF800FFF, 0xBF801001]),
    # subnormals (tf32 keeps them), zero of both signs
    "subnormals": _from_bits([0x00000001, 0x00000FFF, 0x00001000, 0x00001FFF, 0x007FFFFF, 0x80001234, 0x0, 0x80000000]),
    # round up into the next binade, and past fp32's largest value into inf
    "binades": _from_bits([0x3FFFFFFF, 0x3FFFF000, 0xBFFFF800, 0x007FF000, 0x7F7FFFFF, 0xFF7FF000, 0x7F7FEFFF]),
    "specials": np.array([np.inf, -np.inf, 1.0, -2.5, 3.0e-39], dtype=np.float32),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_tf32_round_matches_the_model(case):
    v = _CASES[case]
    got = dense.tf32_round(torch.from_numpy(v.copy())).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(rna_tf32_model(v)))
    assert not (_bits(got) & 0x1FFF).any()  # 13 low bits zero: what the tensor core reads as tf32


def test_tf32_round_on_random_bits():
    """Every finite fp32 pattern class at once: 2^16 random bit patterns
    (NaNs stay NaN, the rest bit for bit as the model)."""
    bits = np.random.default_rng(0).integers(0, 2**32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    v = _from_bits(bits)
    got = dense.tf32_round(torch.from_numpy(v.copy())).numpy()
    nan = np.isnan(v)
    assert np.isnan(got[nan]).all()
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(rna_tf32_model(v[~nan])))


def test_tf32_split_holds_v():
    """big + small is v within 2^-21·|v| (normal values whose small part is
    normal too), both parts are tf32, and big is the rounded v."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(1 << 14) * np.exp2(rng.integers(-90, 90, 1 << 14))).astype(np.float32)
    big, small = (t.numpy() for t in dense.tf32_split(torch.from_numpy(v)))
    np.testing.assert_array_equal(_bits(big), _bits(rna_tf32_model(v)))
    assert not (_bits(big) & 0x1FFF).any() and not (_bits(small) & 0x1FFF).any()
    err = np.abs(big.astype(np.float64) + small.astype(np.float64) - v.astype(np.float64))
    assert (err <= np.exp2(-21) * np.abs(v.astype(np.float64))).all()


def test_thread_fragment_takes_eight_consecutive_channels():
    """wgmma's tf32 A fragment gives lane tq, at k-step s, k = tq and tq + 4;
    the kernels' channel order (channel 8·(kk % 4) + 2s + kk // 4 for k = 8s
    + kk) puts those on channels 8tq + 2s and 8tq + 2s + 1: over the four
    k-steps of a chunk, the thread's eight consecutive channels."""
    order = [8 * (k % 8 % 4) + 2 * (k // 8) + k % 8 // 4 for k in range(32)]
    assert sorted(order) == list(range(32))
    for tq in range(4):
        got = [order[8 * s + kk] for s in range(4) for kk in (tq, tq + 4)]
        assert got == list(range(8 * tq, 8 * tq + 8))


def _logical_rows(planes: torch.Tensor, part: int) -> torch.Tensor:
    """(chunks, 2, 8, N, 4) planes -> (32·chunks, N): row 32c + k is logical k of chunk c
    (k = 8s + kk lies in plane 2s + kk // 4 at place kk % 4)."""
    chunks, _, _, n, _ = planes.shape
    p = planes[:, part]  # (chunks, 8 planes, N, 4)
    return p.reshape(chunks, 4, 2, n, 4).permute(0, 1, 2, 4, 3).reshape(32 * chunks, n)


def _channel_of_logical(chunks: int) -> torch.Tensor:
    k = torch.arange(32)
    chan = 8 * (k % 8 % 4) + 2 * (k // 8) + k % 8 // 4
    return (torch.arange(chunks).view(-1, 1) * 32 + chan.view(1, -1)).reshape(-1)


@pytest.mark.parametrize("c", [20, 64, 96, 992])
def test_w1_tf32x3_planes_keep_the_product(c):
    """The K-major big and small planes of W1, read back in the kernels'
    channel order against t in that order, give t·W1 to 3×TF32's precision;
    each element sits where the kernels' descriptors read it, and the rows
    padded to whole chunks are zeros."""
    rng = np.random.default_rng(c)
    t = torch.from_numpy(rng.standard_normal((5, c)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((c, 128)) / np.sqrt(c)).astype(np.float32))
    planes = dense.w1_tf32x3_planes(w1)
    chunks = -(-c // 32)
    assert planes.shape == (chunks, 2, 8, 128, 4) and planes.is_contiguous() and planes.dtype == torch.float32
    big, small = dense.tf32_split(w1)
    for ch, n in ((0, 0), (c - 1, 127), (c // 2 + 3, 77)):  # planes[c, part, p, n, e] = part of w1[32c + 8e + p, n]
        q, r = divmod(ch, 32)
        assert planes[q, 0, r % 8, n, r // 8] == big[ch, n] and planes[q, 1, r % 8, n, r // 8] == small[ch, n]
    chans = _channel_of_logical(chunks)
    t_logical = torch.cat([t, t.new_zeros(5, 32 * chunks - c)], dim=1)[:, chans].double()
    tb, ts = (v.double() for v in dense.tf32_split(t_logical.float()))
    wb, ws = (_logical_rows(planes, part).double() for part in (0, 1))
    got = ts @ wb + tb @ ws + tb @ wb
    torch.testing.assert_close(got, t.double() @ w1.double(), rtol=1e-5, atol=1e-5)
    assert not (wb[chans >= c].any() or ws[chans >= c].any())


def test_w2_tf32x3_planes_are_the_conv_layout():
    """W2's planes: chunk 4·dy + kc holds kernel row dy's three taps side by
    side in N = 96 (n' = 32·dx + n) for channels 32·kc .. of g, big then small,
    in the kernels' channel order."""
    rng = np.random.default_rng(3)
    w2 = torch.from_numpy((rng.standard_normal((3, 3, 128, 32)) / 34.0).astype(np.float32))
    planes = dense.w2_tf32x3_planes(w2)
    assert planes.shape == (12, 2, 8, 96, 4) and planes.is_contiguous()
    big, small = dense.tf32_split(w2)
    chans = _channel_of_logical(4)  # logical row 32·kc + k of a kernel row -> channel of g
    for dy in range(3):
        for part, ref in ((0, big), (1, small)):
            rows = _logical_rows(planes[4 * dy:4 * dy + 4], part)  # (128 logical k, 96)
            want = ref[dy][:, chans].permute(1, 0, 2).reshape(128, 96)  # [k][dx·32 + n]
            assert torch.equal(rows, want)


@pytest.mark.parametrize("c, ld, start, padded", [
    (20, 52, 0, False),   # C % 4 == 0, ld % 4 == 0, aligned: the kernels read x as it is
    (64, 256, 32, False),  # a channel slice of a dense block's buffer
    (20, 53, 0, True),    # an odd pixel stride
    (21, 53, 0, True),    # C % 4 != 0
    (32, 64, 1, True),    # 4 bytes past a 16-byte boundary
])
def test_f32_operands_pad_only_what_16_byte_loads_cannot_read(c, ld, start, padded):
    """The fp32 wrappers hand the kernels a1, b1 zero-padded to whole
    32-channel chunks, and x as it is where its 16-byte loads can read it,
    else a contiguous copy with C zero-padded to a multiple of 4."""
    x = torch.randn(2, 3, 5, ld)[..., start:start + c]
    a1, b1 = torch.rand(c), torch.rand(c)
    xk, a1k, b1k, ck, ldk = dense._f32_operands(x, a1, b1)
    c32 = -(-c // 32) * 32
    for got, want in ((a1k, a1), (b1k, b1)):
        assert got.shape == (c32,) and torch.equal(got[:c], want) and not got[c:].any()
    if padded:
        c4 = -(-c // 4) * 4
        assert (ck, ldk) == (c4, c4) and xk.is_contiguous() and xk.data_ptr() % 16 == 0
        assert torch.equal(xk[..., :c], x) and not xk[..., c:].any()
    else:
        assert xk is x and (ck, ldk) == (c, ld)


def test_tf32x3_selfcheck_plain_version_and_its_checks():
    """On the CPU the self-check is its plain version, reps · a · b in
    float64; it refuses what its kernel does not take."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 96)).astype(np.float32))
    got = dense.tf32x3_selfcheck(a, b, reps=3)
    torch.testing.assert_close(got, (3 * (a.double() @ b.double())).float(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="N 96 or 128"):
        dense.tf32x3_selfcheck(a, b[:, :64])
    with pytest.raises(TypeError, match="float32"):
        dense.tf32x3_selfcheck(a.double(), b)


# --- the kernels' arithmetic against the JAX references ---------------------

SHAPES = [(2, 8, 16, 64), (1, 10, 17, 20), (1, 9, 12, 96)]  # a 8x16 tile; a ragged C and W; C past one chunk


def _args(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.uniform(size=shape).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.3, c).astype(np.float32), (rng.standard_normal((c, 128)) / np.sqrt(c)).astype(np.float32),
            rng.uniform(0.5, 1.5, 128).astype(np.float32), rng.normal(0, 0.3, 128).astype(np.float32),
            (rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's fp32 references at each shape, computed once."""
    out = {}
    for i, shape in enumerate(SHAPES):
        args = _args(shape, 20 + i)
        j = [jnp.asarray(a) for a in args]
        out[shape] = (args, np.asarray(jpd._layer_reference(*j)),
                      tuple(np.asarray(s) for s in jpd._h_stats_reference(*j[:4])))
    return out


def _split64(a):
    big, small = dense.tf32_split(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)))
    return big.double().numpy(), small.double().numpy()


def _fma32(x, a, b):
    """fmaf: x·a + b rounded once to fp32."""
    return (x.astype(np.float64) * a + b).astype(np.float32)


def _h_emulated(x, a1, b1, w1):
    """h = t·W1 as the kernels take it: t = relu(fma(x, a1, b1)) in fp32, split,
    the three products summed in float64, then fp32 (the accumulators)."""
    t = np.maximum(_fma32(x, a1, b1), 0).reshape(-1, x.shape[-1])
    tb, ts = _split64(t)
    wb, ws = _split64(w1)
    return (ts @ wb + tb @ ws + tb @ wb).astype(np.float32)


def _k1_emulated(x, a1, b1, w1, a2, b2, w2):
    bsz, hh, ww, _ = x.shape
    h = _h_emulated(x, a1, b1, w1)
    g = np.maximum(_fma32(h, a2, b2), 0).reshape(bsz, hh, ww, 128)
    gb, gs = (np.pad(p, ((0, 0), (1, 1), (1, 1), (0, 0))) for p in _split64(g))  # zero outside the image
    wb, ws = _split64(w2)
    f = np.zeros((bsz, hh, ww, 32))
    for dy in range(3):
        for dx in range(3):
            win = np.s_[:, dy:dy + hh, dx:dx + ww, :]
            f += gs[win] @ wb[dy, dx] + gb[win] @ ws[dy, dx] + gb[win] @ wb[dy, dx]
    return f.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_3xtf32_arithmetic_matches_jax(jax_refs, shape):
    args, ref, _ = jax_refs[shape]
    np.testing.assert_allclose(_k1_emulated(*args), ref, **K1_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_3xtf32_arithmetic_matches_jax(jax_refs, shape):
    """The statistics from 3×TF32 h, reduced in float64 as the kernel's
    float64 partials are, against JAX's two-pass fp32 statistics."""
    args, _, (jm, jv) = jax_refs[shape]
    h = _h_emulated(*args[:4]).astype(np.float64)
    mean = h.mean(axis=0)
    var = np.maximum((h * h).mean(axis=0) - mean * mean, 0.0)
    np.testing.assert_allclose(mean.astype(np.float32), jm, **K2_MEAN_TOL)
    np.testing.assert_allclose(var.astype(np.float32), jv, **K2_VAR_TOL)
