"""The port's frequency decomposition (K3's plain version and its autograd
Function, fdgan_tpu_torch.ops.filters / .freq) against the JAX package's
XLA filters and its Pallas kernel, run in interpret mode as its own tests
run it. The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.ops import filters as jfilters
from fdgan_tpu.ops.pallas_filters import frequency_fuse_pallas
from fdgan_tpu_torch.ops import filters, freq

F32_TOL = dict(atol=2e-4, rtol=0)  # tests/test_pallas_filters.py:17
SHAPES = [(2, 32, 32, 3), (1, 24, 40, 3)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs():
    refs = {}
    for shape in SHAPES:
        x = jnp.asarray(_x(shape))
        refs[shape] = {
            "xla": np.asarray(jfilters.frequency_fuse(x)),
            "pallas": np.asarray(frequency_fuse_pallas(x, interpret=True)),
        }
    # the Pallas kernel does not trace in bf16 (it stores fp32 sums into
    # refs of x's dtype), so it runs in fp32 on the bf16 values
    xb = torch.from_numpy(_x(SHAPES[0])).bfloat16().float().numpy()
    refs["bf16"] = np.asarray(frequency_fuse_pallas(jnp.asarray(xb), interpret=True))
    return refs


def test_taps_match_jax():
    t = jfilters.gaussian_1d(15, 3.0)
    np.testing.assert_array_equal(filters.blur_taps(), (t / t.sum()).astype(np.float32))
    np.testing.assert_array_equal(filters.gaussian_1d(), t)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(jax_refs, shape, ref):
    got = filters.frequency_fuse(torch.from_numpy(_x(shape)))
    assert got.shape == shape[:3] + (9,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[..., :3].numpy(), _x(shape))
    np.testing.assert_allclose(got.numpy(), jax_refs[shape][ref], **F32_TOL)


def test_function_takes_the_plain_version_on_cpu():
    x = torch.from_numpy(_x(SHAPES[1]))
    freq.reset_launch_count()
    got = freq.frequency_fuse(x)
    assert freq.k3_launches == 0
    torch.testing.assert_close(got, filters.frequency_fuse(x), rtol=0, atol=0)


def test_bf16_matches_pallas_interpreter(jax_refs):
    """The interpreter runs in fp32 on the same bf16 values. RGB is copied.
    HF sums bf16 values in fp32, exactly, on both sides; the port rounds it
    to bf16 once. LF: the port normalises in bf16. x − mean (|·| < 0.6)
    rounds by at most 2^-9, 8.8e-3 after dividing by std ≥ 0.224; the
    quotient (|·| < 2.7) by at most 2^-7. The Gaussian's unit-sum weights
    carry that 1.66e-2 to LF, whose own rounding adds at most 2^-7:
    atol 2.5e-2."""
    xb = torch.from_numpy(_x(SHAPES[0])).bfloat16()
    got = freq.frequency_fuse(xb)
    assert got.dtype == torch.bfloat16
    ref = torch.from_numpy(np.array(jax_refs["bf16"]))
    torch.testing.assert_close(got[..., :3].float(), ref[..., :3], rtol=0, atol=0)
    torch.testing.assert_close(got[..., 6:], ref[..., 6:].bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(got[..., 3:6].float(), ref[..., 3:6], rtol=0, atol=2.5e-2)


def test_gradient_matches_jax_grad():
    x = _x(SHAPES[1], seed=1)
    ct = np.random.default_rng(2).standard_normal(SHAPES[1][:3] + (9,)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jfilters.frequency_fuse(v) * ct))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = freq.frequency_fuse(xt)
    assert type(y.grad_fn).__name__ == "_FrequencyFuseBackward"
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_rejects_images_the_reflect_pad_does_not_fit():
    with pytest.raises(ValueError, match="exceed"):
        filters.frequency_fuse(torch.zeros(1, 7, 16, 3))


@pytest.mark.parametrize("c", [0, 1, 2])
def test_bf16_normalise_by_reciprocal_is_exact(c):
    """K3 normalises bf16 x as rnd(rnd(x − mean)·(1/std)) where the plain
    version divides (``filters.normalise`` in bf16). For every finite bf16
    d = rnd(x − mean) the fp32 product with rn(1/std) rounds to the bf16 of
    the quotient: both sides of the claim in ``csrc/freq_filters.cu``."""
    d = torch.arange(2**16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    d = d[torch.isfinite(d.float())]
    assert d.numel() == 65280
    std = torch.tensor(filters.IMAGENET_STD[c], dtype=torch.bfloat16)
    inv = np.float32(1.0) / np.float32(std.float().item())  # __frcp_rn: the correctly rounded reciprocal
    by_product = (d.float() * torch.tensor(inv)).bfloat16()
    torch.testing.assert_close(by_product, d / std, rtol=0, atol=0, equal_nan=True)
