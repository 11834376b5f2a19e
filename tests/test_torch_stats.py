"""The port's per-channel batch statistics (fdgan_tpu_torch.ops.stats): the
``channel_stats`` kernel's twin against JAX ``_batch_stats``, from whole
tensors and from channel slices of a wider buffer, and its gradient.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); here a CPU tensor takes the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.nn.layers import _batch_stats
from fdgan_tpu_torch.nn import layers
from fdgan_tpu_torch.ops import stats


def _jax_stats(x: np.ndarray, dtype):
    m, v = _batch_stats(jnp.asarray(x, dtype), axis=(0, 1, 2))
    return np.asarray(m), np.asarray(v)


def _buffer_slice(x: torch.Tensor, ld: int, c0: int) -> torch.Tensor:
    """x as channels [c0, c0 + C) of a (B, H, W, ld) buffer: a dense layer's
    32 new channels inside its block's concat."""
    buf = torch.full(tuple(x.shape[:3]) + (ld,), 7.0, dtype=x.dtype)
    buf[..., c0:c0 + x.shape[-1]] = x
    return buf[..., c0:c0 + x.shape[-1]]


# bf16: the same bf16 values, one-pass E[x²]−μ² in fp32 on both sides, sums in
# another order (tests/test_torch_layers.py's bf16 tolerances)
@pytest.mark.parametrize("shape,ld,c0", [
    ((2, 6, 5, 32), None, 0),     # a whole tensor
    ((2, 6, 5, 32), 256, 64),     # block 1's third layer output: a slice of its 256-channel concat
    ((1, 9, 7, 64), 96, 0),       # a block input at the front of its buffer
])
def test_channel_stats_twin_matches_jax_bf16(shape, ld, c0):
    x = (np.random.default_rng(0).standard_normal(shape) * 2.0 + 3.0).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    if ld is not None:
        xt = _buffer_slice(xt, ld, c0)
        assert xt.stride(2) == ld
    stats.reset_launch_count()
    mean, var = stats.channel_stats(xt)
    assert stats.launches == 0  # a CPU tensor: the twin
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (shape[-1],)
    jm, jv = _jax_stats(x, jnp.bfloat16)
    np.testing.assert_allclose(mean.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), jv, rtol=1e-4, atol=1e-5)


def test_channel_stats_fp32_is_two_pass_and_matches_jax():
    x = (np.random.default_rng(1).standard_normal((2, 4, 6, 16)) + 4096.0).astype(np.float32)
    mean, var = stats.channel_stats(torch.from_numpy(x))
    jm, jv = _jax_stats(x, jnp.float32)
    np.testing.assert_allclose(mean.numpy(), jm, rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), jv, rtol=1e-3)  # one-pass would lose it to cancellation at 4096


def test_channel_stats_gradient_is_the_formulas():
    """The Function's backward (the closed-form VJP) from a buffer slice,
    against the exact VJP in float64 at the same statistics, and against
    autograd through the one-pass formula written out (the twin's VJP).

    Tolerances: the closed form computes in fp32 and rounds once to bf16
    (8 significant bits), so it is within 2^-8 relative of the exact value,
    plus fp32's error on b + a·x (2^-16 of the largest value covers it). The
    twin's VJP rounds its two terms, T1 = (ct_mean − 2·ct_var·mean)/n and
    T2 = 2·ct_var·x/n, to bf16 before it adds them and rounds the sum: the
    two differ by at most 2^-8·(|T1| + |T2|) + 2^-7·|dx|."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((2, 5, 6, 16)) * 2.0 + 3.0).astype(np.float32)).bfloat16()
    cm, cv = (torch.from_numpy(rng.standard_normal(16).astype(np.float32)) for _ in range(2))
    xs = _buffer_slice(x, 48, 16).detach().requires_grad_(True)
    mean, var = stats.channel_stats(xs)
    assert type(mean.grad_fn).__name__ == "GeneratedBackwardFor_fdgan_channel_stats_defaultBackward"
    (mean * cm + var * cv).sum().backward()
    assert xs.grad.dtype == torch.bfloat16 and xs.grad.shape == x.shape
    n = 2 * 5 * 6
    exact = cm.double() / n + cv.double() * 2 * (x.double() - mean.double()) / n
    scale = exact.abs().max().item()
    torch.testing.assert_close(xs.grad.double(), exact, rtol=2.0**-8, atol=2.0**-16 * scale)
    xr = x.clone().requires_grad_(True)
    m = xr.mean(dim=(0, 1, 2), dtype=torch.float32)
    v = (xr.float().square().mean(dim=(0, 1, 2)) - m.square()).clamp_min(0.0)
    (m * cm + v * cv).sum().backward()
    terms = ((cm.double() - 2 * cv.double() * mean.double()).abs().max() + (2 * cv.double() * x.double()).abs().max()) / n
    torch.testing.assert_close(xs.grad.double(), xr.grad.double(), rtol=2.0**-7, atol=2.0**-8 * terms.item())


def test_channel_stats_gradient_where_the_clamp_bites():
    """A constant channel has var 0 (the clamp at 0 bites where fp32 rounds
    E[x²] − μ² below 0): only ct_mean/n reaches it, as through autograd."""
    x = torch.full((2, 3, 4, 8), 0.3, dtype=torch.bfloat16).requires_grad_(True)
    mean, var = stats.channel_stats(x)
    (mean.sum() * 2.0 + var.sum() * 5.0).backward()
    assert torch.equal(var, torch.zeros(8))
    assert torch.equal(x.grad, torch.full_like(x, 2.0 / 24))


def test_batch_norm_routes_by_impl():
    """``nn.layers.batch_stats`` over an NCHW channels_last tensor is the
    NHWC statistics: ``kernels`` through ``channel_stats`` (its twin here),
    ``plain`` through the plain formula; both agree bit for bit on the CPU."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 5, 24)).astype(np.float32))
    nchw = x.bfloat16().permute(0, 3, 1, 2)
    for impl in ("kernels", "plain"):
        got = layers.batch_stats(nchw, impl)
        want = stats.one_pass_reference(x.bfloat16())
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        layers.batch_stats(nchw, "fast")


def test_launch_refuses_a_cpu_tensor_and_bad_layouts():
    """The kernel's wrapper runs only on the card, and checks the layout on
    any device before it builds anything."""
    x = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="on cuda"):
        stats._launch(x)
    with pytest.raises(ValueError, match="NHWC-contiguous"):
        stats.pixel_stride(x.permute(0, 2, 1, 3))
