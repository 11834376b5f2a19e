"""Port layers (fdgan_tpu_torch.nn.layers) against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
port's NCHW tensors are the NHWC arrays permuted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.nn import layers as jl
from fdgan_tpu_torch.nn import layers as tl


def _nchw(x_nhwc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _bn_params(rng, c):
    return {
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(0, 0.3, c).astype(np.float32),
        "mean": rng.normal(0, 0.1, c).astype(np.float32),
        "var": (1.0 + rng.uniform(0, 0.1, c)).astype(np.float32),
    }


def _port_bn(p) -> tl.BatchNorm:
    bn = tl.BatchNorm(len(p["scale"]))
    bn.load_state_dict({
        "weight": torch.from_numpy(p["scale"]),
        "bias": torch.from_numpy(p["bias"]),
        "running_mean": torch.from_numpy(p["mean"]),
        "running_var": torch.from_numpy(p["var"]),
    })
    return bn


# fp32: two-pass on both sides, summed in another order. bf16: the same
# bf16 inputs, one-pass E[x²]−μ² in fp32 on both sides.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_stats_matches_jax(np_rng, dtype):
    x = (np_rng.standard_normal((2, 6, 5, 7)) * 2.0 + 3.0).astype(np.float32)
    jm, jv = jl._batch_stats(jnp.asarray(x, dtype), axis=(0, 1, 2))
    tm, tv = tl.batch_stats(_nchw(x, getattr(torch, dtype)))
    assert tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


def test_batch_stats_fp32_is_two_pass():
    """A large offset cancels catastrophically in one-pass E[x²]−μ²; the
    fp32 path must keep the variance."""
    x = torch.full((1, 1, 64, 64), 4096.0) + torch.arange(4096.0).reshape(1, 1, 64, 64) % 2
    _, var = tl.batch_stats(x)
    np.testing.assert_allclose(var.numpy(), [0.25], rtol=1e-6)


# bf16: the final multiply-add rounds to bf16 on both sides (two roundings);
# 2^-7 relative plus an absolute floor covers one bf16 step either way.
@pytest.mark.parametrize("mode", ["batch", "running"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2.0 ** -7)])
def test_batch_norm_matches_jax(np_rng, mode, dtype, tol):
    c = 7
    x = (np_rng.standard_normal((2, 6, 5, c)) * 1.5 + 0.5).astype(np.float32)
    p = _bn_params(np_rng, c)
    ref = jl.batch_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, dtype), mode=mode)
    got = tl.batch_norm(_port_bn(p), _nchw(x, getattr(torch, dtype)), mode=mode)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_avg_pool_and_upsample_match_jax(np_rng):
    x = np_rng.standard_normal((2, 7, 9, 3)).astype(np.float32)  # odd sizes: floor
    np.testing.assert_allclose(
        _nhwc(tl.avg_pool(_nchw(x), 2)), np.asarray(jl.avg_pool(jnp.asarray(x), 2)), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_array_equal(
        _nhwc(tl.upsample_nearest(_nchw(x), 2)), np.asarray(jl.upsample_nearest(jnp.asarray(x), 2))
    )


def test_conv2d_matches_jax(np_rng):
    x = np_rng.standard_normal((2, 8, 6, 5)).astype(np.float32)
    k = np_rng.standard_normal((3, 3, 5, 4)).astype(np.float32)  # HWIO
    b = np_rng.standard_normal(4).astype(np.float32)
    ref = jl.conv2d({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, jnp.asarray(x), padding=1)
    got = tl.conv2d(_nchw(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b), padding=1)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_batchnorm_state_dict_keys():
    """Exactly the reference checkpoints' four entries: no num_batches_tracked."""
    bn = tl.BatchNorm(5)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var"]
    np.testing.assert_array_equal(bn.running_var.numpy(), np.ones(5, np.float32))


def test_batch_norm_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown BN mode"):
        tl.batch_norm(tl.BatchNorm(3), torch.zeros(1, 3, 2, 2), mode="eval")
