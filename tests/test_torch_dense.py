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


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_dense_block_matches_jax(mode):
    c, layers = 32, 3
    params, block = _random_block(c, layers, seed=3)
    x = np.random.default_rng(4).uniform(size=(1, 16, 16, c)).astype(np.float32)
    fused = jax.jit(lambda p, xx: jpd.dense_block_fused(p, xx, mode=mode, interpret=True))
    ref = np.asarray(fused(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = dense.dense_block_fused(list(block.children()), torch.from_numpy(x), mode=mode)
    assert got.shape == (1, 16, 16, c + 32 * layers)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_dense_block_rejects_unknown_impl_and_mode():
    _, block = _random_block(32, 1, seed=5)
    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError, match="impl"):
        dense.dense_block_fused(list(block.children()), x, impl="xla")
    with pytest.raises(ValueError, match="BN mode"):
        dense.dense_block_fused(list(block.children()), x, mode="eval")
