"""The port's DCPDN models and densenet_dehaze (fdgan_tpu_torch.models.dcpdn,
.densenet_dehaze) against the JAX package's, on the CPU.

Each family's parameters are one random tree (``zoo_params``) of the JAX
init's structure, crossed to torch with ``state_dict_from_jax`` and the
family's ConvTranspose2d set. Inputs come from ``np.random.default_rng(0)``.
The JAX references are jitted once per module and family; torch runs on one
intra-op thread (see tests/test_torch_remat.py). Sizes: the U-Nets and
``dehaze_physical`` at 1×256², the smallest size their eight stride-2
levels allow; ``dense_g`` and ``densenet_dehaze`` at 1×64².

``dehaze_physical`` composes J = (I − A)/(|t| + 1e-10) + A. At random
weights its transmission map t = tanh(·) crosses 0, where that division
turns fp32 rounding (1e-5 in t) into differences of 1e6 in J: no tolerance
holds there, in either package. So ``tran_dense.refine3``'s bias is set to
1, which puts t in (0.5, 0.9), the physical range of a transmission map;
the other outputs are compared as they come.

JAX's dropout draws from ``jax.random`` and the port's from a
``torch.Generator``: the two masks cannot be the same, so with dropout on
the port is held to its own contract (the keep rate and the 1/keep scale),
and with dropout off to JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.models import dcpdn as jdcpdn
from fdgan_tpu.models import densenet_dehaze as jdd
from fdgan_tpu.models.blocks import BNCtx as JBNCtx
from fdgan_tpu_torch.io.torch_import import (
    DENSE_G_TRANSPOSED,
    DENSENET_DEHAZE_TRANSPOSED,
    UNET_TRANSPOSED,
    DEHAZE_TRANSPOSED,
    state_dict_from_jax,
)
from fdgan_tpu_torch.models import dcpdn
from fdgan_tpu_torch.models.densenet_dehaze import DenseNetDehaze
from fdgan_tpu_torch.nn import layers
from fdgan_tpu_torch.ops import dense, stats
from zoo_params import random_params

FAST_TOL = dict(atol=5e-5, rtol=1e-4)  # tests/test_torch_fdgan_fast.py
# dense_g in batch mode at 1×64²: its decoder's first bottleneck and
# transition normalise 2×2 maps, four values per channel with a std down to
# 0.02, which multiplies the two packages' fp32 differences (1e-6 before
# those BNs) by ~50; the output is held to the JAX suite's own tolerance for
# this family against the torch oracle (tests/test_dcpdn_oracle.py:30).
# Running mode, and the recorded statistics, stay at FAST_TOL and STATS_TOL.
ORACLE_TOL = dict(atol=5e-4, rtol=1e-3)
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
MODES = ["batch", "running"]
KEY = jax.random.PRNGKey(0)


def _jax_bn(apply):
    """A family's JAX apply as f(params, x, mode) → (outputs, stats)."""
    def run(p, x, mode):
        col = {}
        return apply(p, x, JBNCtx(mode, col)), col
    return run


# name: (JAX init, JAX f(params, x, mode) -> (out, stats), port module, transposed set, size)
FAMILIES = {
    "unetg": (lambda: jdcpdn.unet_g_init(KEY), _jax_bn(lambda p, x, bn: jdcpdn.unet_g_apply(p, x, bn)),
              lambda: dcpdn.UNetG(), UNET_TRANSPOSED, 256),
    "unetg2": (lambda: jdcpdn.unet_g2_init(KEY), _jax_bn(lambda p, x, bn: jdcpdn.unet_g2_apply(p, x, bn)),
               lambda: dcpdn.UNetG2(), UNET_TRANSPOSED, 256),
    "dehaze": (lambda: jdcpdn.dehaze_physical_init(KEY),
               _jax_bn(lambda p, x, bn: jdcpdn.dehaze_physical_apply(p, x, bn)),
               lambda: dcpdn.DehazePhysical(), DEHAZE_TRANSPOSED, 256),
    "dense": (lambda: jdcpdn.dense_g_init(KEY, pyramid=False),
              _jax_bn(lambda p, x, bn: jdcpdn.dense_g_apply(p, x, pyramid=False, bn=bn)),
              lambda: dcpdn.DenseG(pyramid=False), DENSE_G_TRANSPOSED, 64),
    "dense2": (lambda: jdcpdn.dense_g_init(KEY, pyramid=True),
               _jax_bn(lambda p, x, bn: jdcpdn.dense_g_apply(p, x, pyramid=True, bn=bn)),
               lambda: dcpdn.DenseG(pyramid=True), DENSE_G_TRANSPOSED, 64),
    "densenet_dehaze": (lambda: jdd.init(KEY),
                        lambda p, x, mode: (lambda col: (jdd.apply(p, x, bn_mode=mode, stats_out=col), col))({}),
                        DenseNetDehaze, DENSENET_DEHAZE_TRANSPOSED, 64),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _as_tuple(y):
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


@pytest.fixture(scope="module")
def cases():
    """Lazily, per family: (port model, x, {mode: JAX outputs}, JAX batch stats)."""
    cache = {}

    def get(name):
        if name not in cache:
            init, jrun, build, transposed, size = FAMILIES[name]
            params = random_params(init)
            if name == "dehaze":
                params["tran_dense"]["refine3"]["bias"][:] = 1.0
            x = np.random.default_rng(0).uniform(size=(1, size, size, 3)).astype(np.float32)
            refs, jstats = {}, None
            for mode in MODES:
                y, col = jax.jit(jrun, static_argnums=2)(params, jnp.asarray(x), mode)
                refs[mode] = [np.asarray(t) for t in _as_tuple(y)]
                if mode == "batch":
                    jstats = {k: tuple(np.asarray(t) for t in v) for k, v in col.items()}
            model = build()
            model.load_state_dict(state_dict_from_jax(params, transposed), strict=True)
            cache[name] = (model, x, refs, jstats)
        return cache[name]

    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax(cases, name, mode):
    """Every output (all four of ``dehaze_physical``) within FAST_TOL."""
    model, x, refs, _ = cases(name)
    with torch.inference_mode():
        got = _as_tuple(model(torch.from_numpy(x), bn_mode=mode))
    assert len(got) == len(refs[mode])
    tol = ORACLE_TOL if name in ("dense", "dense2") and mode == "batch" else FAST_TOL
    for i, (g, want) in enumerate(zip(got, refs[mode])):
        assert g.shape == want.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, **tol, err_msg=f"{name} output {i}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_stats_out_matches_jax(cases, name):
    """Batch mode records every live BN under JAX BNCtx's keys (dead ones
    never run), (mean, unbiased var) within 1e-4."""
    model, x, _, jstats = cases(name)
    got = {}
    with torch.inference_mode():
        model(torch.from_numpy(x), bn_mode="batch", stats_out=got)
    assert set(got) == set(jstats) and got
    assert not any(k.startswith(("tran_est.", "batch1", "batchnorm1")) for k in got)
    for k, (jm, jv) in jstats.items():
        np.testing.assert_allclose(got[k][0].numpy(), jm, **STATS_TOL, err_msg=k)
        np.testing.assert_allclose(got[k][1].numpy(), jv, **STATS_TOL, err_msg=k)
    running = {}
    with torch.inference_mode():
        model(torch.from_numpy(x), bn_mode="running", stats_out=running)
    assert running == {}


def test_dropout_off_is_jax_and_on_keeps_its_rate_and_scale(cases):
    """``train=False`` (and ``train=True`` without a generator) is the JAX
    forward; ``train=True`` with a generator zeroes about half of each of
    dlayer8, 7 and 6's outputs and doubles the rest, the same mask for the
    same seed."""
    model, x, refs, _ = cases("unetg2")
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        off = model(xt, bn_mode="running", train=False, generator=torch.Generator().manual_seed(1))
        no_gen = model(xt, bn_mode="running", train=True)
        on = [model(xt, bn_mode="running", train=True, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    np.testing.assert_allclose(off.numpy(), refs["running"][0], **FAST_TOL)
    torch.testing.assert_close(no_gen, off, rtol=0, atol=0)
    torch.testing.assert_close(on[0], on[1], rtol=0, atol=0)
    assert not torch.equal(on[0], off) and not torch.equal(on[0], on[2])
    # the op itself: rate and 1/keep scale
    ones = torch.ones(200_000)
    y = layers.dropout(ones, 0.5, True, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(layers.dropout(ones, 0.5, False, torch.Generator()), ones)


def test_densenet_dehaze_remat_gradients_equal_no_remat(cases):
    """Remat (one non-reentrant checkpoint per dense block and transition)
    changes no gradient (atol 1e-6); with ``stats_out`` it is off, as in JAX."""
    model, x, _, _ = cases("densenet_dehaze")
    xt = torch.from_numpy(x[:, :32, :32])
    grads = {}
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        dense.reset_launch_counts()
        model(xt, bn_mode="batch", remat=remat).square().mean().backward()
        grads[remat] = [p.grad.clone() for p in model.parameters() if p.grad is not None]
    assert len(grads[True]) == len(grads[False]) > 0
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_batch_norm_inputs_are_channels_last(cases, name, monkeypatch):
    """On the card ``channel_stats`` takes NHWC memory only and raises on
    anything else; here every BN input of a bf16 batch-BN forward is checked
    for that layout before the twin runs (``ops.common.pixel_stride``), and
    the forward stays finite."""
    from fdgan_tpu_torch.ops.common import pixel_stride

    model, x, _, _ = cases(name)
    seen = []

    def checked(t):
        pixel_stride(t)
        seen.append(t.shape[-1])
        return stats.channel_stats(t)

    monkeypatch.setattr(layers, "channel_stats", checked)
    monkeypatch.setattr(dense, "channel_stats", checked)
    with torch.inference_mode():
        y = _as_tuple(model(torch.from_numpy(x).bfloat16(), bn_mode="batch"))
    assert seen and all(torch.isfinite(t.float()).all() for t in y)


def test_pool_by_height_is_avg_pool_of_height():
    """The airlight's global average: JAX ``avg_pool(atp, H)``, the W // H
    windows of H×H (W need not be a multiple of H), as ``F.avg_pool2d``."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 8, 20)).astype(np.float32))
    for t in (x, x.contiguous(memory_format=torch.channels_last), x[..., :8]):
        torch.testing.assert_close(dcpdn._pool_by_height(t), torch.nn.functional.avg_pool2d(t, t.shape[2]),
                                   atol=1e-6, rtol=1e-6)
