"""The port's AOT export (fdgan_tpu_torch.io.export) on the CPU, against
JAX ``fdgan_fast.apply`` and the port's eager forward.

Two programs are traced, each once for the module: an fp32 batch-BN
program with a symbolic batch and the weights as an argument
(``bake_params=False``), and an fp32 running-BN program of batch 2 with
the weights inside. On a CPU tensor the ``fdgan::`` ops in them run the
kernels' twins. The JAX reference is one jitted function of both BN modes.
Weights cross with ``state_dict_from_jax`` from random trees over
``jax.eval_shape`` of the init (``zoo_params``).
"""

import collections
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models import fdgan_fast as jfast
from fdgan_tpu_torch.io import export
from fdgan_tpu_torch.io.torch_import import state_dict_from_jax
from fdgan_tpu_torch.models import fdgan_fast
from fdgan_tpu_torch.models.fdgan import FDGAN
from zoo_params import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_fdgan_fast.py's tolerance for the port's fast forward against JAX's
FAST_TOL = dict(atol=5e-5, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    params = random_params(lambda: jfdgan.init(jax.random.PRNGKey(0)), 0)
    x = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    both = jax.jit(lambda p, x: (jfast.apply(p, x, bn_mode="batch"), jfast.apply(p, x, bn_mode="running")))
    refs = dict(zip(("batch", "running"), (np.asarray(y) for y in both(params, x))))
    model = FDGAN()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    other = FDGAN(generator=torch.Generator().manual_seed(1))  # a second checkpoint
    return model.eval(), other.eval(), x, refs


@pytest.fixture(scope="module")
def unbaked(case):
    return export.export_forward(case[0], image_size=32, batch="poly", precision="fp32", bn_mode="batch",
                                 bake_params=False, device="cpu")


@pytest.fixture(scope="module")
def baked(case):
    return export.export_forward(case[0], image_size=32, batch=2, precision="fp32", bn_mode="running", device="cpu")


def _ops(exported):
    return collections.Counter(str(n.target) for n in exported.graph.nodes
                               if n.op == "call_function" and str(n.target).startswith("fdgan."))


def _eager(model, x, mode):
    with torch.inference_mode():
        return fdgan_fast.apply(model, torch.from_numpy(x), bn_mode=mode).numpy()


def _run_unbaked(exported, model, x):
    with torch.inference_mode():
        return exported.module()(dict(model.state_dict()), torch.from_numpy(x)).numpy()


def test_the_programs_hold_the_kernel_ops(unbaked, baked):
    """K1 as fdgan.dense_layer 42 times in both BN modes, K2 42 times in
    batch BN; fp32 statistics take no channel_stats (bf16 only:
    tests/test_torch_native_runner.py counts its 45)."""
    assert _ops(unbaked) == {"fdgan.dense_layer.default": 42, "fdgan.h_stats.default": 42}
    assert _ops(baked) == {"fdgan.dense_layer.default": 42}


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_exported_program_matches_jax_fdgan_fast(case, unbaked, baked, mode):
    model, _, x, refs = case
    if mode == "batch":
        got = _run_unbaked(unbaked, model, x)
    else:
        with torch.inference_mode():
            got = baked.module()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, refs[mode], **FAST_TOL)


@pytest.mark.parametrize("n", [1, 3])
def test_poly_program_runs_a_batch_not_named_at_export(case, unbaked, n):
    """Traced at batch 2, run at 1 and 3, against the port's eager forward."""
    model = case[0]
    x = np.random.default_rng(2 + n).uniform(size=(n, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(_run_unbaked(unbaked, model, x), _eager(model, x, "batch"), **FAST_TOL)


def test_unbaked_program_serves_two_checkpoints(case, unbaked):
    model, other, x, _ = case
    got = _run_unbaked(unbaked, other, x)
    np.testing.assert_allclose(got, _eager(other, x, "batch"), **FAST_TOL)
    assert np.abs(got - _run_unbaked(unbaked, model, x)).max() > 1e-2  # the weights do reach the program
    with pytest.raises(ValueError, match="bake_params=True"):
        export.ArtifactRunner(unbaked)


def test_saved_program_loads_without_model_code(case, baked, tmp_path):
    """save_exported / load_exported in a fresh interpreter where the model
    code cannot be imported: the program runs with ops.library alone, to
    the in-process result's bits."""
    x = case[2]
    path = str(tmp_path / "netG_32.pt2")
    assert export.save_exported(path, baked) > 10_000_000  # the weights are inside
    np.save(tmp_path / "x.npy", x)
    script = f"""
import sys
for name in ("jax", "jaxlib", "fdgan_tpu", "fdgan_tpu_torch.models"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)
from fdgan_tpu_torch.io.export import load_exported
ep = load_exported({path!r})
with torch.inference_mode():
    y = ep.module()(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))
np.save({str(tmp_path / 'y.npy')!r}, y.numpy())
"""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with torch.inference_mode():
        want = baked.module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


def test_artifact_runner_pads_ragged_sizes_and_crops_back(case, baked):
    """Reflect-padded bottom and right (edge where the pad exceeds the
    image), cropped back; the fixed batch of 2 filled by cycling; each
    image against the eager forward on its padded self (running BN: an
    image's result is its own)."""
    model = case[0]
    rng = np.random.default_rng(7)
    images = [rng.uniform(size=s).astype(np.float32) for s in ((24, 32, 3), (32, 20, 3), (5, 7, 3))]
    runner = export.ArtifactRunner(baked)
    assert (runner.batch, runner.height, runner.width, runner.input) == (2, 32, 32, "float32")
    outs = runner(images)
    for img, out in zip(images, outs):
        padded = runner._pad_hw(img, 32, 32)
        mode = "reflect" if img.shape[0] > 32 - img.shape[0] and img.shape[1] > 32 - img.shape[1] else "edge"
        np.testing.assert_array_equal(padded, np.pad(img, ((0, 32 - img.shape[0]), (0, 32 - img.shape[1]), (0, 0)),
                                                     mode=mode))
        want = _eager(model, padded[None], "running")[0, :img.shape[0], :img.shape[1]]
        assert out.shape == img.shape
        np.testing.assert_allclose(out, want, **FAST_TOL)
    with pytest.raises(ValueError, match="exceeds"):
        runner([np.zeros((40, 8, 3), np.float32)])


@pytest.mark.parametrize("kwargs, match", [
    (dict(precision="fp16"), "precision"),
    (dict(bn_mode="eval"), "bn_mode"),
    (dict(io="int8"), "io"),
    (dict(batch="many"), "batch"),
    (dict(image_size=30), "divisible by 8"),
    (dict(device="tpu"), "cuda or cpu"),
    (dict(device=["cuda", "cpu"]), "one device"),
])
def test_export_refuses_what_it_cannot_trace(kwargs, match):
    args = dict(image_size=32, device="cpu") | kwargs
    with pytest.raises(ValueError, match=match):
        export.export_forward(None, **args)


def test_bundle_signature_and_its_fixed_batch(baked, tmp_path):
    """The .sig's two lines from the program (the JAX bundle's format); a
    batch-polymorphic bundle is refused before anything is traced."""
    assert export.signature_lines(baked) == ["f32 2 32 32 3", "f32 2 32 32 3"]
    with pytest.raises(ValueError, match="fixed batch"):
        export.export_native_bundle(None, str(tmp_path / "b"), image_size=32, batch="poly", device="cpu")
