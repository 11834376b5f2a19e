"""The port's data pipeline, metrics, image helpers and the dataset and metric
CLIs against the JAX package's, on the CPU.

``fdgan_tpu_torch.data``, ``ops/metrics.py``, ``cli/psnrssim.py`` and
``cli/generate_testsample.py`` are copies of numpy-only modules of
``fdgan_tpu``: the same inputs give the same arrays, the same random draws
and the same scores.
"""

import random
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fdgan_tpu import utils as jutils
from fdgan_tpu.cli import generate_testsample as jgen
from fdgan_tpu.cli import psnrssim as jpsnrssim
from fdgan_tpu.data import h5 as jh5
from fdgan_tpu.data import transforms as jtransforms
from fdgan_tpu.ops import metrics as jmetrics
from fdgan_tpu.utils import images as jimages
from fdgan_tpu_torch import utils
from fdgan_tpu_torch.cli import generate_testsample, psnrssim
from fdgan_tpu_torch.cli._common import maybe_profile
from fdgan_tpu_torch.data import h5, transforms
from fdgan_tpu_torch.ops import metrics
from fdgan_tpu_torch.utils import images

DATASET_KEYS = {  # get_loader's h5 names and the keys their files hold
    "pix2pix": ("haze", "gt"),
    "pix2pix_val": ("haze", "gt", "trans", "ato"),
    "new": ("input", "target"),
    "classification": ("haze", "label"),
}


def _write_h5(root, n, keys, rng, size=(12, 16)):
    root.mkdir()
    for i in range(n):
        with h5py.File(root / f"{i}.h5", "w") as f:
            for k in keys:
                shape = (4,) if k == "label" else size + (3,)
                f.create_dataset(k, data=rng.uniform(size=shape).astype(np.float32))
    return str(root)


def _write_pngs(root, sizes, rng):
    root.mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(root / f"{i:02d}.png")
    return str(root)


def _data_root(name, tmp_path, rng):
    if name == "folder":
        for c, n in (("cat", 3), ("dog", 2)):
            _write_pngs(tmp_path / "folder" / c, [(12, 16)] * n, rng)
        return str(tmp_path / "folder")
    return _write_h5(tmp_path / name, 5, DATASET_KEYS[name], rng)


def _batches(loader):
    return [tuple(np.asarray(c) for c in batch) for batch in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["pix2pix", "pix2pix_val", "new", "folder", "classification"])
def test_get_loader_items_match_jax(name, tmp_path, np_rng):
    """Every dataset name of ``get_loader``: the same batches, in the same
    seeded shuffle order, through the prefetch thread and without it."""
    root = _data_root(name, tmp_path, np_rng)
    for workers in (0, 2):
        kw = dict(batch_size=2, workers=workers, shuffle=True, seed=3)
        got = _batches(h5.get_loader(name, root, 16, 16, **kw))
        want = _batches(jh5.get_loader(name, root, 16, 16, **kw))
        _assert_same_batches(got, want)
    if name == "new":
        assert got[0][0].shape == (2, 224, 224, 3)  # the input resized, the target as stored


def test_sharded_loader_matches_jax(tmp_path, np_rng):
    root = _write_h5(tmp_path / "ds", 7, DATASET_KEYS["pix2pix"], np_rng)
    for pid in range(3):
        kw = dict(batch_size=1, workers=0, shuffle=False, shard=(pid, 3))
        loader = h5.get_loader("pix2pix", root, 16, 16, **kw)
        assert isinstance(loader.dataset, h5.ShardedDataset) and len(loader.dataset) == 2
        _assert_same_batches(_batches(loader), _batches(jh5.get_loader("pix2pix", root, 16, 16, **kw)))
    with pytest.raises(IndexError):
        loader.dataset[2]
    with pytest.raises(ValueError, match="out of range"):
        h5.ShardedDataset([], 3, 3)


def test_loader_over_a_list_and_drop_last():
    """The demo's in-memory route: a list of pairs, no h5py."""
    pairs = [(np.full((4, 4, 3), i, np.float32), np.full((4, 4, 3), -i, np.float32)) for i in range(5)]
    loader = h5.DataLoader(pairs, batch_size=2, drop_last=True)
    batches = _batches(loader)
    assert len(loader) == 2 == len(batches)
    np.testing.assert_array_equal(batches[1][0][:, 0, 0, 0], [2, 3])
    assert len(h5.DataLoader(pairs, batch_size=2)) == 3


def test_h5_datasets_need_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for name in DATASET_KEYS:
        if name == "classification":
            continue  # as in the JAX package, it reads h5py when an item is read
        with pytest.raises(RuntimeError, match="h5py"):
            h5.get_loader(name, str(tmp_path), 16, 16)


@pytest.mark.parametrize("name,msg", [("pix2pix_val2", "deliberately not ported"), ("cifar", "unknown dataset")])
def test_get_loader_refuses(name, msg, tmp_path):
    with pytest.raises(ValueError, match=msg):
        h5.get_loader(name, str(tmp_path), 16, 16)


def _chain(mod, rng):
    return mod.Compose([
        mod.ToArray(),
        mod.Scale(20),
        mod.CenterCrop(18),
        mod.Pad(2, fill=0.25),
        mod.RandomCrop(16, padding=1, rng=rng),
        mod.RandomHorizontalFlip(rng=rng),
        mod.Normalize((0.5, 0.4, 0.3), (0.5, 0.6, 0.7)),
        mod.Lambda(lambda a: a * 2.0),
    ])


def test_transforms_match_jax(np_rng):
    """The whole transform set on uint8 pairs, with random crops and flips
    drawn from one seeded ``random.Random`` each side."""
    port, ref = _chain(transforms, random.Random(5)), _chain(jtransforms, random.Random(5))
    for _ in range(6):
        pair = [np_rng.integers(0, 256, size=(24, 30, 3), dtype=np.uint8) for _ in range(2)]
        got, want = port(*pair), ref(*pair)
        assert len(got) == 2
        for a, b in zip(got, want):
            assert a.shape == (16, 16, 3)
            np.testing.assert_array_equal(a, b)
    img = np_rng.uniform(size=(9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(transforms._bilinear_resize(img, 5, 21), jtransforms._bilinear_resize(img, 5, 21))


def test_metrics_match_jax(np_rng):
    a = np_rng.integers(0, 256, size=(21, 27, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + np_rng.integers(-9, 10, size=a.shape), 0, 255).astype(np.uint8)
    af, bf = a / 255.0, b / 255.0
    assert metrics.psnr(af, bf) == jmetrics.psnr(af, bf)
    assert metrics.mssim_channels(a, b) == jmetrics.mssim_channels(a, b)
    for kw in (dict(), dict(gaussian_weights=True), dict(win_size=5, use_sample_covariance=False)):
        assert metrics.compare_ssim(a[..., 0], b[..., 0], **kw) == jmetrics.compare_ssim(a[..., 0], b[..., 0], **kw)
    np.testing.assert_array_equal(metrics.boundary_crop(a, 4), jmetrics.boundary_crop(a, 4))


def test_psnrssim_matches_jax(tmp_path, np_rng):
    """The CLI on the same folders: the same 4-decimal PSNR and SSIM."""
    gt = _write_pngs(tmp_path / "gt", [(24, 32), (30, 20)], np_rng)
    res = tmp_path / "res"
    res.mkdir()
    for name in ("00.png", "01.png"):
        a = np.asarray(Image.open(f"{gt}/{name}")).astype(int)
        noisy = np.clip(a + np_rng.integers(-12, 13, size=a.shape), 0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(res / name)
    argv = ["--gt_dir", gt, "--result_dir", str(res)]
    got, want = psnrssim.main(argv), jpsnrssim.main(argv)
    assert got == want and 20 < got[0] < 60 and 0 < got[1] < 1


def test_generate_testsample_matches_jax(tmp_path, np_rng):
    gt = _write_pngs(tmp_path / "gt", [(12, 16), (20, 8)], np_rng)
    haze = _write_pngs(tmp_path / "haze", [(12, 16), (20, 8)], np_rng)
    for mod, out in ((generate_testsample, "port"), (jgen, "jax")):
        mod.main(["--gt_dir", gt, "--haze_dir", haze, "--out_dir", str(tmp_path / out)])
    for i in range(2):
        with h5py.File(tmp_path / "port" / f"{i}.h5", "r") as f, h5py.File(tmp_path / "jax" / f"{i}.h5", "r") as g:
            assert sorted(f) == sorted(g) == ["gt", "haze"]
            for k in f:
                assert f[k].dtype == np.float32
                np.testing.assert_array_equal(f[k][:], g[k][:])


def test_image_files_match_jax(tmp_path, np_rng):
    src = _write_pngs(tmp_path / "src", [(20, 30)], np_rng) + "/00.png"
    for kw in (dict(), dict(size=16), dict(size=16, keep_asp=True), dict(scale=2.0)):
        np.testing.assert_array_equal(images.load_rgb_image(src, **kw), jimages.load_rgb_image(src, **kw))
    arr = np_rng.uniform(-20, 280, size=(10, 12, 3)).astype(np.float32)
    for save in ("save_rgb_image", "save_bgr_image"):
        getattr(images, save)(arr, str(tmp_path / "port.png"))
        getattr(jimages, save)(arr, str(tmp_path / "jax.png"))
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                      np.asarray(Image.open(tmp_path / "jax.png")))


def test_batch_helpers_match_jax(np_rng):
    x = np_rng.uniform(0, 255, size=(2, 5, 6, 3)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for name in ("subtract_imagenet_mean_batch", "add_imagenet_mean_batch", "preprocess_batch"):
        np.testing.assert_array_equal(getattr(images, name)(xt).numpy(), np.asarray(getattr(jimages, name)(xj)))
    np.testing.assert_array_equal(images.imagenet_clamp_batch(xt - 100, 0.0, 60.0).numpy(),
                                  np.asarray(jimages.imagenet_clamp_batch(xj - 100, 0.0, 60.0)))
    assert utils.__all__ == jutils.__all__


def test_maybe_profile_writes_a_chrome_trace(tmp_path):
    with maybe_profile(str(tmp_path / "prof")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert "aten::mm" in (tmp_path / "prof" / "trace.json").read_text()
    with maybe_profile(""):  # off: nothing written
        pass
