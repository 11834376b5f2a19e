"""The port's halo-tiled route (fdgan_tpu_torch.dist.tiling) against JAX's
``fdgan_tpu.dist.tiling``, behind the engine and behind ``cli/serve``, on
the CPU.

The toy forward adds each pixel's position inside its tile, so the stitched
result shows which tile wrote which pixel: it is equal to JAX's bit for bit
only if the tiles, their interiors and the order of the writes are JAX's.
The engine's tiled route runs the full-width generator on 32 px tiles once;
the staging and CLI cases run the toy forward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.dist import tiling as jtiling
from fdgan_tpu_torch.dist import tiling
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.serve import InferenceEngine
from fdgan_tpu_torch.utils.images import normalize_to_uint8

CASES = [  # (shape, tile, halo)
    ((1, 64, 64, 3), 48, 16),  # tests/test_tiling_fdgan.py's case
    ((2, 40, 96, 3), 32, 8),  # tiled on both axes, the last tile overlapping its neighbour
    ((1, 24, 80, 3), 32, 8),  # one tile high, tiled across
    ((1, 24, 24, 3), 32, 8),  # no larger than a tile: fn alone
]


def _toy(xp, t):
    """Tile-local position added to a pointwise function, 3 → 5 channels."""
    _, th, tw, _ = t.shape
    pos = xp.arange(th, dtype=xp.float32)[:, None] * 0.01 + xp.arange(tw, dtype=xp.float32)[None, :] * 0.001
    y = t * 2.0 + pos[None, :, :, None]
    return xp.concatenate([y, y[..., :2] * 0.5], axis=-1)


@pytest.mark.parametrize("size,tile,halo", [(64, 48, 16), (96, 32, 8), (100, 40, 8), (40, 32, 8), (32, 32, 0)])
def test_tile_starts_match_jax(size, tile, halo):
    assert tiling._tile_starts(size, tile, halo) == jtiling._tile_starts(size, tile, halo)


def test_tile_starts_reject_a_halo_that_eats_the_tile():
    with pytest.raises(ValueError, match="2\\*halo"):
        tiling._tile_starts(64, 32, 16)


@pytest.mark.parametrize("shape,tile,halo", CASES)
def test_tiled_apply_matches_jax_exactly(shape, tile, halo, np_rng):
    x = np_rng.uniform(size=shape).astype(np.float32)
    want = np.asarray(jtiling.tiled_apply(lambda t: _toy(jnp, t), jnp.asarray(x), tile=tile, halo=halo))
    got = tiling.tiled_apply(lambda t: _toy(torch, t), torch.from_numpy(x), tile=tile, halo=halo)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def model():
    return FDGAN(generator=torch.Generator().manual_seed(0))


def test_engine_tiled_route_matches_tiled_apply(model, np_rng):
    """A ragged 40×45 image (padded to 40×48, 2×2 tiles of 32²) through the
    engine's tiled route against ``tiled_apply`` over the engine's own
    forward; a small image beside it takes the bucketed route."""
    eng = InferenceEngine(model, device="cpu", precision="fp32", bn_mode="running", bucket=16, tile=32, halo=8)
    imgs = [np_rng.uniform(size=s).astype(np.float32) for s in [(40, 45, 3), (16, 12, 3)]]
    outs = eng.predict_batch(imgs)
    x = InferenceEngine._pad_hw(imgs[0], 40, 48)[None]
    with torch.inference_mode():
        want = tiling.tiled_apply(lambda t: eng._forward(eng._model, t), torch.from_numpy(x), tile=32, halo=8)
    assert [o.shape for o in outs] == [i.shape for i in imgs]
    np.testing.assert_allclose(outs[0], want.numpy()[0, :40, :45], rtol=0, atol=1e-6)
    # one tiled image, one bucketed batch: 40×48 holds 40×45 real pixels, the 16² bucket 16×12
    assert eng.stats["images"] == 2 and eng.stats["batches"] == 2
    assert eng.stats["padded_frac"] == pytest.approx((40 * 48 - 40 * 45 + 16 * 16 - 16 * 12) / (40 * 48 + 16 * 16))


def test_engine_streams_tiled_and_bucketed_in_order(model, np_rng):
    """Both routes behind ``stream()``, with an identity forward: results
    in input order, each equal to its input."""
    eng = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(2,), tile=32, halo=8)
    calls = []

    def forward(model, x):
        calls.append(tuple(x.shape))
        return x.float()

    eng._forward = forward
    sizes = [(16, 16, 3), (40, 56, 3), (16, 16, 3), (24, 16, 3), (37, 20, 3)]
    imgs = [np_rng.uniform(size=s).astype(np.float32) for s in sizes]
    for out in (list(eng.stream(iter(imgs), depth=2)), eng.predict_batch(imgs)):
        assert len(out) == len(imgs)
        for img, y in zip(imgs, out):
            np.testing.assert_array_equal(y, img)
    # per pass: the 40×56 image in 2×3 tiles of 32², the 37×20 one (40×24) in 2 tiles of 32×24
    assert calls.count((1, 32, 32, 3)) == 12 and calls.count((1, 32, 24, 3)) == 4
    assert eng.stats["images"] == 10


@pytest.mark.parametrize("kw", [dict(tile=50, halo=8), dict(tile=32, halo=16)])
def test_engine_rejects_a_bad_tile(model, kw):
    with pytest.raises(ValueError, match="tile"):
        InferenceEngine(model, device="cpu", **kw)


def test_cli_serve_tiles_large_images(model, tmp_path, np_rng, monkeypatch):
    """``cli/serve --tile 48 --halo 16`` with the toy forward: the 64² input
    goes through the tiled route (its PNG is the toy's tiled result) and the
    16×24 one through a bucket."""
    from PIL import Image

    from fdgan_tpu_torch.cli import serve as cli

    monkeypatch.setattr(InferenceEngine, "_forward", lambda self, model, x: _toy(torch, x.float())[..., :3])

    src, dst = tmp_path / "hazy", tmp_path / "out"
    src.mkdir()
    big = np_rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    Image.fromarray(big).save(src / "big.png")
    Image.fromarray(np_rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8)).save(src / "small.png")
    ckpt = tmp_path / "netG.pth"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    cli.main(["--inDir", str(src), "--outDir", str(dst), "--netG", str(ckpt), "--device", "cpu",
              "--precision", "fp32", "--bn_mode", "running", "--tile", "48", "--halo", "16"])
    x = torch.from_numpy(big.astype(np.float32)[None] / 255.0)
    want = tiling.tiled_apply(lambda t: _toy(torch, t)[..., :3], x, tile=48, halo=16)[0].numpy()
    np.testing.assert_array_equal(np.asarray(Image.open(dst / "big.png")), normalize_to_uint8(want))
    assert Image.open(dst / "small.png").size == (24, 16)
