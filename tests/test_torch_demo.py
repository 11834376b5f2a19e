"""The port's demo (fdgan_tpu_torch.cli.demo) against the JAX demo, JAX
``fdgan_fast.apply`` and ``tiled_apply``, and the torch oracle, on the CPU.

One checkpoint for every side: the port's seed-0 generator with randomised
running statistics, written as a reference ``.pth`` with DataParallel
prefixes (as tests/test_golden_e2e.py writes one). The JAX demo reads it
through its own converter; the direct JAX references take the same file
through ``convert_state_dict`` onto ``fdgan.init``'s shapes. The JAX demo
runs once per module, and the direct references are jitted (one compile per
shape).
"""

import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fdgan_tpu.cli import demo as jdemo
from fdgan_tpu.dist.tiling import tiled_apply as jtiled_apply
from fdgan_tpu.io.torch_import import FDGAN_TRANSPOSED, convert_state_dict, load_torch_state_dict
from fdgan_tpu.models import fdgan as jfdgan
from fdgan_tpu.models import fdgan_fast as jfast
from fdgan_tpu_torch.cli import demo, psnrssim
from fdgan_tpu_torch.cli._common import load_generator, save_image_normalized
from fdgan_tpu_torch.data import DataLoader, get_loader
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.nn.layers import BatchNorm
from fdgan_tpu_torch.utils.images import normalize_to_uint8

sys.path.insert(0, os.path.dirname(__file__))

# tests/test_fdgan_fast.py's tolerance for fdgan_fast against fdgan.apply; the port's fast
# forward holds it against JAX's (tests/test_torch_fdgan_fast.py)
FAST_TOL = dict(atol=5e-5, rtol=1e-4)
SIZES = [(32, 32), (36, 44)]  # the second reflect-pads to 40×48


def _write_h5(root, hazes):
    root.mkdir()
    for i, haze in enumerate(hazes):
        with h5py.File(root / f"{i}.h5", "w") as f:
            f.create_dataset("gt", data=np.clip((haze - 0.3) / 0.7, 0, 1).astype(np.float32))
            f.create_dataset("haze", data=haze)
    return str(root)


def _pngs(path):
    return {n: np.asarray(Image.open(os.path.join(path, n))).astype(int) for n in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(1.0 + 0.1 * torch.rand(m.running_var.shape, generator=gen))
    pth = str(tmp / "netG_epoch_test.pth")
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, pth)
    rng = np.random.default_rng(0)
    hazes = [np.clip(0.7 * rng.uniform(size=s + (3,)) + 0.3, 0, 1).astype(np.float32) for s in SIZES]
    ds = _write_h5(tmp / "ds", hazes)
    outs = {side: str(tmp / side) for side in ("jax", "port")}
    jdemo.main(["--valDataroot", ds, "--netG", pth, "--imageSize", "32", "--outDir", outs["jax"]])
    demo.main(["--valDataroot", ds, "--netG", pth, "--imageSize", "32", "--outDir", outs["port"], "--device", "cpu"])
    params = convert_state_dict(load_torch_state_dict(pth), jax.eval_shape(jfdgan.init, jax.random.PRNGKey(0)),
                                transposed=FDGAN_TRANSPOSED)
    return dict(tmp=tmp, pth=pth, ds=ds, hazes=hazes, outs=outs, params=params)


def test_demo_pngs_match_the_jax_demo(case):
    got, want = _pngs(case["outs"]["port"]), _pngs(case["outs"]["jax"])
    assert sorted(got) == sorted(want) == ["0.png", "1.png"]
    for name, img in got.items():
        assert img.shape == want[name].shape == SIZES[int(name[0])] + (3,)
        assert np.abs(img - want[name]).max() <= 1, name


def test_demo_core_matches_jax_fdgan_fast(case):
    """The core's float outputs for the ragged image against JAX
    ``fdgan_fast.apply`` on the reflect-padded input, cropped; and the
    demo's PNGs are the core's outputs."""
    model = load_generator(case["pth"], device="cpu")
    loader = get_loader("pix2pix", case["ds"], 32, 32, batch_size=1, workers=1, shuffle=False)
    pngs = _pngs(case["outs"]["port"])
    results = list(demo.dehaze(model, loader, device="cpu"))
    assert [i for i, _, _ in results] == [0, 1]
    for (index, seconds, y), haze in zip(results, case["hazes"]):
        assert y.shape == haze.shape and y.dtype == np.float32 and seconds > 0
        np.testing.assert_array_equal(pngs[f"{index}.png"], normalize_to_uint8(y))
    haze, y = case["hazes"][1], results[1][2]
    x = jnp.pad(jnp.asarray(haze)[None], ((0, 0), (0, 4), (0, 4), (0, 0)), mode="reflect")  # 36×44 → 40×48
    want = np.asarray(jax.jit(lambda t: jfast.apply(case["params"], t, bn_mode="batch"))(x))[0, :36, :44]
    np.testing.assert_allclose(y, want, **FAST_TOL)


def test_demo_matches_the_torch_oracle(case, tmp_path):
    """The port's demo PNGs against the reference's module (train-mode BN)
    on the same checkpoint and padded input: test_golden_e2e's bar."""
    from torch_oracle import FDGANOracle

    oracle = FDGANOracle()
    state = {k[len("module."):]: v for k, v in torch.load(case["pth"]).items()}
    missing, unexpected = oracle.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    oracle.train()
    ref = tmp_path / "oracle"
    ref.mkdir()
    with torch.no_grad():
        for i, haze in enumerate(case["hazes"]):
            h, w = haze.shape[:2]
            x = np.pad(haze, ((0, -h % 8), (0, -w % 8), (0, 0)), mode="reflect")
            y = oracle(torch.from_numpy(x.transpose(2, 0, 1)[None].copy())).numpy()[0].transpose(1, 2, 0)
            save_image_normalized(y[:h, :w], str(ref / f"{i}.png"))
    psnr_v, ssim_v = psnrssim.main(["--gt_dir", str(ref), "--result_dir", case["outs"]["port"]])
    assert psnr_v > 50, f"port demo vs the torch oracle: PSNR {psnr_v}"
    assert ssim_v > 0.999, f"port demo vs the torch oracle: SSIM {ssim_v}"


def test_tiled_demo_matches_jax_tiled_apply(case, tmp_path):
    """``--tile 48 --halo 16 --bn_mode running`` on a 64² image: the core
    against JAX ``tiled_apply`` over the same parameters, and the PNG."""
    haze = np.random.default_rng(2).uniform(size=(64, 64, 3)).astype(np.float32)
    ds = _write_h5(tmp_path / "ds", [haze])
    fwd = jax.jit(lambda x: jfast.apply(case["params"], x, bn_mode="running"))
    want = np.asarray(jtiled_apply(fwd, jnp.asarray(haze)[None], tile=48, halo=16))[0]
    model = load_generator(case["pth"], device="cpu")
    loader = get_loader("pix2pix", ds, 64, 64, batch_size=1, workers=0, shuffle=False)
    ((_, _, got),) = demo.dehaze(model, loader, bn_mode="running", tile=48, halo=16, device="cpu")
    np.testing.assert_allclose(got, want, **FAST_TOL)
    out = str(tmp_path / "out")
    demo.main(["--valDataroot", ds, "--netG", case["pth"], "--outDir", out, "--device", "cpu",
               "--bn_mode", "running", "--tile", "48", "--halo", "16"])
    assert np.abs(_pngs(out)["0.png"] - normalize_to_uint8(want).astype(int)).max() <= 1


def test_demo_bf16_casts_the_model_and_returns_fp32(case):
    """bf16 over a batch of two (a loader over in-memory pairs): the model
    is cast for the run and the images come back fp32, indexed in order."""
    model = load_generator(case["pth"], device="cpu")
    haze = case["hazes"][0]
    loader = DataLoader([(haze, haze), (haze[::-1].copy(), haze)], batch_size=2)
    got = list(demo.dehaze(model, loader, precision="bf16", device="cpu"))
    assert [i for i, _, _ in got] == [0, 1] and got[0][1] == got[1][1]  # one forward for the batch
    assert next(model.parameters()).dtype == torch.float32  # the caller's model is left as it is
    for _, _, y in got:
        assert y.dtype == np.float32 and y.shape == haze.shape and np.isfinite(y).all()


def test_demo_without_a_card_fails(case, monkeypatch):
    """No GPU and no ``--device cpu``: the demo stops; it does not carry on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        demo.main(["--valDataroot", case["ds"], "--netG", case["pth"]])


def test_msgpack_checkpoints_raise(case):
    """Ported now, so a JAX params ``.msgpack`` no longer raises: the same
    weights written by JAX ``save_checkpoint`` load bit for bit as the
    ``.pth`` does, and the demo run from it writes the same PNGs. Any other
    suffix still raises."""
    from fdgan_tpu.io.checkpoint import save_checkpoint as jsave_checkpoint

    path = jsave_checkpoint(str(case["tmp"] / "netG.msgpack"), case["params"])
    got, want = load_generator(path, device="cpu").state_dict(), load_generator(case["pth"], device="cpu").state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
    out = str(case["tmp"] / "port_msgpack")
    demo.main(["--valDataroot", case["ds"], "--netG", path, "--imageSize", "32", "--outDir", out, "--device", "cpu"])
    pngs, ref = _pngs(out), _pngs(case["outs"]["port"])
    assert pngs.keys() == ref.keys() and all(np.array_equal(pngs[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match=".pth"):
        load_generator("netG.ckpt", device="cpu")
