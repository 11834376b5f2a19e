"""DehazeFormer in the port (``models/dehazeformer.py``), its window attention's
plain version (``ops/window_attention.py``), the engine serving it and
``cli/serve --model dehazeformer_b``, on the CPU, against the plain
reference ``tests/dehazeformer_oracle.py`` (a mirror of the published code).

The models are built at the published widths and heads but depths (4, 2, 4,
2, 2): stages 1-3 each attend (stage 1's last ¼ of 4 blocks is block 3; of
2 blocks it would be none), and both shifts occur (stage 3 attends in blocks
1, 2 and 3). Weights are the published init with every leaf moved by seeded
noise, so that zero biases and unit scales hide nothing."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dehazeformer_oracle as oracle
from fdgan_tpu_torch import trace
from fdgan_tpu_torch.models.dehazeformer import DehazeFormer, dehazeformer_b, published_state_dict
from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.ops import window_attention as wattn
from fdgan_tpu_torch.serve import InferenceEngine

DEPTHS = (4, 2, 4, 2, 2)
# fp32 on both sides, the same operations in another order (NHWC matmuls
# against NCHW convs, the RLN affine folded): ~3e-6 of outputs ~4.5 at 64 blocks
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
B_PARAMETERS = 2_517_612  # dehazeformer_b, counted from the published layer shapes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noisy(state, seed=1, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=g) for k, v in state.items()
            if not k.endswith("relative_positions")}


@pytest.fixture(scope="module")
def pair():
    """(oracle, port) with the same weights, eval mode, fp32."""
    torch.manual_seed(0)
    ref = oracle.DehazeFormer(depths=DEPTHS).eval()
    state = _noisy(ref.state_dict())
    ref.load_state_dict(state, strict=False)
    port = DehazeFormer(depths=DEPTHS).eval()
    port.load_state_dict(published_state_dict(state), strict=True)
    return ref, port


def test_state_dict_names_and_shapes_are_published(pair):
    ref, port = pair
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items() if not k.endswith("relative_positions")}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert "layer1.blocks.3.norm1.meta1.weight" in got and "layer3.blocks.1.attn.attn.meta.0.weight" in got
    assert "fusion1.mlp.0.weight" in got and "patch_split1.proj.0.weight" in got
    assert not any("relative_positions" in k for k in got)
    # a published checkpoint, relative_positions and a DataParallel prefix included, loads
    DehazeFormer(depths=DEPTHS).load_state_dict(
        published_state_dict({"state_dict": {f"module.{k}": v for k, v in ref.state_dict().items()}}), strict=True)


def test_dehazeformer_b_parameter_count():
    port = dehazeformer_b(device="meta")
    with torch.device("meta"):
        ref = oracle.DehazeFormer()
    assert sum(p.numel() for p in port.parameters()) == sum(p.numel() for p in ref.parameters()) == B_PARAMETERS
    assert sum(1 for b in port.modules() if getattr(b, "use_attn", False) and hasattr(b, "norm1")) == 24


@pytest.mark.parametrize("hw", [(36, 44), (44, 60)])
def test_forward_matches_the_published_code(pair, hw):
    ref, port = pair
    x = torch.rand((2, 3, *hw), generator=torch.Generator().manual_seed(hw[0])) * 2 - 1
    with torch.no_grad():
        want = ref(x)
        got = port(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **FWD_TOL)


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dim,heads,hw", [(24, 2, (13, 21)), (96, 6, (9, 11))])
def test_plain_window_attention_matches_the_partition(shift, dim, heads, hw):
    torch.manual_seed(dim + shift)
    mod = oracle.WindowAttention(dim, 8, heads)
    qkv = torch.randn(2, 3 * dim, *hw)
    before = wattn.launches  # the counter is the process's
    with torch.no_grad():
        want = oracle.partition_attention(mod, qkv, shift)
        nhwc = qkv.permute(0, 2, 3, 1)
        got = wattn.window_attention(nhwc[..., :2 * dim].contiguous(), nhwc[..., 2 * dim:].contiguous(), mod.bias(),
                                     heads, shift)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, **ATTN_TOL)
    assert wattn.launches == before  # the CPU takes the plain version


def _levels(y):
    return torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0.0, 255.0).to(torch.uint8)


def test_engine_serves_dehazeformer(pair):
    ref, port = pair
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((36, 44), (38, 46), (36, 44))]
    eng = InferenceEngine(port, device="cpu", precision="fp32", batch_sizes=(1, 2), input="uint8", output="uint8")
    assert eng.bucket == 4
    out = list(eng.stream(images, depth=2))
    with torch.no_grad():
        for img, y in zip(images, out):
            x = torch.from_numpy(img).float().div(255.0).mul(2.0).sub(1.0).permute(2, 0, 1)[None]
            want = _levels(ref(x)[0].permute(1, 2, 0)).numpy()
            assert y.dtype == np.uint8 and y.shape == img.shape
            assert np.abs(y.astype(int) - want.astype(int)).max() <= 1
    assert eng.stats["images"] == 3 and eng.stats["padded_frac"] > 0  # 38x46 pads to 40x48
    # the caller's module is left as it was; a reload checks against the live module's class
    assert next(port.parameters()).dtype == torch.float32
    assert eng.reload(port) == 1
    with pytest.raises(ValueError, match="cannot replace the live DehazeFormer"):
        eng.reload(FDGAN(device="meta"))
    with pytest.raises(ValueError, match="multiple of 4 \\(DehazeFormer's divisor\\)"):
        InferenceEngine(port, device="cpu", bucket=6)
    with pytest.raises(ValueError, match="serve FD-GAN only"):
        InferenceEngine(port, device="cpu", tile=64, halo=16)
    with pytest.raises(ValueError, match="serve FD-GAN only"):
        InferenceEngine(port, device="cpu", mesh=object())


def test_forward_span_is_recorded(pair):
    _, port = pair
    t0 = time.time_ns()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        port(torch.zeros(2, 36, 44, 3))
    spans = trace.spans(t0, time.time_ns() + 1, "dehazeformer.forward")
    assert len(spans) == 1 and spans[0].attrs == {"batch": 2, "h": 36, "w": 44}
    with torch.no_grad():
        port(torch.zeros(1, 36, 44, 3))
    assert len(trace.spans(t0, time.time_ns() + 1, "dehazeformer.forward")) == 1  # nothing without a profile


def test_cli_serve_dehazeformer_b(tmp_path):
    from PIL import Image

    from fdgan_tpu_torch.cli import serve as cli

    src, dst = tmp_path / "hazy", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(3)
    # stage 3 runs at a quarter of each side, which must exceed its windows' reflect padding
    Image.fromarray(rng.integers(0, 256, (36, 44, 3), dtype=np.uint8)).save(src / "a.png")
    Image.fromarray(rng.integers(0, 256, (38, 30, 3), dtype=np.uint8)).save(src / "b.png")
    ckpt = tmp_path / "dehazeformer-b.pth"
    model = dehazeformer_b(generator=torch.Generator().manual_seed(5))
    torch.save({**model.state_dict(), "layer1.blocks.12.attn.attn.relative_positions": oracle.get_relative_positions(8)},
               ckpt)
    cli.main(["--model", "dehazeformer_b", "--inDir", str(src), "--outDir", str(dst), "--netG", str(ckpt),
              "--device", "cpu", "--maxBatch", "2", "--precision", "fp32", "--inputDtype", "uint8"])
    assert Image.open(dst / "a.png").size == (44, 36)
    assert Image.open(dst / "b.png").size == (30, 38)
    assert cli.bucket_of(cli.build_parser().parse_args(["--model", "dehazeformer_b"])) == 4
    assert cli.bucket_of(cli.build_parser().parse_args([])) == 64
