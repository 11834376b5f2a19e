"""The port's CUDA kernels and serving path on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. The module imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fdgan_tpu_torch.models.fdgan import FDGAN
from fdgan_tpu_torch.ops import dense
from fdgan_tpu_torch.serve import InferenceEngine

pytestmark = pytest.mark.cuda

K1_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_pallas_dense.py:52
# bf16: kernel and twin round t, g and f at the same points; fp32 sums in
# another order can move a value by one bf16 step (2^-8 relative)
K1_TOL_BF16 = dict(atol=1e-2, rtol=1.6e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def exact():
    """fp32 references without TF32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


def _layer_args(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    args = [
        rng.uniform(size=shape),
        rng.uniform(0.5, 1.5, c),
        rng.normal(0, 0.3, c),
        rng.standard_normal((c, 128)) / np.sqrt(c),
        rng.uniform(0.5, 1.5, 128),
        rng.normal(0, 0.3, 128),
        rng.standard_normal((3, 3, 128, 32)) / np.sqrt(9 * 128),
    ]
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in args]
    for i in (0, 3, 6):  # x, w1, w2 in the kernel's dtype; affines stay fp32
        out[i] = out[i].to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 10, 17, 40), (2, 24, 40, 992)])
def test_kernels_match_twins(cuda, exact, shape, dtype):
    args = _layer_args(shape, 6, cuda, dtype)
    dense.reset_launch_counts()
    f = dense.fused_dense_layer(*args)
    m, v = dense.h_batch_stats(*args[:4])
    torch.cuda.synchronize()
    assert (dense.k1_launches, dense.k2_launches) == (1, 1)
    ref = dense.layer_reference(*args)
    torch.testing.assert_close(f.float(), ref.float(), **(K1_TOL if dtype == torch.float32 else K1_TOL_BF16))
    mr, vr = dense.h_stats_reference(*args[:4])
    torch.testing.assert_close(m, mr, atol=1e-4, rtol=1e-4)  # test_pallas_dense.py:67-68
    torch.testing.assert_close(v, vr, atol=1e-4, rtol=1e-3)


def test_wrappers_reject_bad_inputs(cuda):
    x, a1, b1, w1, a2, b2, w2 = _layer_args((1, 8, 8, 32), 7, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        dense.fused_dense_layer(x.transpose(1, 2), a1, b1, w1, a2, b2, w2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dense.h_batch_stats(x.half(), a1, b1, w1)
    with pytest.raises(ValueError, match="w1"):
        dense.h_batch_stats(x, a1, b1, w1[:, :64])
    with pytest.raises(ValueError, match="C % 8"):
        dense.h_batch_stats(x[..., :28].contiguous().bfloat16(), a1[:28], b1[:28], w1[:28].bfloat16())
    with pytest.raises(ValueError, match="x on cuda"):
        dense.fused_dense_layer(x, a1.cpu(), b1, w1, a2, b2, w2)


@pytest.mark.parametrize("mode", ["batch", "running"])
def test_generator_kernels_match_plain(cuda, exact, mode):
    model = FDGAN(device=cuda, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(np.random.default_rng(1).uniform(size=(2, 32, 48, 3)), dtype=torch.float32, device=cuda)
    dense.reset_launch_counts()
    with torch.inference_mode():
        got = model(x, bn_mode=mode)
        ref = model(x, bn_mode=mode, impl="plain")
    assert (dense.k1_launches, dense.k2_launches) == (42, 42 if mode == "batch" else 0)
    torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)  # test_pallas_dense.py:132


def test_engine_on_cuda_matches_cpu_engine(cuda):
    model = FDGAN(generator=torch.Generator().manual_seed(0))
    imgs = [np.random.default_rng(i).integers(0, 256, size=s, dtype=np.uint8)
            for i, s in enumerate([(40, 56, 3), (33, 20, 3), (16, 16, 3)])]
    gpu = InferenceEngine(model, device=cuda, precision="fp32", bucket=8, batch_sizes=(1, 2, 4))
    got = list(gpu.stream(iter(imgs), depth=2))  # fp32 engines run cuDNN without TF32
    cpu = InferenceEngine(model, device="cpu", precision="fp32", bucket=8, batch_sizes=(1, 2, 4))
    want = cpu.predict_batch(imgs)
    for a, b, img in zip(got, want, imgs):
        assert a.shape == img.shape
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3)
    assert gpu.stats["k1_launches"] == 42 * gpu.stats["batches"] and gpu.stats["k2_launches"] == 0
