"""The port's colour conversions (fdgan_tpu_torch.ops.colors) against the JAX
package's (fdgan_tpu.ops.colors) on tests/test_colors.py's cases: every
conversion on the same NHWC images, the round trips, the reference values
and the dispatcher.

fp32 on both sides: the same formulas, with the 3×3 products summed in
another order (measured ≤ 2e-6 relative); held at rtol 1e-5 and atol 1e-5
(atol 1e-4 where the values reach 100: Lab, YCbCr).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdgan_tpu.ops import colors as jcolors
from fdgan_tpu_torch.ops import colors

SPACES = ["yuv", "ycbcr", "xyz", "lab", "hsv", "hed"]
ATOL = {"ycbcr": 1e-4, "lab": 1e-4}


@pytest.fixture
def img(np_rng):
    return np_rng.uniform(0.05, 0.95, (2, 8, 8, 3)).astype(np.float32)


def _both(fn_name, x):
    return getattr(colors, fn_name)(torch.from_numpy(x)).numpy(), np.asarray(getattr(jcolors, fn_name)(jnp.asarray(x)))


@pytest.mark.parametrize("space", SPACES)
def test_forward_matches_jax(img, space):
    got, want = _both(f"rgb2{space}", img)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL.get(space, 1e-5))


@pytest.mark.parametrize("space", SPACES)
def test_inverse_matches_jax(img, space):
    """Each inverse on the JAX forward's output, so that both read the same input."""
    x = np.array(getattr(jcolors, f"rgb2{space}")(jnp.asarray(img)))
    got, want = _both(f"{space}2rgb", x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("space", ["yuv", "ycbcr", "xyz", "lab", "hsv"])
def test_roundtrip(img, space):
    x = torch.from_numpy(img)
    back = getattr(colors, f"{space}2rgb")(getattr(colors, f"rgb2{space}")(x))
    np.testing.assert_allclose(back.numpy(), img, atol=2e-3)


def test_reference_values():
    """Pure red's Y; white's Lab; green's HSV; white's HED and the pure
    haematoxylin column through hed2rgb (tests/test_colors.py's values)."""
    assert float(colors.rgb2yuv(torch.tensor([[[[1.0, 0.0, 0.0]]]]))[0, 0, 0, 0]) == pytest.approx(0.299, abs=1e-5)
    lab = colors.rgb2lab(torch.ones(1, 1, 1, 3))[0, 0, 0]
    assert float(lab[0]) == pytest.approx(100.0, abs=0.1) and abs(float(lab[1])) < 0.5 and abs(float(lab[2])) < 0.5
    hsv = colors.rgb2hsv(torch.tensor([[[[0.0, 1.0, 0.0]]]]))[0, 0, 0]
    np.testing.assert_allclose(hsv.numpy(), [1 / 3, 1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(colors.rgb2hed(torch.ones(1, 1, 1, 3))[0, 0, 0].numpy(), 0.0, atol=1e-6)
    rgb = colors.hed2rgb(torch.tensor([[[[1.0, 0.0, 0.0]]]]))[0, 0, 0].numpy()
    np.testing.assert_allclose(rgb, np.exp(-np.array([0.65, 0.70, 0.29]) * -np.log(1e-6)), rtol=1e-5)


def test_hed_roundtrip():
    stains = np.array([[[[0.3, 0.1, 0.2], [0.0, 0.5, 0.1]]]], np.float32)
    back = colors.rgb2hed(colors.hed2rgb(torch.from_numpy(stains)))
    np.testing.assert_allclose(back.numpy(), stains, atol=1e-5)


@pytest.mark.parametrize("src, dst", [("rgb", "lab"), ("lab", "hsv"), ("yuv", "xyz"), ("RGB", "HSV"), ("rgb", "rgb")])
def test_convert_matches_jax(img, src, dst):
    x = img if src.lower() == "rgb" else np.array(jcolors.convert(jnp.asarray(img), "rgb", src))
    got = colors.convert(torch.from_numpy(x), src, dst).numpy()
    np.testing.assert_allclose(got, np.asarray(jcolors.convert(jnp.asarray(x), src, dst)), rtol=1e-5, atol=1e-4)


def test_convert_unknown_pair_raises(img):
    with pytest.raises(ValueError, match="no converter"):
        colors.convert(torch.from_numpy(img), "rgb", "nope")
