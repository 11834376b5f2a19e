"""The traffic generator repeats exactly from a seed, and a seed changes
which work comes when, never how much."""

import numpy as np
import pytest

import bench_util  # noqa: F401
from harness import traffic

SEED = 2**31 + 977  # wider than 32 signed bits


def test_images_repeat_from_the_seed():
    a = traffic.images_uint8(SEED, 3, 40, 56, "cpu")
    b = traffic.images_uint8(SEED, 3, 40, 56, "cpu")
    c = traffic.images_uint8(SEED + 1, 3, 40, 56, "cpu")
    assert a.dtype == np.uint8 and a.shape == (3, 40, 56, 3)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).mean() > 5


def test_train_batches_repeat_and_differ():
    h1, g1 = traffic.train_batches(SEED, 2, 3, 32, "cpu")
    h2, g2 = traffic.train_batches(SEED, 2, 3, 32, "cpu")
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(g1, g2)
    assert h1.shape == (2, 3, 32, 32, 3) and 0.0 <= h1.min() and h1.max() <= 1.0
    rows = h1.reshape(6, -1)
    assert len({r.tobytes() for r in rows}) == 6  # every image differs


def test_order_and_arrivals_repeat():
    np.testing.assert_array_equal(traffic.order(SEED, 50, 7), traffic.order(SEED, 50, 7))
    o = traffic.order(SEED, 21, 7)
    assert sorted(o[:7]) == list(range(7)) and sorted(o[7:14]) == list(range(7))
    np.testing.assert_array_equal(traffic.arrivals(SEED, 120.0, 10.0), traffic.arrivals(SEED, 120.0, 10.0))


def test_every_seed_offers_the_same_gaps():
    a, b = traffic.arrivals(SEED, 150.0, 20.0), traffic.arrivals(SEED + 5, 150.0, 20.0)
    assert len(a) == len(b) == 3000
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0.0)), rtol=0, atol=1e-12)
    assert a[-1] == pytest.approx(20.0, rel=0.01)
    assert np.diff(a, prepend=0.0).mean() == pytest.approx(1 / 150.0, rel=0.01)
