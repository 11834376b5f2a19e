"""Shared by the benchmark's CPU tests: the harness on the path, and a
cell's traffic shrunk to a size a CPU test run can hold."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "bulk.620x460": dict(image_h=44, image_w=60, distinct_images=6, bucket=16, batch_sizes=[1, 2], depth=2,
                         check_images=4),
    "bulk.512": dict(image_h=256, image_w=256, distinct_images=3, batch=1, in_flight=2, check_images=2),
    "serve.poisson": dict(image_h=44, image_w=60, distinct_images=6, bucket=16, batch_sizes=[1, 2], rate=6.0,
                          check_requests=4, drain_s=60),
    "train.8x256": dict(batch=2, image=32, distinct_batches=5, warm_steps=1),
}


def tiny_specs():
    """The repository's specs with every traffic mix shrunk (same kinds,
    same parameters otherwise)."""
    from harness.specs import Specs

    specs = Specs(ROOT)
    full = specs.traffic
    specs.traffic = lambda name: {**full(name), **TINY[name]}
    return specs
