"""Random parameters for the port's parity tests of the model zoo: the
JAX tree's structure from ``jax.eval_shape`` of a family's ``*_init`` (no
weights are drawn by JAX, whose eager init of the full-width DCPDN models
takes tens of seconds on a CPU), filled from a numpy seed. Kernels are
U(±1/√fan_in) as torch's default init draws them, biases U(±0.1), BN scales
1 + U(±0.1), shifts N(0, 0.1²), running means N(0, 0.1²) and variances
1 + U(0, 0.1), so running mode applies a real affine."""

import jax
import numpy as np


def random_params(init, seed: int = 0) -> dict:
    """``init()``'s tree, as nested dicts of fp32 numpy arrays."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)

    def fill(node, bn):
        out = {}
        for k, v in sorted(node.items()):
            if isinstance(v, dict):
                out[k] = fill(v, "scale" in v)
                continue
            s = v.shape
            if k == "kernel":
                bound = 1.0 / np.sqrt(s[0] * s[1] * s[2])
                a = rng.uniform(-bound, bound, s)
            elif k == "scale":
                a = 1.0 + rng.uniform(-0.1, 0.1, s)
            elif k == "bias":
                a = 0.1 * rng.standard_normal(s) if bn else rng.uniform(-0.1, 0.1, s)
            elif k == "mean":
                a = 0.1 * rng.standard_normal(s)
            elif k == "var":
                a = 1.0 + rng.uniform(0.0, 0.1, s)
            else:
                raise KeyError(k)
            out[k] = a.astype(np.float32)
        return out

    return fill(shapes, False)
