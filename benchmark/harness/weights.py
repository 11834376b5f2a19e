"""Weights made from the seed, on the device, in a few large calls.

A model's parameters are laid out from its state dict's names and shapes
(:func:`spec`). One ``torch.rand`` on a generator of the device draws every
element at once; each leaf then takes ``centre + half_width·u`` with its
kind's range:

- convolution weights: Kaiming-uniform for a ReLU, ±√(6 / fan_in), where a
  transposed convolution's fan-in is in·kh·kw / stride²;
- biases ±0.05; BN weights 1 ± 0.25, biases ±0.1;
- BN running statistics: mean ±0.1, variance 1 ± 0.25;
- a configuration may set a leaf's range by name (DCPDN's transmission head,
  whose output divides the image: kept near tanh(1), as a trained one is).

The same seed gives the same weights on every device and in every dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

Spec = List[Tuple[str, Tuple[int, ...], float, float]]  # (name, shape, centre, half width)


def spec(module: nn.Module, overrides: Dict[str, Tuple[float, float]] = None) -> Spec:
    """Each state-dict entry of ``module`` (built on the meta device will
    do) with the range its values are drawn from; ``overrides`` maps a name
    to its own (centre, half width)."""
    overrides = overrides or {}
    transposed = {f"{n}.weight": m.stride[0] for n, m in module.named_modules() if isinstance(m, nn.ConvTranspose2d)}
    bn_like = {n for n, m in module.named_modules() if hasattr(m, "running_mean")}
    out: Spec = []
    for name, t in module.state_dict().items():
        owner, leaf = name.rsplit(".", 1)
        shape = tuple(t.shape)
        if owner in bn_like:
            centre, half = {"weight": (1.0, 0.25), "bias": (0.0, 0.1), "running_mean": (0.0, 0.1),
                            "running_var": (1.0, 0.25)}[leaf]
        elif leaf == "weight" and len(shape) == 4:
            if name in transposed:
                fan = shape[0] * shape[2] * shape[3] / transposed[name] ** 2
            else:
                fan = shape[1] * shape[2] * shape[3]
            centre, half = 0.0, math.sqrt(6.0 / fan)
        else:
            centre, half = 0.0, 0.05
        centre, half = overrides.get(name, (centre, half))
        out.append((name, shape, float(centre), float(half)))
    return out


def make(layout: Spec, seed: int, device, dtype=torch.float32, salt: int = 0) -> Dict[str, torch.Tensor]:
    """The state dict of ``layout`` from ``seed`` (``salt`` tells models of
    one run apart), on ``device`` in ``dtype``: views of one flat tensor."""
    sizes = [math.prod(s) for _, s, _, _ in layout]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % 2**63)
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    reps = torch.tensor(sizes, device=device)
    centre = torch.repeat_interleave(torch.tensor([c for _, _, c, _ in layout], device=device), reps)
    half = torch.repeat_interleave(torch.tensor([h for _, _, _, h in layout], device=device), reps)
    flat = torch.addcmul(centre, half, u).to(dtype)
    out, i = {}, 0
    for (name, shape, _, _), n in zip(layout, sizes):
        out[name] = flat[i:i + n].view(shape)
        i += n
    return out
