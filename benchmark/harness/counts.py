"""Operations and bytes of the work, counted from shapes; the chip's peaks.

Model FLOPs are counted once, at set-up, by running the plain reference on
the meta device under ``torch.utils.flop_counter.FlopCounterMode`` (2 per
multiply-add of every convolution and matmul), so the count is the same
whatever implements the work. K1's least time is the arithmetic of the
port's ``PERF.md`` kernel table: per dense layer the larger of its
operations over the bf16 peak and its bytes over the memory bandwidth.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import reference

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAKS = {"bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12}

INTER, GROWTH = 128, 32  # DenseNet-121: bottleneck width 4·32, growth 32


def _meta_params(layout) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, device="meta") for name, shape, _, _ in layout}


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def forward_flops(family, layout, batch: int, h: int, w: int) -> int:
    """FLOPs of one forward of model ``family``'s served output (its
    ``reference``) at (batch, h, w)."""
    p = _meta_params(layout)
    x = torch.empty((batch, h, w, 3), device="meta")
    return _count(lambda: family.reference(p, x, "running", reference.identity))


def train_step_flops(g_layout, d_layout, batch: int, h: int, w: int, loss_weights) -> int:
    """FLOPs of one training step as the reference computes it: G's forward
    and backward through the frozen D, and D's forward and backward on the
    real and the fake batch."""
    g = {k: v.requires_grad_(True) for k, v in _meta_params(g_layout).items()}
    d = {k: v.requires_grad_(True) for k, v in _meta_params(d_layout).items()}
    haze = torch.empty((batch, h, w, 3), device="meta")
    gt = torch.empty((batch, h, w, 3), device="meta")

    def step():
        x_hat = reference.fdgan_generator(g, haze, "batch")
        dfrozen = {k: v.detach() for k, v in d.items()}
        reference.generator_loss(dfrozen, x_hat, gt, loss_weights).backward()
        reference.discriminator_loss(d, x_hat.detach(), gt).backward()

    return _count(step)


def dense_layers(blocks: List[dict], batch: int, h: int, w: int) -> List[dict]:
    """Each dense layer's (pixels, input channels) from the configuration's
    blocks: ``c0`` channels into the block, ``layers`` layers, at 1/``scale``
    of the image's H and W."""
    out = []
    for blk in blocks:
        px = batch * (h // blk["scale"]) * (w // blk["scale"])
        out += [{"pixels": px, "c": blk["c0"] + GROWTH * i} for i in range(blk["layers"])]
    return out


def k1_bound_s(layer: dict, elem_bytes: int = 2) -> float:
    """K1's least time for one layer: operations are 2·MACs of its 1×1
    (C → 128) and 3×3 (128 → 32) convs; bytes are its input read once, its
    32 output channels written once and its weights once."""
    px, c = layer["pixels"], layer["c"]
    ops = 2 * px * (c * INTER + 9 * INTER * GROWTH)
    nbytes = elem_bytes * (px * (c + GROWTH) + c * INTER + 9 * INTER * GROWTH) + 4 * 2 * (c + INTER)
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_s"])


def k1_mean_bound_s(config: dict, shape) -> float:
    """K1's least time per launch, averaged over the model's dense layers
    (the configuration's ``dense_blocks``), at the (batch, H, W) the
    program runs them."""
    layers = dense_layers(config["dense_blocks"], *shape)
    return sum(k1_bound_s(layer) for layer in layers) / len(layers)
