"""The reference's DCGAN weight initialisation over the port's modules.

Counterpart of ``fdgan_tpu/nn/init.py`` (``dcgan_init``,
``DENSENET_PRETRAINED_KEYS``), the reference's ``misc.weights_init``
(misc.py:16-22): conv kernels ~ N(0, 0.02) with zero bias; BN scale ~
N(1, 0.02) with zero bias; running statistics kept.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from fdgan_tpu_torch.nn.layers import BatchNorm

# FDGAN generator children copied from pretrained torchvision densenet121
# (dehaze1113.py:707-728): the DCGAN init must not clobber them. The
# reference's weights_init targets the fresh decoder and refinement layers
# and the discriminators only.
DENSENET_PRETRAINED_KEYS = (
    "conv0",
    "dense_block1", "trans_block1",
    "dense_block2", "trans_block2",
    "dense_block3", "trans_block3",
    "dense_block31", "dense_norm31",
)


def path_generator(seed: int, path: str) -> torch.Generator:
    """A CPU generator for the module at dotted ``path``, seeded from
    ``seed`` and the crc32 of the path (stable across processes, unlike
    ``hash()``, which is salted per process), as JAX ``_path_key`` folds the
    crc32 of the joined path into its key. The two are mixed by numpy's
    ``SeedSequence`` into one 32-bit seed: torch's CPU generator keeps only
    the low 32 bits of a seed."""
    crc = zlib.crc32(path.encode()) & 0x7FFFFFFF
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed & 0xFFFFFFFF, crc]).generate_state(1)[0]))


@torch.no_grad()
def dcgan_init(module: nn.Module, seed: int, skip: tuple = ()) -> nn.Module:
    """Redraw, in place, every conv weight of ``module`` from N(0, 0.02)
    (conv biases to 0) and every BN weight from N(1, 0.02) (BN biases to 0);
    running statistics are kept. Top-level children named in ``skip`` are
    left untouched (``DENSENET_PRETRAINED_KEYS`` for the FDGAN generator).
    Each module draws on the CPU from :func:`path_generator`, so a seed gives
    the same bits on every device and in every process. Returns ``module``."""
    for path, m in module.named_modules():
        if not path or path.split(".")[0] in skip:
            continue
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            gen = path_generator(seed, path)
            m.weight.copy_(0.02 * torch.randn(m.weight.shape, generator=gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            gen = path_generator(seed, path)
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=gen))
            m.bias.zero_()
    return module
