"""VGG16 feature extractor for the perceptual loss.

Counterpart of ``fdgan_tpu/models/vgg16.py`` (the reference's
``myutils/vgg16.py:6-49``): thirteen 3×3 convs named ``conv1_1`` …
``conv5_3``; :meth:`VGG16.forward` returns the relu1_2, relu2_2, relu3_3 and
relu4_3 feature maps. The weights come from a converted checkpoint; there
is none in the repository, so the train step runs without the perceptual
term unless one is given.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from fdgan_tpu_torch.nn.layers import Conv2d, max_pool, relu, torch_style_init

_CFG = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]
# the convs before each returned feature map
_STAGES = (("conv1_1", "conv1_2"), ("conv2_1", "conv2_2"), ("conv3_1", "conv3_2", "conv3_3"),
           ("conv4_1", "conv4_2", "conv4_3"))


class VGG16(nn.Module):
    def __init__(self, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        for name, cin, cout in _CFG:
            setattr(self, name, Conv2d(cin, cout, 3, padding=1, device="meta", dtype=dtype))
        self.to_empty(device=device if device is not None else "cpu")
        torch_style_init(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NHWC images → [relu1_2, relu2_2, relu3_3, relu4_3] as NHWC views."""
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = []
        for i, stage in enumerate(_STAGES):
            if i:
                h = max_pool(h, 2)
            for name in stage:
                h = relu(getattr(self, name)(h))
            feats.append(h.permute(0, 2, 3, 1))
        return feats

