"""MobileNetV2 feature pyramid (counterpart of
`iip_uavsal_saliency_tpu/models/backbone.py::MobileNetV2Pyramid`).

Reproduces torchvision's `features` layer table by hand (torchvision is not
a dependency): `features.0` is the 3->32 stride-2 stem, `features.1..17`
the inverted-residual blocks. The pyramid is cut after features 1/3/6/13/17
into c1..c5 at strides 2, 4, 8, 16, 32 with 16, 24, 32, 96, 320 channels.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.layers import ConvBNAct, DWBlock

# (expand_ratio, out_ch, num_blocks, stride)
_MBV2_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
STAGE_ENDS = (1, 3, 6, 13, 17)


class MobileNetV2Pyramid(nn.Module):
    def __init__(self):
        super().__init__()
        layers = [ConvBNAct(3, 32, 3, stride=2)]
        in_ch = 32
        for expand, ch, n, stride in _MBV2_CFG:
            for b in range(n):
                layers.append(DWBlock(in_ch, ch, 3, stride if b == 0 else 1, expand))
                in_ch = ch
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in STAGE_ENDS:
                outs.append(x)
        return tuple(outs)
