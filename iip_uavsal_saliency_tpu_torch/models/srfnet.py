"""SRF-Net, the saliency-related feature neck (counterpart of
`iip_uavsal_saliency_tpu/models/srfnet.py::SRFNet`).

1x1 laterals on c3 and c4; an ASPP on c5 (a 1x1 branch and three dilated
depthwise DWBlocks at rates 6/12/18, concatenated and fused by a 1x1);
align-corners bilinear upsampling of c4/c5 to c3's stride-8 grid; concat;
3x3 `conv_last` to `last_channel` features. The lateral and ASPP input
widths are the backbone's c3, c4 and c5 widths (`FEATURE_INPLANES`); their
output widths are `planes[1:]` (c3, c4, c5), which the JAX module replaces
by (32, 32, 64, 128) when `last_channel` is 128.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.layers import ConvBNAct, DWBlock
from ..ops.resize import resize_bilinear_align_corners
from .backbone import FEATURE_INPLANES, build_backbone

ASPP_RATES = (6, 12, 18)
PLANES = (64, 64, 128, 256)  # the laterals' default widths (planes[0] is not used)


class SRFNet(nn.Module):
    def __init__(self, cnn_type: str = "mobilenet_v2", s2d_stem: bool = False,
                 planes: Sequence[int] = PLANES, last_channel: int = 256):
        super().__init__()
        planes = [32, 32, 64, 128] if last_channel == 128 else list(planes)
        self.features = build_backbone(cnn_type, s2d_stem)
        _, c3, c4, c5 = FEATURE_INPLANES[cnn_type.lower()]
        self.lv5_aspp1 = ConvBNAct(c5, planes[3], 1)
        self.lv5_aspp2 = DWBlock(c5, planes[3], 3, dilation=ASPP_RATES[0])
        self.lv5_aspp3 = DWBlock(c5, planes[3], 3, dilation=ASPP_RATES[1])
        self.lv5_aspp4 = DWBlock(c5, planes[3], 3, dilation=ASPP_RATES[2])
        self.conv_lv5 = ConvBNAct(4 * planes[3], planes[3], 1)
        self.conv_lv4 = ConvBNAct(c4, planes[2], 1)
        self.conv_lv3 = ConvBNAct(c3, planes[1], 1)
        self.conv_last = ConvBNAct(planes[3] + planes[2] + planes[1], last_channel, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, c3, c4, c5 = self.features(x)
        x_c5 = torch.cat([self.lv5_aspp1(c5), self.lv5_aspp2(c5),
                          self.lv5_aspp3(c5), self.lv5_aspp4(c5)], dim=1)
        x_c5 = self.conv_lv5(x_c5)
        x_c4 = self.conv_lv4(c4)
        x_c3 = self.conv_lv3(c3)
        h, w = c3.shape[-2], c3.shape[-1]
        x_c5 = resize_bilinear_align_corners(x_c5, h, w)
        x_c4 = resize_bilinear_align_corners(x_c4, h, w)
        out = torch.cat([x_c5, x_c4, x_c3], dim=1)
        return self.conv_last(out)
