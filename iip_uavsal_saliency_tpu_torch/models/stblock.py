"""Spatial-temporal blocks (counterparts of
`iip_uavsal_saliency_tpu/models/stblock.py`: `temporal_differences`,
`SpConv`, `TeConvSub`, `STBlock` with sum fusion)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layers import ConvBNAct, DWBlock


def temporal_differences(x: torch.Tensor, group: Optional[int] = None) -> torch.Tensor:
    """(S, C, H, W) frame sequence -> (S, 2C, H, W) with channels
    [x_i - x_{i-1}, x_i - x_{i+1}], edges mirrored: with d_i = x_{i+1} - x_i,
    chanA = [d_0, d_0, ..., d_{S-2}] and chanB = -[d_0, ..., d_{S-2}, d_{S-2}].
    With `group`, each run of `group` consecutive frames is its own sequence.
    """
    s = x.shape[0]
    g = group if group is not None else s
    if s % g:
        raise ValueError(f"{s} frames do not split into groups of {g}")
    seq = x.reshape(s // g, g, *x.shape[1:])
    d = seq[:, 1:] - seq[:, :-1]
    chan_a = torch.cat([d[:, :1], d], dim=1)
    chan_b = -torch.cat([d, d[:, -1:]], dim=1)
    return torch.cat([chan_a, chan_b], dim=2).reshape(s, 2 * x.shape[1], *x.shape[2:])


class SpConv(nn.Module):
    """Spatial branch: one inverted-residual block."""

    def __init__(self, in_ch: int, planes: int = 256):
        super().__init__()
        self.spconv = DWBlock(in_ch, planes, 3, res_connect=False)

    def forward(self, x):
        return self.spconv(x)


class TeConvSub(nn.Module):
    """Temporal branch: 1x1 reduce -> frame differences -> DWBlock -> 1x1
    expand, with no residual. `diff_group` bounds the differences (see
    temporal_differences)."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8):
        super().__init__()
        width = planes // reduction
        self.reduce_conv = ConvBNAct(in_ch, width, 1)
        self.sub_conv = DWBlock(2 * width, width, 3, res_connect=False)
        self.last_conv = ConvBNAct(width, planes, 1)

    def forward(self, x, diff_group: Optional[int] = None):
        x_sub = temporal_differences(self.reduce_conv(x), diff_group)
        return self.last_conv(self.sub_conv(x_sub))


class STBlock(nn.Module):
    """Parallel spatial + temporal branches, summed, then a 1x1 conv, with
    an identity residual when in == out channels."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8):
        super().__init__()
        self.use_res = in_ch == planes
        self.stconv_sp = SpConv(in_ch, planes)
        self.stconv_te = TeConvSub(in_ch, planes, reduction)
        self.stconv_last = ConvBNAct(planes, planes, 1)

    def forward(self, x, diff_group: Optional[int] = None):
        out = self.stconv_last(self.stconv_sp(x) + self.stconv_te(x, diff_group))
        return x + out if self.use_res else out
