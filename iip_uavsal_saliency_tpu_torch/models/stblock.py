"""Spatial-temporal blocks (counterparts of
`iip_uavsal_saliency_tpu/models/stblock.py`): `temporal_differences`,
`SpConv`, `TeConvSub`, `STBlock` (sum or cat fusion), the orderings
`STBlockS2T`, `STBlockT2S`, `STBlockSS2T`, and the 3-D conv blocks `STC3D`
and `STC23D`.

Every block takes (S, C, H, W) frames (channels-last memory on the card)
and `forward(x, diff_group=None)`: `diff_group` bounds the frame
differences of a temporal branch (see `temporal_differences`). The 3-D
blocks convolve each run of `time_dims` frames as one (C, T, H, W) volume,
which never crosses a video of a whole number of such runs, so they take
the argument and need none.

On a spatial mesh the 2-D blocks and their branches take `height`, the
rows of the map whose band they hold, for their DWBlocks
(`ops/layers.py`); the frame differences are per pixel and run on the band
as they are. The 3-D blocks have no band form (ROADMAP A.13.1b).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layers import ConvBNAct, ConvBNAct3D, DWBlock, laid_out_as


def temporal_differences(x: torch.Tensor, group: Optional[int] = None) -> torch.Tensor:
    """(S, C, H, W) frame sequence -> (S, 2C, H, W) with channels
    [x_i - x_{i-1}, x_i - x_{i+1}], edges mirrored: with d_i = x_{i+1} - x_i,
    chanA = [d_0, d_0, ..., d_{S-2}] and chanB = -[d_0, ..., d_{S-2}, d_{S-2}].
    With `group`, each run of `group` consecutive frames is its own sequence.
    The result lies in memory as x does (channels-last on the card)."""
    s = x.shape[0]
    g = group if group is not None else s
    if s % g:
        raise ValueError(f"{s} frames do not split into groups of {g}")
    seq = x.reshape(s // g, g, *x.shape[1:])
    d = seq[:, 1:] - seq[:, :-1]
    chan_a = torch.cat([d[:, :1], d], dim=1)
    chan_b = -torch.cat([d, d[:, -1:]], dim=1)
    out = torch.cat([chan_a, chan_b], dim=2).reshape(s, 2 * x.shape[1], *x.shape[2:])
    return laid_out_as(out, x)


def _check_fu_type(fu_type: str) -> None:
    if fu_type not in ("sum", "cat"):
        raise ValueError(f"fu_type must be 'sum' or 'cat', got {fu_type!r}")


def _fused(fu_type: str, x_sp: torch.Tensor, x_te: torch.Tensor) -> torch.Tensor:
    """The two branches summed, or concatenated on the channels."""
    return x_sp + x_te if fu_type == "sum" else laid_out_as(torch.cat([x_sp, x_te], 1), x_sp)


class SpConv(nn.Module):
    """Spatial branch: one inverted-residual block, with its identity
    residual where `res_connect` and in == out channels."""

    def __init__(self, in_ch: int, planes: int = 256, res_connect: bool = False):
        super().__init__()
        self.spconv = DWBlock(in_ch, planes, 3, res_connect=res_connect)

    def forward(self, x, height: Optional[int] = None):
        return self.spconv(x, height=height)


class TeConvSub(nn.Module):
    """Temporal branch: 1x1 reduce -> frame differences -> DWBlock -> 1x1
    expand, plus x where `res_connect` and in == out channels.
    `diff_group` bounds the differences (see temporal_differences)."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8,
                 res_connect: bool = False):
        super().__init__()
        width = planes // reduction
        self.use_res = res_connect and in_ch == planes
        self.reduce_conv = ConvBNAct(in_ch, width, 1)
        self.sub_conv = DWBlock(2 * width, width, 3, res_connect=False)
        self.last_conv = ConvBNAct(width, planes, 1)

    def forward(self, x, diff_group: Optional[int] = None, height: Optional[int] = None):
        x_sub = temporal_differences(self.reduce_conv(x), diff_group)
        out = self.last_conv(self.sub_conv(x_sub, height=height))
        return x + out if self.use_res else out


class _STPair(nn.Module):
    """A spatial and a temporal branch and a 1x1 conv after them, with an
    identity residual around the block where in == out channels; the
    subclasses order the branches. `stconv_last` takes `last_in` channels."""

    def __init__(self, in_ch: int, planes: int, reduction: int,
                 sp_in: int, te_in: int, last_in: int):
        super().__init__()
        self.use_res = in_ch == planes
        self.stconv_sp = SpConv(sp_in, planes)
        self.stconv_te = TeConvSub(te_in, planes, reduction)
        self.stconv_last = ConvBNAct(last_in, planes, 1)

    def fuse(self, x, diff_group, height=None):
        raise NotImplementedError

    def forward(self, x, diff_group: Optional[int] = None, height: Optional[int] = None):
        out = self.stconv_last(self.fuse(x, diff_group, height))
        return x + out if self.use_res else out


class STBlock(_STPair):
    """Parallel spatial and temporal branches, summed (`fu_type="sum"`) or
    concatenated (`"cat"`, a 2*planes-wide `stconv_last`)."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8,
                 fu_type: str = "sum"):
        _check_fu_type(fu_type)
        super().__init__(in_ch, planes, reduction, in_ch, in_ch,
                         planes if fu_type == "sum" else 2 * planes)
        self.fu_type = fu_type

    def fuse(self, x, diff_group, height=None):
        return _fused(self.fu_type, self.stconv_sp(x, height),
                      self.stconv_te(x, diff_group, height))


class STBlockS2T(_STPair):
    """Spatial, then temporal on its output."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8):
        super().__init__(in_ch, planes, reduction, in_ch, planes, planes)

    def fuse(self, x, diff_group, height=None):
        return self.stconv_te(self.stconv_sp(x, height), diff_group, height)


class STBlockT2S(_STPair):
    """Temporal, then spatial on its output."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8):
        super().__init__(in_ch, planes, reduction, planes, in_ch, planes)

    def fuse(self, x, diff_group, height=None):
        return self.stconv_sp(self.stconv_te(x, diff_group, height), height)


class STBlockSS2T(_STPair):
    """Spatial, then temporal on its output, the two summed."""

    def __init__(self, in_ch: int, planes: int = 256, reduction: int = 8):
        super().__init__(in_ch, planes, reduction, in_ch, planes, planes)

    def fuse(self, x, diff_group, height=None):
        x_sp = self.stconv_sp(x, height)
        return x_sp + self.stconv_te(x_sp, diff_group, height)


def conv3d_over_groups(conv: nn.Module, x: torch.Tensor, time_dims: int) -> torch.Tensor:
    """`conv` (a `ConvBNAct3D`) over (S, C, H, W) frames taken as S / T
    volumes (C, T, H, W), back to (S, C', H, W). The JAX block reshapes
    (S, H, W, C) to (g, T, H, W, C); here the reshape to (g, T, C, H, W) and
    a permute to (g, C, T, H, W) are views, which on the card, where the
    frames lie channels-last, are already in `channels_last_3d` memory, and
    the way back is views too."""
    s, c, h, w = x.shape
    if s % time_dims:
        raise ValueError(f"S={s} is not a multiple of time_dims={time_dims}")
    vol = x.reshape(s // time_dims, time_dims, c, h, w).permute(0, 2, 1, 3, 4)
    out = conv(vol)
    return laid_out_as(out.permute(0, 2, 1, 3, 4).reshape(s, out.shape[1], h, w), x)


class STC3D(nn.Module):
    """3-D conv temporal block: one ConvBNAct3D (3x3x3) over each run of
    `time_dims` frames, plus x where in == out channels."""

    def __init__(self, in_ch: int, planes: int = 256, time_dims: int = 5):
        super().__init__()
        self.time_dims = time_dims
        self.use_res = in_ch == planes
        self.stconv_te = ConvBNAct3D(in_ch, planes, 3)

    def forward(self, x, diff_group: Optional[int] = None):
        out = conv3d_over_groups(self.stconv_te, x, self.time_dims)
        return x + out if self.use_res else out


class STC23D(nn.Module):
    """Parallel 2-D (3x3 ConvBNAct) and 3-D (ConvBNAct3D over each run of
    `time_dims` frames) branches, summed or concatenated (`fu_type`), then a
    1x1 conv, plus x where in == out channels."""

    def __init__(self, in_ch: int, planes: int = 256, time_dims: int = 5,
                 fu_type: str = "sum"):
        super().__init__()
        _check_fu_type(fu_type)
        self.time_dims = time_dims
        self.fu_type = fu_type
        self.use_res = in_ch == planes
        self.stconv_sp = ConvBNAct(in_ch, planes, 3)
        self.stconv_te = ConvBNAct3D(in_ch, planes, 3)
        self.stconv_last = ConvBNAct(planes if fu_type == "sum" else 2 * planes, planes, 1)

    def forward(self, x, diff_group: Optional[int] = None):
        x_te = conv3d_over_groups(self.stconv_te, x, self.time_dims)
        out = self.stconv_last(_fused(self.fu_type, self.stconv_sp(x), x_te))
        return x + out if self.use_res else out


# the orderings `UAVSalSTBlocksType` takes by name (the JAX `ST_TYPES`)
ST_TYPES = {"st": STBlock, "s2t": STBlockS2T, "t2s": STBlockT2S, "s_s2t": STBlockSS2T}
