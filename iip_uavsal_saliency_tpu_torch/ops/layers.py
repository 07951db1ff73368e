"""Conv building blocks in eval form (NCHW modules, channels_last on the card).

Counterparts of `iip_uavsal_saliency_tpu/ops/layers.py`:

- `BatchNorm`: eval-mode BatchNorm2d, `y = x * s + b` with the per-channel
  affine computed in f32 and applied in the activation dtype.
- `ConvBNAct` == BasicConv2d: Conv(bias=False) -> BatchNorm -> ReLU6 with
  symmetric `dilation * (k - 1) // 2` padding. The JAX package computes the
  ASPP rate-18 depthwise conv as an exact pad-add sum; here it is the same
  dilated depthwise conv.
- `DWBlock` == dwBlock: [1x1 expand] -> depthwise kxk -> 1x1 project + BN,
  with an identity residual when stride == 1 and in == out channels (which
  `res_connect=False` turns off).

Module names follow the reference's state_dict keys (`<conv>.0/.1`,
`<block>.conv.{0..3}`), so a state_dict from `models/convert.py` loads
with `strict=True`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d over dim 1 with the torch key layout
    (`weight`, `bias`, `running_mean`, `running_var`)."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s, b) in f32 (f64 for f64 params)."""
        dt = torch.promote_types(self.weight.dtype, torch.float32)
        s = self.weight.to(dt) * torch.rsqrt(self.running_var.to(dt) + self.eps)
        b = self.bias.to(dt) - self.running_mean.to(dt) * s
        return s, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, b = self.affine()
        return torch.addcmul(b.to(x.dtype).view(1, -1, 1, 1), x, s.to(x.dtype).view(1, -1, 1, 1))


class ConvBNAct(nn.Sequential):
    """Conv2d(bias=False) -> BatchNorm -> [ReLU6]; keys `0.weight`, `1.*`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 act: bool = True):
        pad = dilation * (kernel_size - 1) // 2
        layers = [
            nn.Conv2d(in_ch, out_ch, kernel_size, stride, pad, dilation,
                      groups=groups, bias=False),
            BatchNorm(out_ch),
        ]
        if act:
            layers.append(nn.ReLU6())
        super().__init__(*layers)


class DWBlock(nn.Module):
    """Inverted-residual block (expand_ratio default 6).

    With expand: `conv.0` (1x1 ConvBNAct), `conv.1` (depthwise ConvBNAct),
    `conv.2` (1x1 project), `conv.3` (BatchNorm). Without (ratio 1): `conv.0`
    depthwise, `conv.1` project, `conv.2` BatchNorm."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, expand_ratio: int = 6, dilation: int = 1,
                 res_connect: Optional[bool] = None):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        use_res = stride == 1 and in_ch == out_ch
        if res_connect is not None:
            use_res = use_res and res_connect
        self.use_res = use_res
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(in_ch, hidden, 1))
        layers += [
            ConvBNAct(hidden, hidden, kernel_size, stride, dilation, groups=hidden),
            nn.Conv2d(hidden, out_ch, 1, bias=False),
            BatchNorm(out_ch),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y
