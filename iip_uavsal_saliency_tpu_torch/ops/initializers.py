"""Weight initializers (counterparts of `iip_uavsal_saliency_tpu/ops/
initializers.py`) on OIHW conv kernels, drawn from an explicit
`torch.Generator`.

The fans are PyTorch's `_calculate_fan_in_and_fan_out` on the weight
tensor, as the JAX package reproduces them on its HWIO kernels:

    fan_in  = (I / groups) * kh * kw   (the weight's dim 1 already is I / groups)
    fan_out = O * kh * kw

PyTorch's quirk is kept: fan_out ignores `groups`, so a depthwise kernel
(C, 1, kh, kw) has fan_out = C * kh * kw. The values cannot equal the JAX
package's, whose random streams differ; the distributions are the same.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def conv_fans(shape) -> Tuple[float, float]:
    """(fan_in, fan_out) of an OIHW kernel; a linear weight is (O, I)."""
    receptive = 1
    for d in shape[2:]:
        receptive *= d
    return float(shape[1] * receptive), float(shape[0] * receptive)


def _leaky_relu_gain(a: float = 0.0) -> float:
    return math.sqrt(2.0 / (1.0 + a * a))


def kaiming_normal_(w: torch.Tensor, mode: str = "fan_in", a: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: normal with std gain / sqrt(fan), gain sqrt(2 / (1 + a^2))."""
    fan_in, fan_out = conv_fans(w.shape)
    std = _leaky_relu_gain(a) / math.sqrt(fan_out if mode == "fan_out" else fan_in)
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)
