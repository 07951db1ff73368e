"""Weight initializers (counterparts of `iip_uavsal_saliency_tpu/ops/
initializers.py`) on OIHW conv kernels, drawn from an explicit
`torch.Generator`.

The fans are PyTorch's `_calculate_fan_in_and_fan_out` on the weight
tensor, as the JAX package reproduces them on its HWIO kernels:

    fan_in  = (I / groups) * kh * kw   (the weight's dim 1 already is I / groups)
    fan_out = O * kh * kw

PyTorch's quirk is kept: fan_out ignores `groups`, so a depthwise kernel
(C, 1, kh, kw) has fan_out = C * kh * kw. A Conv3d kernel (O, I, kt, kh,
kw) counts kt * kh * kw taps. The values cannot equal the JAX package's,
whose random streams differ; the distributions are the same. Each
initializer fills its tensor in place and returns it: the JAX registry's
`kaiming_normal_` (ConvBNAct's default), `kaiming_uniform_`,
`xavier_uniform_` (ConvLSTM's gate), `xavier_normal_`, `normal_`,
`uniform_`, `orthogonal_`, `ones_`, `zeros_`, `constant_`, by name in
`INIT_REGISTRY` and through `make_conv_init`, and `lecun_normal_` (flax's
default for a plain `nn.Conv`, VGG16's convs).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

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


# the std of a standard normal truncated to [-2, 2]: flax's truncated draws
# are divided by it so that the kept values have the std asked for
_TRUNC_STD = .87962566103423978


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: flax's default conv kernel init (`lecun_normal`, the draw
    of the JAX package's VGG16 convs): a normal truncated at two of its
    stds, scaled so that the kept values have std sqrt(1 / fan_in)."""
    fan_in, _ = conv_fans(w.shape)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def kaiming_uniform_(w: torch.Tensor, mode: str = "fan_in", a: float = 0.0,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: uniform in +-gain * sqrt(3 / fan)."""
    fan_in, fan_out = conv_fans(w.shape)
    bound = _leaky_relu_gain(a) * math.sqrt(3.0 / (fan_out if mode == "fan_out" else fan_in))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def xavier_uniform_(w: torch.Tensor, gain: float = 1.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: uniform in +-gain * sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = conv_fans(w.shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def xavier_normal_(w: torch.Tensor, gain: float = 1.0,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: normal with std gain * sqrt(2 / (fan_in + fan_out))."""
    fan_in, fan_out = conv_fans(w.shape)
    with torch.no_grad():
        return w.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


def normal_(w: torch.Tensor, mean: float = 0.0, std: float = 1.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return w.normal_(mean, std, generator=generator)


def uniform_(w: torch.Tensor, low: float = 0.0, high: float = 1.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return w.uniform_(low, high, generator=generator)


def orthogonal_(w: torch.Tensor, gain: float = 1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In place: the JAX package's `orthogonal`, which flattens the kernel
    as it lies in HWIO, (kh * kw * I, O): that matrix gets orthonormal
    columns (rows where it is wide), times `gain`. A linear weight (O, I)
    is taken as (I, O) alike; a vector as one row."""
    d = w.dim()
    hwio_shape = tuple(w.shape[2:]) + tuple(w.shape[1::-1]) if d > 1 else (1,) + tuple(w.shape)
    m, n = math.prod(hwio_shape[:-1]), hwio_shape[-1]
    a = torch.randn(max(m, n), min(m, n), generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if m < n:
        q = q.T
    q = (gain * q).reshape(hwio_shape)
    with torch.no_grad():
        return w.copy_(q.permute(d - 1, d - 2, *range(d - 2)) if d > 1 else q.reshape(w.shape))


def ones_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return w.fill_(1.0)


def zeros_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return w.zero_()


def constant_(w: torch.Tensor, value: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return w.fill_(value)


# the JAX package's `INIT_REGISTRY`, by the same names
INIT_REGISTRY: Dict[str, Callable[..., torch.Tensor]] = {
    "uniform": uniform_,
    "normal": normal_,
    "constant": constant_,
    "xavier_uniform": xavier_uniform_,
    "xavier_normal": xavier_normal_,
    "kaiming_uniform": kaiming_uniform_,
    "kaiming_normal": kaiming_normal_,
    "orthogonal": orthogonal_,
    "ones": ones_,
    "zeros": zeros_,
}


def make_conv_init(funcname: str = "kaiming_normal", **kwargs):
    """`init(w, generator=None)`: the initializer `funcname` with `kwargs`,
    in place on `w` (the JAX package's `make_conv_init`)."""
    fn = INIT_REGISTRY[funcname]

    def init(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return fn(w, generator=generator, **kwargs)

    return init
