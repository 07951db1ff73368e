"""Backbone feature pyramids (counterparts of
`iip_uavsal_saliency_tpu/models/backbone.py`): MobileNetV2, ResNet-18/34/
50/101/152 and VGG16, each returning five stages c1..c5 at strides
(2, 4, 8, 16, 32) (ResNet's c1 at stride 4); SRF-Net reads c3, c4 and c5,
whose widths are `FEATURE_INPLANES[cnn_type][1:]`.

torchvision is not a dependency: each layer table is reproduced by hand,
with torchvision's module names, so that the state_dict keys under
`sfnet.features.` are the reference's (its `ReMobileNetV2`, `ReResNet` and
`ReVGG` wrap the torchvision classifiers):

- MobileNetV2: `features.{0..17}`; `features.0` is the 3->32 stride-2 stem
  (`S2DStem` with `s2d_stem=True`, same keys), 1..17 the inverted-residual
  blocks; cut after features 1/3/6/13/17 (16, 24, 32, 96, 320 channels).
- ResNet: `conv1`, `bn1` (7x7 stride-2 stem, ReLU, 3x3 stride-2 max-pool),
  then `layer{1..4}.{b}` blocks with `conv{k}`, `bn{k}` and, where the
  stride or width changes, `downsample.{0,1}`; c1 is the pooled stem, c2..c5
  the four layers.
- VGG16: `features.{i}` at torchvision's indices (convs with a bias and no
  BatchNorm, ReLUs, max-pools); each stage ends in its 2x2 max-pool.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import BatchNorm, ConvBNAct, DWBlock, S2DStem

# c2..c5 widths per backbone
FEATURE_INPLANES = {
    "vgg16": [128, 256, 512, 512],
    "resnet18": [64, 128, 256, 512],
    "resnet34": [64, 128, 256, 512],
    "resnet50": [256, 512, 1024, 2048],
    "resnet101": [256, 512, 1024, 2048],
    "resnet152": [256, 512, 1024, 2048],
    "mobilenet_v2": [24, 32, 96, 320],
}

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

# block kind and blocks per layer
RESNET_LAYERS = {
    "resnet18": ("basic", [2, 2, 2, 2]),
    "resnet34": ("basic", [3, 4, 6, 3]),
    "resnet50": ("bottleneck", [3, 4, 6, 3]),
    "resnet101": ("bottleneck", [3, 4, 23, 3]),
    "resnet152": ("bottleneck", [3, 8, 36, 3]),
}

# (channels, convs) per VGG16 stage; each stage ends in a 2x2 max-pool
VGG16_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


class MobileNetV2Pyramid(nn.Module):
    def __init__(self, s2d_stem: bool = False):
        super().__init__()
        layers = [S2DStem(3, 32) if s2d_stem else ConvBNAct(3, 32, 3, stride=2)]
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


def _downsample(in_ch: int, out_ch: int, stride: int):
    """The projection shortcut (1x1 conv and BatchNorm, `downsample.{0,1}`)
    where the block's stride or width changes, else None."""
    if stride == 1 and in_ch == out_ch:
        return None
    return ConvBNAct(in_ch, out_ch, 1, stride, act=False)


class BasicBlock(nn.Module):
    """relu(bn2(conv2(relu(bn1(conv1(x))))) + shortcut(x)), two 3x3 convs."""

    # the conv/BatchNorm pairs that `ops/fold.py::fold_conv_bn` folds
    conv_bn_pairs = (("conv1", "bn1"), ("conv2", "bn2"))

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    """1x1 reduce to out_ch / 4, 3x3 (the stride), 1x1 expand to out_ch, each
    with BatchNorm, ReLU after the first two and after the shortcut sum."""

    conv_bn_pairs = (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        width = out_ch // 4
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetPyramid(nn.Module):
    """(pooled stem, layer1, layer2, layer3, layer4), as the reference's
    ReResNet returns them."""

    conv_bn_pairs = (("conv1", "bn1"),)

    def __init__(self, name: str = "resnet50"):
        super().__init__()
        kind, layers = RESNET_LAYERS[name]
        block = BasicBlock if kind == "basic" else Bottleneck
        expansion = 1 if kind == "basic" else 4
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for i, n in enumerate(layers):
            out_ch = 64 * 2 ** i * expansion
            blocks = []
            for b in range(n):
                blocks.append(block(in_ch, out_ch, (1 if i == 0 else 2) if b == 0 else 1))
                in_ch = out_ch
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = [x]
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        return tuple(outs)


class VGGPyramid(nn.Module):
    """VGG16's `features` at torchvision's indices; the five stages each end
    in their max-pool."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for ch, n in VGG16_CFG:
            for _ in range(n):
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                outs.append(x)
        return tuple(outs)


def build_backbone(cnn_type: str, s2d_stem: bool = False) -> nn.Module:
    """The pyramid of `cnn_type`, as the JAX package's `build_backbone`
    builds it: `s2d_stem` is MobileNetV2's only, and an unknown name raises."""
    cnn_type = cnn_type.lower()
    if cnn_type == "mobilenet_v2":
        return MobileNetV2Pyramid(s2d_stem)
    if s2d_stem:
        raise NotImplementedError(f"s2d_stem is only implemented for mobilenet_v2 (got {cnn_type})")
    if cnn_type in RESNET_LAYERS:
        return ResNetPyramid(cnn_type)
    if cnn_type == "vgg16":
        return VGGPyramid()
    raise NotImplementedError(cnn_type)
