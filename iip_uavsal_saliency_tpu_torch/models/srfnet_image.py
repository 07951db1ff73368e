"""The image-stage model and its transplant into the video model
(counterpart of `iip_uavsal_saliency_tpu/models/srfnet_image.py`).

The reference's recipe is ImageNet MobileNetV2, then SRF-Net fine-tuned on
SALICON, then the video model. `SRFNetImage` is the second stage's model:
UAVSal without its temporal parts, SRF-Net (`sfnet`) -> a 1-channel
DWBlock (`conv_out`) -> sigmoid. Its `sfnet` has the video models' names,
so `transfer_sfnet` moves the trained neck into a video model's JAX-layout
tree as it is.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..ops.layers import DWBlock
from .srfnet import SRFNet

# the image stage's name in the weight bridge (`models/convert.py::table_for`)
IMAGE_MODEL_NAME = "srfnet_image"


class SRFNetImage(nn.Module):
    """forward(x) -> saliency (B, H/8, W/8, 1); x is (B, H, W, 3) normalized
    images, or their (B, 3, H, W) view whose memory is channels-last. In
    train mode BatchNorm takes batch statistics. `init_model` draws its
    weights as the JAX package does: the backbone kaiming fan_in, the neck
    and `conv_out` fan_out. `planes` is the neck's output width (the JAX
    field of that name: SRF-Net's `last_channel`)."""

    model_name = IMAGE_MODEL_NAME
    num_stblock = 0  # what the bridge reads: no ST block, no priors
    bias_type = None

    def __init__(self, cnn_type: str = "mobilenet_v2", planes: int = 256):
        super().__init__()
        self.cnn_type = cnn_type.lower()
        self.planes = planes
        self.sfnet = SRFNet(self.cnn_type, last_channel=planes)
        self.conv_out = DWBlock(planes, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 3:
            x = x.permute(0, 3, 1, 2)
        return torch.sigmoid(self.conv_out(self.sfnet(x))).permute(0, 2, 3, 1)


def is_image_stage_variables(variables: Mapping) -> bool:
    """Whether a JAX `{params, batch_stats}` tree is the image stage's: its
    params hold exactly `sfnet` and `conv_out`. The exact set matters: the
    zoo's flat models name their neck `sfnet` at the top too, beside heads
    of their own."""
    params = variables.get("params", {})
    return isinstance(params, Mapping) and set(params) == {"sfnet", "conv_out"}


def _copied(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _copied(v) for k, v in tree.items()}
    return np.array(tree)


def transfer_sfnet(image_variables: Mapping, video_variables: Mapping) -> Dict[str, Any]:
    """A copy of the video model's JAX tree (`params` and `batch_stats`)
    with the image stage's `sfnet` subtree in the place of its own:
    `trunk/sfnet` for UAVSal and the zoo models with a trunk, the top-level
    `sfnet` for those that inline it. ValueError where it has neither.
    Neither input is changed."""
    out = _copied(video_variables)
    for col in ("params", "batch_stats"):
        dst = out[col]
        if "trunk" in dst and "sfnet" in dst["trunk"]:
            dst = dst["trunk"]
        elif "sfnet" not in dst:
            raise ValueError("video variables have no sfnet subtree (neither trunk/sfnet nor "
                             "top-level sfnet): cannot transplant the image stage's SRF-Net; "
                             f"top-level keys: {sorted(dst)}")
        dst["sfnet"] = _copied(image_variables[col]["sfnet"])
    return out
