"""Serving steps (counterparts of `iip_uavsal_saliency_tpu/parallel/steps.py`:
`_build_infer_fn` and `make_baked_infer_step`).

uint8 frames go to the device as they are and are normalized there
(/255, ImageNet mean/std, in f32), then cast to the compute dtype with the
carried state and the priors; the model runs in eval form under
`torch.inference_mode()`, and the saliency comes back in f32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from ..ops.layers import DWBlock

Step = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def build_infer_fn(model: nn.Module, compute_dtype: Optional[torch.dtype] = None):
    """`fn(x, gauss, ob, state) -> (saliency, new_state)` over `model` as it
    is (its parameters must already be in `compute_dtype`)."""
    device = _model_device(model)
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def cast(t):
        return None if t is None or compute_dtype is None else t.to(compute_dtype)

    def step(x, gauss, ob, state):
        with torch.inference_mode():
            if x.dtype == torch.uint8:
                x = (x.float() / 255.0 - mean) / std
            if compute_dtype is not None:
                x, state, gauss, ob = cast(x), cast(state), cast(gauss), cast(ob)
            out, new_state = model(x, gauss, ob, state)
            return out.float(), new_state

    return step


def make_baked_infer_step(model: nn.Module, gauss: Optional[torch.Tensor] = None,
                          ob: Optional[torch.Tensor] = None,
                          compute_dtype: Optional[torch.dtype] = None) -> Step:
    """`step(x, state) -> (saliency, new_state)` with the weights and priors
    cast once and frozen.

    Takes `model` over: it is cast to `compute_dtype` in place with its 4-D
    weights stored channels-last (and, with the fused dwBlock on, packed
    for its kernel), and must not be trained or loaded afterwards. Give it a model from `load_model_for_inference`, whose
    BatchNorms are already folded into the convs. The priors are moved to
    the model's device and cast once."""
    device = _model_device(model)
    model.eval().requires_grad_(False)
    if compute_dtype is not None:
        model.to(compute_dtype)
    model.to(memory_format=torch.channels_last)
    dtype = compute_dtype or torch.float32
    for block in model.modules():
        if isinstance(block, DWBlock) and block.use_kernel:
            block.pack(dtype)  # the fused kernel's weights, once

    def prep(p):
        return None if p is None else torch.as_tensor(p).to(device=device, dtype=dtype)

    gauss, ob = prep(gauss), prep(ob)
    inner = build_infer_fn(model, compute_dtype)

    def step(x, state):
        return inner(x, gauss, ob, state)

    return step
