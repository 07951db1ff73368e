"""The TBPTT train step and the validation step (counterparts of
`iip_uavsal_saliency_tpu/parallel/steps.py`: `TrainState`,
`create_train_state`, `make_train_step`, `make_eval_step`).

One train step is forward -> loss -> backward -> Adam over one clip of
(V, S) frames. The carried TWA state crosses steps as detached data, so no
gradient flows into the previous clip (the reference's `.detach()` between
clips). uint8 frames are normalized on the device (/255, ImageNet mean and
std, in f32), and the loss is computed in f32.

Mixed precision (`compute_dtype=torch.bfloat16`): the f32 master
parameters are cast to bf16 at the step boundary and the model runs on the
casts (`torch.func.functional_call`), so the gradients land on the f32
masters through the casts and Adam's moments stay f32. Frames, priors and
the TWA state are cast with them, and the state comes back in f32. The
BatchNorm running stats stay f32 buffers: each train-mode BatchNorm
reduces the bf16 activations in f32 and moves the f32 stats directly. The
JAX package instead lets flax write bf16 stats and recovers the f32 EMA
from them (`_accumulate_bn`), which equals this up to one bf16 rounding of
the batch term.

Meshes, sharding, `remat` and `donate` are not part of this module: the
port trains one video at a time on one card (ROADMAP A.9b), and a PyTorch
optimizer updates the parameters in place, which is what donation buys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from .losses import loss_fu


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the f32 masters, its buffers the
    BatchNorm running stats), the optimizer over its trainable parameters,
    and the count of train steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model, optimizer)


def _maybe_normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> /255 and the ImageNet standardization in f32, on
    their device; other dtypes are taken as already normalized."""
    if x.dtype == torch.uint8:
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, device=x.device)
        x = (x.float() / 255.0 - mean) / std
    return x


def _loss(loss_fn, out, y_true):
    """The loss in f32 (f64 for an f64 model) over the flattened (V*S) frames."""
    v, s = out.shape[0], out.shape[1]
    out = out.to(torch.promote_types(out.dtype, torch.float32))
    return loss_fn(out.reshape(v * s, *out.shape[2:]), y_true.reshape(v * s, *y_true.shape[2:]))


def make_train_step(state: TrainState, loss_fn: Callable = loss_fu,
                    compute_dtype: Optional[torch.dtype] = None):
    """step(x, gauss, ob, rnn_state, y_true) -> (loss, new_rnn_state) over
    `state` (its model and optimizer are updated in place, its step counted).

    x: (V, S, H, W, 3) uint8 or normalized f32; y_true: (V, S, Ho, Wo, C);
    rnn_state: (V, Ho, Wo, 256). The loss comes back as a detached f32
    scalar on the device, the new state detached and in f32."""
    model, optimizer = state.model, state.optimizer

    def forward(x, gauss, ob, rnn_state):
        if compute_dtype is None:
            return model(x, gauss, ob, rnn_state)
        cast = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
        args = tuple(t.to(compute_dtype) for t in (x, gauss, ob, rnn_state))
        return torch.func.functional_call(model, cast, args)

    def step(x, gauss, ob, rnn_state, y_true) -> Tuple[torch.Tensor, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out, new_rnn = forward(_maybe_normalize(x), gauss, ob, rnn_state.detach())
        loss = _loss(loss_fn, out, y_true)
        loss.backward()
        optimizer.step()
        state.step += 1
        return loss.detach(), new_rnn.detach().to(torch.promote_types(new_rnn.dtype,
                                                                       torch.float32))

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable = loss_fu):
    """step(x, gauss, ob, rnn_state, y_true) -> (loss, new_rnn_state): the
    model in eval mode (BatchNorm from the running stats) in f32, no
    gradient, the state carried. It runs the model as it is, not the folded
    serving step."""

    def step(x, gauss, ob, rnn_state, y_true) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out, new_rnn = model(_maybe_normalize(x), gauss, ob, rnn_state)
            return _loss(loss_fn, out, y_true), new_rnn

    return step
