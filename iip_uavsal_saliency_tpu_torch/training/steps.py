"""The TBPTT train step and the validation step (counterparts of
`iip_uavsal_saliency_tpu/parallel/steps.py`: `TrainState`,
`create_train_state`, `make_train_step`, `make_eval_step`), and the image
stage's steps (`make_image_train_step`, `make_image_eval_step`: the jitted
steps of `iip_uavsal_saliency_tpu/training/image_trainer.py`).

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

`remat=True` wraps the forward, the bf16 casts included, in one
`torch.utils.checkpoint` (non-reentrant), the counterpart of
`jax.checkpoint` around the JAX step's forward: the backward recomputes the
activations it needs. The recompute runs inside
`ops/layers.py::running_stats_held`, so the BatchNorm running stats move
once a step, in the forward, as in the JAX package; K1's forward runs again
in it (ConvTWA's `autograd.Function` is part of what is recomputed).

`group` (a `parallel.RankGroup`) trains data-parallel, the counterpart of
the JAX step jitted over a mesh's `data` axis: each rank holds its rows of
the V batch, the forward runs inside `parallel.batch_over(group)` (train-mode
BatchNorm takes the statistics of every rank's batch) and is given the whole
batch's V (`videos=`), the loss is this rank's share of the loss of the
whole batch (`rank_share`), the f32 master gradients are summed over the
ranks in one flat all-reduce after the backward, and Adam then takes the
same step on every rank, so the replicas stay equal. The loss that comes
back is the whole batch's on every rank. A PyTorch optimizer updates the
parameters in place, which is what `donate` buys.

`mesh` (`parallel.make_mesh`) trains on a data x spatial mesh, the JAX step
jitted over such a mesh: each rank holds its videos (its rows of V over the
data axis) and its band of their rows, of y's and of the state's
(`Mesh.band`). The forward runs on bands (`parallel/spatial.py`), its
train-mode BatchNorms reduce over every rank of the mesh, each with its own
count of pixels; the saliency and y are gathered over the spatial axis
before the loss, whose share is the data axis's (each spatial rank computes
the same loss, and its backward carries its band's part of it); the
gradients are summed over the whole mesh and the loss reported is summed
over the data axis alone. On a data x seq mesh each rank holds its videos
and its run of their frames (`Mesh.frames`, x's and y's; the carried state
is whole on every rank of the seq axis, and the new one comes back so):
the forward runs on its frames (`parallel/seq.py`), its train-mode
BatchNorms reduce over every rank of the mesh, the loss's terms are per
frame, so each rank's share is the mean over its frames divided by the
mesh's ranks (no map is gathered), and the gradients and the loss are
summed over the whole mesh. The `model` axis is not ported (ROADMAP
A.13.3).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from ..ops.layers import running_stats_held
from ..parallel import seq, spatial
from ..parallel.mesh import Axis, Mesh, RankGroup, batch_over
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


def _as_params(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x in the dtype of the model's parameters (an f64 model takes f64)."""
    return x.to(next(model.parameters()).dtype)


def _loss(loss_fn, out, y_true):
    """The loss in f32 (f64 for an f64 model) over the flattened (V*S) frames."""
    v, s = out.shape[0], out.shape[1]
    out = out.to(torch.promote_types(out.dtype, torch.float32))
    return loss_fn(out.reshape(v * s, *out.shape[2:]), y_true.reshape(v * s, *y_true.shape[2:]))


def _recompute_contexts():
    """(forward's context, recompute's context) for `checkpoint`."""
    return contextlib.nullcontext(), running_stats_held()


def rank_share(loss_fn: Callable, group: Optional[RankGroup]) -> Callable:
    """`loss_fn` as this rank's share of the loss of every rank's batch,
    whose sum over the ranks is the whole batch's loss: a masked loss made
    for `group` (`training/trainer.py::_masked_loss`, which divides by the
    count of valid frames of every rank) as it is, a mean over the frames
    (the losses of `training/losses.py`; each rank holds as many) divided by
    the world size. Without a group, `loss_fn` itself. A masked loss made
    for no group, or another, is refused: the mean of each rank's masked
    mean is not the whole batch's where the ranks hold different counts of
    valid frames."""
    if group is None:
        return loss_fn
    if hasattr(loss_fn, "group"):
        if loss_fn.group is not group:
            raise ValueError("a masked loss in a data-parallel step must be made for the "
                             "step's group (`_masked_loss(loss, group)`)")
        return loss_fn

    def share(pred, true):
        return loss_fn(pred, true) / group.world

    return share


class _Axes(NamedTuple):
    """The groups a step made with a group or a mesh runs over."""
    share: Optional[RankGroup]     # the ranks whose shares sum to the loss
    everyone: Optional[RankGroup]  # what the BatchNorms and the gradients reduce over
    data: Optional[RankGroup]      # the ranks whose videos make up the batch
    bands: Optional[Axis] = None   # the spatial axis
    frames: Optional[Axis] = None  # the seq axis


def _axes(group: Optional[RankGroup], mesh: Optional[Mesh]) -> _Axes:
    """The groups of a step made with `group` or with `mesh`."""
    if mesh is None:
        return _Axes(group, group, group)
    if group is not None:
        raise ValueError("a step takes a group or a mesh, not both")
    mesh.check_active()
    if mesh.n_seq > 1:  # each rank's frames are its share of the loss
        return _Axes(mesh.everyone, mesh.everyone, mesh.data, frames=mesh.seq)
    return _Axes(mesh.data, mesh.everyone, mesh.data,
                 bands=mesh.spatial if mesh.n_spatial > 1 else None)


def _check_model(model: nn.Module, axes: _Axes) -> None:
    if axes.bands is not None:
        spatial.check_model(model)
    if axes.frames is not None:
        seq.check_model(model)


@contextlib.contextmanager
def _split(axes: _Axes):
    """The model's forward over the batch that `axes` split."""
    with batch_over(axes.everyone), spatial.over(axes.bands), seq.over(axes.frames, axes.data):
        yield


def _gathered(out, y_true, axis):
    """The saliency and y over the whole image: their rows gathered over the
    spatial axis (the loss normalizes over the whole map)."""
    if axis is None:
        return out, y_true
    return (spatial.gather_rows(t, t.shape[2] * axis.world, 2, axis) for t in (out, y_true))


def _whole_batch(x: torch.Tensor, axes: _Axes) -> dict:
    """The model's `videos` keyword where x is this rank's rows of the
    whole batch: the V the model's context tile and temporal-difference
    bound read (the JAX step's jit sees the whole batch)."""
    return {} if axes.data is None else {"videos": x.shape[0] * axes.data.world}


def all_reduce_grads(model: nn.Module, group) -> None:
    """Sum the parameters' gradients over the ranks, in place, in one flat
    all-reduce (every rank has gradients for the same parameters)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def make_train_step(state: TrainState, loss_fn: Callable = loss_fu,
                    compute_dtype: Optional[torch.dtype] = None, remat: bool = False,
                    group: Optional[RankGroup] = None, mesh: Optional[Mesh] = None):
    """step(x, gauss, ob, rnn_state, y_true) -> (loss, new_rnn_state) over
    `state` (its model and optimizer are updated in place, its step counted).

    x: (V, S, H, W, 3) uint8 or normalized f32; y_true: (V, S, Ho, Wo, C);
    rnn_state: (V, Ho, Wo, planes); a prior the model's `bias_type` leaves
    off is None. The loss comes back as a detached f32
    scalar on the device, the new state detached and in f32. `remat`
    recomputes the forward in the backward, and `group` trains
    data-parallel, x, y_true and rnn_state being this rank's rows; `mesh`
    trains on a data x spatial mesh, x, y_true and rnn_state being this
    rank's videos and its band of their rows, or on a data x seq mesh, x
    and y_true being this rank's videos and its run of their frames and
    rnn_state its videos' whole state (module docstring)."""
    model, optimizer = state.model, state.optimizer
    axes = _axes(group, mesh)
    _check_model(model, axes)
    share = rank_share(loss_fn, axes.share)

    def forward(x, gauss, ob, rnn_state):
        kw = _whole_batch(x, axes)
        if compute_dtype is None:
            return model(x, gauss, ob, rnn_state, **kw)
        cast = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
        args = tuple(None if t is None else t.to(compute_dtype) for t in (x, gauss, ob, rnn_state))
        return torch.func.functional_call(model, cast, args, kw)

    def rematerialized(*args):
        return checkpoint(forward, *args, use_reentrant=False, context_fn=_recompute_contexts)

    run = rematerialized if remat else forward

    def step(x, gauss, ob, rnn_state, y_true) -> Tuple[torch.Tensor, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        # the recompute of remat runs in the backward
        with _split(axes):
            out, new_rnn = run(_maybe_normalize(x), gauss, ob, rnn_state.detach())
            loss = _loss(share, *_gathered(out, y_true, axes.bands))
            loss.backward()
        if axes.everyone is not None:
            all_reduce_grads(model, axes.everyone)
            loss = axes.share.all_reduce(loss.detach())
        optimizer.step()
        state.step += 1
        return loss.detach(), new_rnn.detach().to(torch.promote_types(new_rnn.dtype,
                                                                       torch.float32))

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable = loss_fu,
                   group: Optional[RankGroup] = None, mesh: Optional[Mesh] = None):
    """step(x, gauss, ob, rnn_state, y_true) -> (loss, new_rnn_state): the
    model in eval mode (BatchNorm from the running stats) in f32, no
    gradient, the state carried. It runs the model as it is, not the folded
    serving step. With `group` (or `mesh`), x, y_true and rnn_state are this
    rank's rows (and band) and the loss is the whole batch's, as in
    `make_train_step`."""
    axes = _axes(group, mesh)
    _check_model(model, axes)
    share = rank_share(loss_fn, axes.share)

    def step(x, gauss, ob, rnn_state, y_true) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        with torch.no_grad(), _split(axes):
            out, new_rnn = model(_maybe_normalize(x), gauss, ob, rnn_state,
                                 **_whole_batch(x, axes))
            loss = _loss(share, *_gathered(out, y_true, axes.bands))
        return (loss if axes.share is None else axes.share.all_reduce(loss)), new_rnn

    return step


def make_image_train_step(state: TrainState, loss_fn: Callable = loss_fu):
    """step(x, y_true) -> loss for the image stage's model (`SRFNetImage`):
    the train-mode forward (batch statistics), the loss, the backward and
    the optimizer's step, over a batch of images x (B, H, W, 3), uint8 or
    normalized, and targets y_true (B, Ho, Wo, 2) [map, fixations]. It
    runs in the parameters' dtype: f32, as the JAX image trainer (no mixed
    precision; an f64 model, as the tests build one, runs in f64). The loss
    comes back as a detached scalar on the device."""
    model, optimizer = state.model, state.optimizer

    def step(x, y_true) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(_as_params(model, _maybe_normalize(x)))
        loss = loss_fn(out.to(torch.promote_types(out.dtype, torch.float32)), y_true)
        loss.backward()
        optimizer.step()
        state.step += 1
        return loss.detach()

    return step


def make_image_eval_step(model: nn.Module, loss_fn: Callable = loss_fu):
    """step(x, y_true) -> loss: the image stage's model in eval mode
    (BatchNorm from the running stats, not folded), no gradient."""

    def step(x, y_true) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            return loss_fn(model(_as_params(model, _maybe_normalize(x))), y_true)

    return step
