"""The seq axis: a clip's frames over ranks (what GSPMD inserts for the `seq`
axis of the JAX package's mesh, `iip_uavsal_saliency_tpu/parallel/mesh.py`:
the one-frame halo of the temporal differences, the cross-shard BatchNorm
reductions and the gather that feeds the sequential TWA scan).

Each rank of a mesh's seq axis holds a run of S / n consecutive frames of
every video of its data shard (`Mesh.frames`), rank q frames q*S/n ...
(q+1)*S/n - 1. A per-frame layer runs on its frames as it is; what reads
other frames fetches them:

- `over(axis, data)`: inside, the seq forms of the model are on
  (`current()` is the axis, `data()` the mesh's data axis); outside,
  everything is as it was.
- `halo_frames(x, n)`: the last n frames of the rank before and the first n
  of the rank after, point to point (none at the clip's ends); the
  backward sends each halo frame's gradient back to its owner, which adds
  it to its frame's (the temporal differences, `models/stblock.py`).
- `gather_groups(x, t, frames)`: the sums over each group of t consecutive
  frames of the whole clip, on every rank: each rank sums what it holds of
  each group (a group may straddle two ranks) and the partial sums are
  all-reduced; the backward all-reduces the gradient likewise (the
  context stream, `models/uavsal.py`).
- `hand_state(scan, x, gx, w_h, state)`: the TWA chain. Rank q receives h
  from rank q - 1 (the first rank takes the carried state), runs the scan
  over its frames and sends its last h to rank q + 1; in the backward the gradient
  of h0 goes back to rank q - 1, which adds it to the gradient of its last
  h. The last rank's final h is broadcast as the new state, which every
  rank of the axis returns (the JAX `_state_sharding` gives the state no
  seq axis).

Every rank runs every exchange at the same point, forward and backward: the
ranks at the clip's ends run them with nothing to send on that side. In the
backward, rank q's `hand_state` waits for rank q + 1's gradient of h0,
which rank q + 1 sends once its scan's backward has run. Every collective
that the backward meets before it (the head's BatchNorms) lies after the
scan in the forward, and the gradients of the scan's inputs x and gx reach
the layers before the scan (the trunk's BatchNorms) only through the node
that sends (`_Receive`), so no rank enters a collective that its
successor reaches only after sending.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Tuple

import torch

from .mesh import Axis

_axis: Optional[Axis] = None
_data: Optional[Axis] = None


def current() -> Optional[Axis]:
    """The seq axis the model runs on (set by `over`), or None."""
    return _axis


def data() -> Optional[Axis]:
    """The data axis beside `current()` (set by `over`): the ranks that
    hold the other videos of the batch."""
    return _data


@contextlib.contextmanager
def over(axis: Optional[Axis], data_axis: Optional[Axis] = None) -> Iterator[None]:
    """Inside, the model takes a run of each clip's frames along `axis`
    (None, or an axis of one rank: the whole clip, as before); `data_axis`
    is the mesh's data axis. Globals, not thread-locals, as `batch_over`:
    the autograd engine runs a backward, and the recompute of a
    checkpointed forward, on a thread of its own."""
    global _axis, _data
    prev = _axis, _data
    on = axis is not None and axis.world > 1
    _axis, _data = (axis, data_axis) if on else (None, None)
    try:
        yield
    finally:
        _axis, _data = prev


def check_model(model) -> None:
    """NotImplementedError unless `model` is UAVSal (any backbone, bias
    type and number of ST blocks): the zoo's 3-D windows in time and
    UAVSalLSTM's ConvLSTM chain have no seq form."""
    if getattr(model, "model_name", None) != "uavsal":
        name = getattr(model, "model_name", type(model).__name__)
        raise NotImplementedError(f"the seq axis runs UAVSal only, not {name} "
                                  "(ROADMAP A.13.2b)")


def segment(frames: int, axis: Optional[Axis] = None) -> Tuple[int, int]:
    """(the clip's index of this rank's first frame, the clip's frames)
    where each rank holds `frames` of each video; (0, frames) off a seq
    mesh."""
    axis = axis or current()
    if axis is None:
        return 0, frames
    return axis.rank * frames, frames * axis.world


def _empty_frames(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros((x.shape[0], 0) + tuple(x.shape[2:]))


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, n):
        me, last = axis.rank, axis.world - 1
        ctx.axis, ctx.n, ctx.frames = axis, n, x.shape[1]
        sends, recvs = [], []
        before = after = _empty_frames(x)
        if me > 0:
            sends.append((me - 1, axis.staged(x[:, :n]).contiguous()))
            before = axis.staged(x.new_empty((x.shape[0], n) + tuple(x.shape[2:])))
            recvs.append((me - 1, before))
        if me < last:
            sends.append((me + 1, axis.staged(x[:, -n:]).contiguous()))
            after = axis.staged(x.new_empty((x.shape[0], n) + tuple(x.shape[2:])))
            recvs.append((me + 1, after))
        axis.exchange(sends, recvs)
        return before.to(x.device), after.to(x.device)

    @staticmethod
    def backward(ctx, grad_before, grad_after):
        axis, n = ctx.axis, ctx.n
        me, last = axis.rank, axis.world - 1
        sends, recvs = [], []
        from_after = from_before = None
        if me > 0:
            sends.append((me - 1, axis.staged(grad_before).contiguous()))
            from_before = axis.staged(torch.empty_like(grad_before))
            recvs.append((me - 1, from_before))
        if me < last:
            sends.append((me + 1, axis.staged(grad_after).contiguous()))
            from_after = axis.staged(torch.empty_like(grad_after))
            recvs.append((me + 1, from_after))
        axis.exchange(sends, recvs)
        shape = (grad_before.shape[0], ctx.frames) + tuple(grad_before.shape[2:])
        grad = grad_before.new_zeros(shape)
        if from_before is not None:  # my first frames, read by the rank before
            grad[:, :n] += from_before.to(grad.device)
        if from_after is not None:  # my last frames, read by the rank after
            grad[:, -n:] += from_after.to(grad.device)
        return grad, None, None


def halo_frames(x: torch.Tensor, n: int = 1,
                axis: Optional[Axis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the rank before's last n frames, the rank after's first n frames)
    of x (V, S_rank, ...), this rank's frames of each video, each (V, n,
    ...), or (V, 0, ...) at the clip's first and last rank. Every rank of
    the axis must call it at the same point. Differentiable: the gradient
    of a halo frame goes back to its owner. Off a seq mesh, (V, 0, ...)
    each."""
    axis = axis or current()
    if axis is None:
        return _empty_frames(x), _empty_frames(x)
    if x.shape[1] < n:
        raise ValueError(f"a halo of {n} frames from a rank of {x.shape[1]}")
    return _Halo.apply(x, axis, n)


class _AllReduce(torch.autograd.Function):
    """The sum over the axis, laid out in memory as x; its gradient is the
    sum of every rank's gradient of the sum, which every rank used."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return torch.empty_like(x).copy_(axis.all_reduce(x.contiguous()))

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad.contiguous()), None


def gather_groups(x: torch.Tensor, t: int, frames: int,
                  axis: Optional[Axis] = None) -> torch.Tensor:
    """The sum of each group of t consecutive frames of the whole clip,
    (V * G, ...) with G = S / t groups per video, on every rank of the
    axis, from x (V * frames, ...), this rank's frames of each of V videos.
    A group may lie across two or more ranks; each adds what it holds and
    zeros for the groups it holds none of. Every rank of the axis must call
    it at the same point. Off a seq mesh, the sums of x's own groups."""
    axis = axis or current()
    first, clip = segment(frames, axis)
    if clip % t:
        raise ValueError(f"S={clip} is not a multiple of time_dims={t}")
    v = x.shape[0] // frames
    lo, hi = first // t, (first + frames - 1) // t + 1  # the groups this rank touches
    rest = tuple(x.shape[1:])
    seqs = x.reshape(v, frames, *rest)
    pad = (first - lo * t, hi * t - first - frames)
    if any(pad):
        seqs = torch.cat([seqs.new_zeros((v, pad[0]) + rest), seqs,
                          seqs.new_zeros((v, pad[1]) + rest)], 1)
    part = seqs.reshape(v, hi - lo, t, *rest).sum(dim=2)
    groups = clip // t
    if (lo, hi) != (0, groups):
        part = torch.cat([part.new_zeros((v, lo) + rest), part,
                          part.new_zeros((v, groups - hi) + rest)], 1)
    part = part.reshape(v * groups, *rest)
    return part if axis is None else _AllReduce.apply(part, axis)


class _Receive(torch.autograd.Function):
    """(x, gx, h0): x and gx as they are, h0 from the rank before (the
    carried state on the first rank). x and gx go through it so that its
    backward, which sends the gradient of h0 back, runs after the scan's
    and before any gradient reaches the layers before the scan (and their
    collectives); W_h only ties it into the graph where the scan's weight
    alone wants a gradient."""

    @staticmethod
    def forward(ctx, x, gx, w_h, state, axis):
        ctx.axis = axis
        if axis.rank == 0:
            h0 = state.clone()
        else:
            h0 = axis.staged(torch.empty_like(state))
            axis.exchange([], [(axis.rank - 1, h0)])
            h0 = h0.to(state.device)
        return x.view_as(x), gx.view_as(gx), h0

    @staticmethod
    def backward(ctx, grad_x, grad_gx, grad_h0):
        axis = ctx.axis
        if axis.rank == 0:
            return grad_x, grad_gx, None, grad_h0, None
        axis.exchange([(axis.rank - 1, axis.staged(grad_h0).contiguous())], [])
        return grad_x, grad_gx, None, None, None


class _SendOn(torch.autograd.Function):
    """ys as it is, its last frame sent to the rank after; the backward
    adds the gradient of that rank's h0 to the last frame's."""

    @staticmethod
    def forward(ctx, ys, axis):
        ctx.axis = axis
        if axis.rank < axis.world - 1:
            axis.exchange([(axis.rank + 1, axis.staged(ys[:, -1]).contiguous())], [])
        return ys.view_as(ys)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        if axis.rank == axis.world - 1:
            return grad, None
        h = axis.staged(torch.empty_like(grad[:, -1]))
        axis.exchange([], [(axis.rank + 1, h)])
        grad = grad.clone()
        grad[:, -1] += h.to(grad.device)
        return grad, None


def hand_state(scan: Callable[..., torch.Tensor], x: torch.Tensor, gx: torch.Tensor,
               w_h: torch.Tensor, state: torch.Tensor,
               axis: Optional[Axis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys, the clip's new state) of the TWA chain over the axis: h0 from
    the rank before (`state`, the carried state, on the first rank),
    `scan(x, gx, w_h, h0)` -> ys (V, frames, H, W, C) over this rank's
    frames, ys's last frame sent on to the rank after; the new state is the
    last rank's last frame, on every rank (no gradient flows through it:
    the step detaches the carried state). Differentiable in ys and through
    h0 (`_Receive` says why x and gx pass through it)."""
    axis = axis or current()
    x, gx, h0 = _Receive.apply(x, gx, w_h, state, axis)
    ys = _SendOn.apply(scan(x, gx, w_h, h0), axis)
    with torch.no_grad():
        new_state = axis.broadcast(ys[:, -1].contiguous(), axis.world - 1)
    return ys, new_state
