"""The spatial axis: image rows over ranks (what GSPMD inserts for the
`spatial` axis of the JAX package's mesh, `parallel/steps.py`).

Each rank of a mesh's spatial axis holds a band of rows of every map of the
model. A map of H rows splits as `P("spatial")` splits an array: bands of
ceil(H / n) rows in rank order, the last ones short or empty (`owned`); at
a step's boundary H and H/8 divide by n (`Mesh.band`), inside the model
(H/16, H/32) they need not. A layer whose output rows read rows of its
input beyond the band fetches them (`rows`) and runs on them with its own
row padding off; a pointwise layer runs on its band as it is.

- `over(axis)`: inside, the band forms of the layers are on
  (`current()` is the axis); outside, every layer is as it was.
- `rows(x, height, needs)`: the global rows [lo, hi) that this rank asks
  for (`needs[rank]`) of a map of `height` rows held in bands, with zeros
  for rows outside the image. Every rank knows what every rank asks for
  (the geometry is the same on each), so nothing is negotiated: rows that
  lie in the band of an adjacent rank come by point-to-point
  (`dist.batch_isend_irecv`, which gloo and NCCL both take); where a rank
  asks for rows beyond its neighbours' bands (the ASPP's dilations, a
  resize from a map of a few rows) every band is gathered. The backward
  sends the gradient of each fetched row back to its owner, which adds it
  to its band's.
- `gather_rows(x, height)`: the whole map on every rank; the backward keeps
  this rank's band of the gradient (the loss over the whole map is the same
  on every rank of the axis, so is its gradient).
- `window_needs`: what each rank asks for under a conv or pool window.

A band of no rows goes through every exchange like any other, so that the
ranks' collectives stay in step, forward and backward.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis

Span = Tuple[int, int]

_axis: Optional[Axis] = None


def current() -> Optional[Axis]:
    """The spatial axis the model runs on (set by `over`), or None."""
    return _axis


@contextlib.contextmanager
def over(axis: Optional[Axis]) -> Iterator[None]:
    """Inside, the layers take bands of the rows of `axis` (None, or an
    axis of one rank: the whole map, as before). A global, not a
    thread-local, as `batch_over`: the autograd engine runs a backward, and
    the recompute of a checkpointed forward, on a thread of its own."""
    global _axis
    prev, _axis = _axis, (axis if axis is not None and axis.world > 1 else None)
    try:
        yield
    finally:
        _axis = prev


def check_model(model) -> None:
    """NotImplementedError unless `model` is the flagship's class on the
    MobileNetV2 trunk, the only one with band forms."""
    if getattr(model, "model_name", None) != "uavsal" or \
            getattr(model, "cnn_type", None) != "mobilenet_v2":
        name = getattr(model, "model_name", type(model).__name__)
        raise NotImplementedError(
            f"the spatial axis runs UAVSal on MobileNetV2 only, not {name} on "
            f"{getattr(model, 'cnn_type', '?')} (ROADMAP A.13.1b)")


def owned(height: int, n: int, rank: int) -> Span:
    """The rows [lo, hi) of a map of `height` rows that `rank` of `n` holds:
    bands of ceil(height / n), the last ones short or empty."""
    chunk = -(-height // n)
    lo = min(rank * chunk, height)
    return lo, min(lo + chunk, height)


def conv_rows(height: int, kernel: int, stride: int, dilation: int, padding: int) -> int:
    """Output rows of a conv over `height` rows."""
    return (height + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def window_needs(out_height: int, n: int, stride: int, start: int, extent: int) -> List[Span]:
    """What each of `n` ranks asks for of a layer's input when output row o
    reads input rows [stride * o + start, ... + extent): the window of its
    band of `out_height` output rows; (0, 0) for an empty band."""
    needs = []
    for q in range(n):
        lo, hi = owned(out_height, n, q)
        needs.append((stride * lo + start, stride * (hi - 1) + start + extent) if hi > lo
                     else (0, 0))
    return needs


def _overlap(a: Span, b: Span) -> Span:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else (lo, lo)


def _pieces(height: int, n: int, needs: Sequence[Span]) -> List[List[Tuple[int, Span]]]:
    """For each rank, the (owner, rows) pieces of the image that its need
    covers, in row order."""
    bands = [owned(height, n, p) for p in range(n)]
    out = []
    for need in needs:
        spans = [(p, _overlap(need, band)) for p, band in enumerate(bands)]
        out.append([(p, (a, b)) for p, (a, b) in spans if b > a])
    return out


def _adjacent(pieces) -> bool:
    return all(abs(p - q) <= 1 for q, mine in enumerate(pieces) for p, _ in mine)


def _zeros_like_rows(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


def _exchange(axis: Axis, sends, recvs) -> None:
    """Point-to-point: `sends` and `recvs` are (index on the axis, tensor)
    pairs; every send is matched by the peer's recv of the same shape."""
    ops = [dist.P2POp(dist.isend, t, axis.peer(p), axis.pg) for p, t in sends]
    ops += [dist.P2POp(dist.irecv, t, axis.peer(p), axis.pg) for p, t in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _whole(axis: Axis, x: torch.Tensor, height: int, dim: int) -> torch.Tensor:
    """Every rank's band, gathered into the whole map (bands padded to
    ceil(height / n) rows for the gather)."""
    chunk = -(-height // axis.world)
    pad = chunk - x.shape[dim]
    padded = x if pad == 0 else torch.cat([x, _zeros_like_rows(x, dim, pad)], dim)
    parts = axis.all_gather(padded).unbind(0)
    return torch.cat(parts, dim).narrow(dim, 0, height)


def _check_band(axis: Axis, x: torch.Tensor, height: int, dim: int) -> Span:
    band = owned(height, axis.world, axis.rank)
    if x.shape[dim] != band[1] - band[0]:
        raise ValueError(f"rank {axis.rank} of {axis.world} holds rows {band} of a map of "
                         f"{height} rows, got {x.shape[dim]} rows")
    return band


class _Rows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, height, needs, dim):
        n, me = axis.world, axis.rank
        band = _check_band(axis, x, height, dim)
        pieces = _pieces(height, n, needs)
        lo, hi = needs[me]
        ctx.axis, ctx.height, ctx.needs, ctx.dim, ctx.pieces = axis, height, needs, dim, pieces
        ctx.band = band
        ctx.gathered = not _adjacent(pieces)
        if ctx.gathered:
            whole = _whole(axis, x, height, dim)
            parts = [whole.narrow(dim, a, b - a) for _, (a, b) in pieces[me]]
        else:
            sends, recvs, parts = [], [], []
            for q in range(n):
                (a, b) = _overlap(needs[q], band) if q != me else (0, 0)
                if b > a:
                    sends.append((q, axis.staged(x.narrow(dim, a - band[0], b - a)).contiguous()))
            for p, (a, b) in pieces[me]:
                if p == me:
                    parts.append(x.narrow(dim, a - band[0], b - a))
                else:
                    shape = list(x.shape)
                    shape[dim] = b - a
                    buf = axis.staged(x.new_empty(shape))
                    recvs.append((p, buf))
                    parts.append(buf)
            _exchange(axis, sends, recvs)
            parts = [t.to(x.device) for t in parts]
        top = max(0, min(0, hi) - lo) if hi > lo else 0
        bottom = max(0, hi - max(height, lo)) if hi > lo else 0
        if top:
            parts.insert(0, _zeros_like_rows(x, dim, top))
        if bottom:
            parts.append(_zeros_like_rows(x, dim, bottom))
        if not parts:
            return _zeros_like_rows(x, dim, max(0, hi - lo))
        return torch.cat(parts, dim) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, grad):
        axis, height, dim, me = ctx.axis, ctx.height, ctx.dim, ctx.axis.rank
        lo, hi = ctx.needs[me]
        band = ctx.band
        if ctx.gathered:
            whole = _zeros_like_rows(grad, dim, height)
            for _, (a, b) in ctx.pieces[me]:
                whole.narrow(dim, a, b - a).add_(grad.narrow(dim, a - lo, b - a))
            summed = axis.all_reduce(whole)
            return summed.narrow(dim, band[0], band[1] - band[0]).contiguous(), \
                None, None, None, None
        out = _zeros_like_rows(grad, dim, band[1] - band[0])
        sends, recvs = [], []
        for p, (a, b) in ctx.pieces[me]:
            piece = grad.narrow(dim, a - lo, b - a)
            if p == me:
                out.narrow(dim, a - band[0], b - a).add_(piece)
            else:
                sends.append((p, axis.staged(piece).contiguous()))
        for q in range(axis.world):
            a, b = _overlap(ctx.needs[q], band) if q != me else (0, 0)
            if b > a:
                shape = list(grad.shape)
                shape[dim] = b - a
                recvs.append((q, (a, axis.staged(grad.new_empty(shape)))))
        _exchange(axis, sends, [(q, buf) for q, (_, buf) in recvs])
        for _, (a, buf) in recvs:
            out.narrow(dim, a - band[0], buf.shape[dim]).add_(buf.to(out.device))
        return out, None, None, None, None


def rows(x: torch.Tensor, height: int, needs: Sequence[Span], dim: int = 2,
         axis: Optional[Axis] = None) -> torch.Tensor:
    """Rows needs[rank] of the map of `height` rows whose band along `dim`
    this rank holds in x, with zeros for rows outside [0, height), in x's
    dtype (`cat` gives up a channels-last layout: `ops/layers.py::laid_out_as`
    takes it back). `needs` holds what every rank of the axis asks
    for (the same list on each); every rank must call it at the same point.
    Differentiable: the gradient of a row goes back to its owner."""
    axis = axis or current()
    return _Rows.apply(x, axis, height, tuple(tuple(n) for n in needs), dim)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, height, dim):
        ctx.band, ctx.dim = _check_band(axis, x, height, dim), dim
        return _whole(axis, x, height, dim)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.band
        return grad.narrow(ctx.dim, lo, hi - lo).contiguous(), None, None, None


def gather_rows(x: torch.Tensor, height: int, dim: int = 2,
                axis: Optional[Axis] = None) -> torch.Tensor:
    """The whole map of `height` rows from every rank's band along `dim`.
    Its gradient keeps this rank's band of the whole map's gradient, which
    is right where every rank of the axis computes the same function of the
    whole map (the loss)."""
    axis = axis or current()
    return _GatherRows.apply(x, axis, height, dim)

