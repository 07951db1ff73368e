"""Train-mode BatchNorm over the batch of every rank (what XLA does for a
BatchNorm inside the JAX package's jit over a V-sharded batch).

`torch.nn.SyncBatchNorm` runs only on CUDA tensors; this runs on either.
Each rank takes its count, mean and sum of squared deviations per channel
(two-pass, in f32 at least and f64 for f64 input), all ranks gather them
and combine them by Chan's parallel formula, so the variance is never
E[x^2] - E[x]^2 (which cancels badly after ReLU6, `ops/layers.py`). The
activation is normalized with the biased variance; the running stats move
by the same EMA as `F.batch_norm`'s, with the unbiased factor taken from
the global count. The backward all-reduces sum(dy) and sum(dy * x_hat) per
channel before the usual formula; the gradients of the scale and the bias
it returns are this rank's sums, which the train step's gradient
all-reduce adds up with every other parameter's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mesh import RankGroup


def _dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def _shape(x: torch.Tensor) -> Tuple[int, ...]:
    return (1, -1) + (1,) * (x.dim() - 2)


def combine_moments(counts: torch.Tensor, means: torch.Tensor,
                    m2s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, mean, sum of squared deviations) of the union of R parts
    from each part's (R,), (R, C), (R, C): Chan's parallel formula,
    M2 = sum M2_r + sum n_r (mean_r - mean)^2, exact in exact arithmetic
    and free of the cancellation of E[x^2] - E[x]^2."""
    n = counts.sum()
    w = (counts / n).unsqueeze(1)
    mean = (w * means).sum(0)
    m2 = m2s.sum(0) + (counts.unsqueeze(1) * (means - mean) ** 2).sum(0)
    return n, mean, m2


class _CrossRankBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, group, parts):
        dt = torch.promote_types(x.dtype, torch.float32)
        dims = _dims(x)
        xf = x.to(dt)
        rows = []
        for chunk in xf.chunk(parts):
            local_n = chunk.numel() // x.shape[1]
            var, mean = torch.var_mean(chunk, dim=dims, unbiased=False)
            rows.append(torch.cat([mean.new_full((1,), float(local_n)), mean, var * local_n]))
        moments = torch.stack(rows)
        if group is not None:
            moments = group.all_gather(moments).flatten(0, 1)
        c = x.shape[1]
        n, mean, m2 = combine_moments(moments[:, 0], moments[:, 1:1 + c], moments[:, 1 + c:])
        invstd = torch.rsqrt(m2 / n + eps)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.mul_(1.0 - momentum).add_(mean.to(running_mean.dtype),
                                                       alpha=momentum)
                unbiased = m2 / (n - 1.0)
                running_var.mul_(1.0 - momentum).add_(unbiased.to(running_var.dtype),
                                                      alpha=momentum)
        shape = _shape(x)
        y = (xf - mean.view(shape)) * (invstd * weight.to(dt)).view(shape) + bias.to(dt).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n, ctx.parts = group, n, len(rows)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dt = mean.dtype
        dims, shape = _dims(x), _shape(x)
        x_hat = (x.to(dt) - mean.view(shape)) * invstd.view(shape)
        dyf = dy.to(dt)
        local = None
        for d, dx_hat in zip(dyf.chunk(ctx.parts), (dyf * x_hat).chunk(ctx.parts)):
            sums = torch.stack([d.sum(dims), dx_hat.sum(dims)])
            local = sums if local is None else local + sums
        both = local if ctx.group is None else ctx.group.all_reduce(local)
        n = ctx.n
        dx = (weight.to(dt) * invstd).view(shape) * (
            dyf - (both[0] / n).view(shape) - x_hat * (both[1] / n).view(shape))
        return (dx.to(x.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype),
                None, None, None, None, None, None)


def cross_rank_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          running_mean: Optional[torch.Tensor],
                          running_var: Optional[torch.Tensor], momentum: float, eps: float,
                          group: Optional[RankGroup], parts: int = 1) -> torch.Tensor:
    """Train-mode BatchNorm of x (N, C, ...) over dim 1 with the statistics
    of the batch of every rank of `group` (None: this rank's alone), the
    running stats (where given) moved in place by `momentum` in torch's
    convention (new = (1 - m) * old + m * batch). Every rank must call it at
    the same point of its forward, and run the backward likewise.

    `parts` > 1 takes x's N rows as that many equal parts, each reduced as
    a rank reduces its own and combined as the ranks' are: one process that
    holds N ranks' rows gives the ranks' arithmetic, sum for sum (in a
    random network in bf16, a BatchNorm output one ulp off, which another
    order of the same sums gives now and then, moves the train step's
    gradients and state by O(1), so only such a process can hold the ranks'
    step)."""
    return _CrossRankBatchNorm.apply(x, weight, bias, running_mean, running_var, momentum,
                                     eps, group, parts)
