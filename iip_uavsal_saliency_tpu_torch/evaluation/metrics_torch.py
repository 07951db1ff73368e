"""Batched saliency metrics on tensors (counterpart of
`iip_uavsal_saliency_tpu/evaluation/metrics_jax.py`).

Layout: pred (N, H, W, 1); true (N, H, W, 2) with channel 0 the fixation
map and channel 1 the binary fixation points. KLD, CC, NSS and SIM are the
training losses' per-frame metrics (`training/losses.py`), as in the JAX
package.

AUC-Judd is computed in closed form from the descending sort: the
reference's ROC polyline has a vertex per fixation with tp_j = j/n_fix and
fp_j = (#pixels above threshold_j - j)/n_nonfix, integrated with the
trapezoid rule. For distinct values the trapezoid sum telescopes to a
per-negative-pixel weight: a non-fixated pixel with c fixations ranked above
it contributes min((2c+1)/(2 n_fix), 1) / n_nonfix. One sort and one cumsum
per frame, all frames in one call.

AUC-Borji and AUC-shuffled (`eval_auc_sweep`) take negative pixel indices
sampled on the host and sweep a fixed grid of thresholds.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..training.losses import metric_cc, metric_kl, metric_nss, metric_sim

EPS = 2.2204e-16

KEYS_ORDER = ["AUC_shuffled", "NSS", "AUC_Judd", "AUC_Borji", "KLD", "SIM", "CC"]


def eval_kl(y_pred, y_true):
    return metric_kl(y_pred, y_true)


def eval_cc(y_pred, y_true):
    return metric_cc(y_pred, y_true)


def eval_nss(y_pred, y_true):
    return metric_nss(y_pred, y_true)


def eval_sim(y_pred, y_true):
    return metric_sim(y_pred, y_true)


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as the f32 values `x` do, with -0.0 equal to
    0.0 (as the JAX package's sort compares them)."""
    i = (x + 0.0).view(torch.int32)
    return (i ^ ((i >> 31) & 0x7FFFFFFF)).long()


def descending_order(s: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per row, the indices that sort `s` descending, ties kept in index
    order; with `u`, ties of `s` are ordered by ascending `u` first: the
    order of `jnp.lexsort((u, -s))`. That order comes from one stable sort
    of a composite key, -s in the high 32 bits and u in the low 32."""
    if u is None:
        return torch.sort(-s, dim=1, stable=True).indices
    key = _float_order_key(-s) * (1 << 32) + _float_order_key(u) + (1 << 31)
    return torch.sort(key, dim=1, stable=True).indices


def eval_auc_judd(y_pred, y_true, generator: Optional[torch.Generator] = None):
    """Batched AUC-Judd. NaN for frames with no fixations or an all-zero
    saliency map.

    `generator` breaks ties uniformly at random, the limit of the
    reference's `+ rand()*1e-7` jitter (which f32 would swallow on
    0..255-scale maps): the descending sort takes a uniform draw as its
    secondary key, so tied pixels are ordered uniformly at random."""
    n, h, w, _ = y_pred.shape
    s = y_pred.reshape(n, h * w)
    f = (y_true[..., 1] > 0.5).reshape(n, h * w)

    smin = s.amin(dim=1, keepdim=True)
    smax = s.amax(dim=1, keepdim=True)
    s = (s - smin) / (smax - smin + EPS)

    u = None
    if generator is not None:
        u = torch.rand(s.shape, generator=generator, device=s.device)
    f_sorted = torch.gather(f, 1, descending_order(s, u))

    n_fix = f.sum(dim=1)
    n_non = h * w - n_fix

    # fixations ranked at or above each position; at non-fix positions this
    # equals the count strictly above (the position itself is no fixation)
    cfix = torch.cumsum(f_sorted.float(), dim=1)
    w_seg = torch.clamp((2.0 * cfix + 1.0) / (2.0 * n_fix.clamp(min=1)[:, None]), max=1.0)
    auc = torch.where(f_sorted, 0.0, w_seg).sum(dim=1) / n_non.clamp(min=1)

    valid = (n_fix > 0) & (y_pred.reshape(n, -1).amax(dim=1) > 0)
    return torch.where(valid, auc, torch.nan)


def eval_auc_sweep(y_pred, y_true, neg_idx, n_valid, step_size: float = 0.1):
    """Batched AUC-Borji / shuffled AUC as a threshold sweep.

    The host samples only the negative pixel indices; the sweep runs over
    the fixed grid arange(0, 1, step), area-equivalent to the reference's
    arange(0, upper, step): thresholds above `upper` count no positives and
    no negatives, (0, 0) points the trapezoid rule ignores. Positives are
    counted on the whole frame under the fixation mask; negative rows
    >= n_valid[i] are masked out.

    y_pred (N,H,W,1); y_true (N,H,W,2) (channel 1 = fixation points);
    neg_idx (N, NF, R) integer flat pixel indices (R = random splits);
    n_valid (N,) valid rows per frame: n_fix for Borji,
    min(n_fix, #shufmap fixations) for shuffled (also the fp denominator,
    as in the reference). Returns (N,) mean AUC over the R splits, NaN for
    degenerate frames.
    """
    n, h, w, _ = y_pred.shape
    p = h * w
    s_raw = y_pred.float().reshape(n, p)
    f = (y_true[..., 1].float() > 0.5).reshape(n, p)

    smin = s_raw.amin(dim=1, keepdim=True)
    smax = s_raw.amax(dim=1, keepdim=True)
    sn = (s_raw - smin) / (smax - smin + EPS)

    n_fix = f.sum(dim=1)
    nf, r = neg_idx.shape[1], neg_idx.shape[2]
    row_ok = torch.arange(nf, device=sn.device)[None, :, None] < n_valid[:, None, None]
    neg = torch.gather(sn, 1, neg_idx.reshape(n, nf * r).long()).reshape(n, nf, r)

    # a descending grid of thresholds, each rounded to f32 first, as JAX
    # rounds a Python float compared with an f32 array: 0.7 and 0.1 * 7
    # differ in f64 and a value between them would count otherwise
    nt = int(math.ceil(1.0 / step_size))
    thresholds = [float(torch.tensor(step_size * t, dtype=torch.float32))
                  for t in range(nt - 1, -1, -1)]
    denom_fix = n_fix.clamp(min=1).float()
    denom_neg = n_valid.clamp(min=1).float()
    tp = torch.stack([((sn >= t) & f).sum(dim=1) / denom_fix for t in thresholds], dim=1)
    fp = torch.stack([((neg >= t) & row_ok).sum(dim=1) / denom_neg[:, None]
                      for t in thresholds], dim=1)  # (N, T, R)
    tp = tp[:, :, None].expand(n, nt, r)

    zeros = torch.zeros((n, 1, r), device=sn.device)
    ones = torch.ones((n, 1, r), device=sn.device)
    tp = torch.cat([zeros, tp, ones], dim=1)
    fp = torch.cat([zeros, fp, ones], dim=1)
    auc = torch.trapezoid(tp, fp, dim=1).mean(dim=1)

    # as the host rule, which checks np.any(s > 0) after norm01: a constant
    # frame (max == min) normalizes to zeros and is NaN
    valid = (n_fix > 0) & (smax[:, 0] > smin[:, 0]) & (n_valid > 0)
    return torch.where(valid, auc, torch.nan)


METRICS_TORCH = {
    "KLD": eval_kl,
    "CC": eval_cc,
    "NSS": eval_nss,
    "SIM": eval_sim,
    "AUC_Judd": eval_auc_judd,
}
