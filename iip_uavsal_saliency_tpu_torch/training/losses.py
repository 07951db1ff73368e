"""Training losses: the 10*KLD - 2*CC - NSS composite and its variants (own
copy of `iip_uavsal_saliency_tpu/training/losses.py`).

Layout as in the JAX package: predictions (N, H, W, 1), targets (N, H, W, 2)
with channel 0 the blurred fixation map and channel 1 the binary fixation
points. Every metric is computed per frame and then meaned over the batch;
the std is the unbiased (N-1) one, as `torch.std` gives.
"""

from __future__ import annotations

import torch

EPS = 2.2204e-16


def _sum_hw(x):
    return x.sum(dim=(1, 2), keepdim=True)


def _mean_hw(x):
    return x.mean(dim=(1, 2), keepdim=True)


def _std_hw(x):
    n = x.shape[1] * x.shape[2]
    var = ((x - _mean_hw(x)) ** 2).sum(dim=(1, 2), keepdim=True) / (n - 1)
    return torch.sqrt(var)


def _max_hw(x):
    return x.amax(dim=(1, 2), keepdim=True)


def _min_hw(x):
    return x.amin(dim=(1, 2), keepdim=True)


def metric_kl(y_pred, y_true):
    """Per-frame KL divergence."""
    t = y_true[..., 0:1]
    t = t / (_sum_hw(t) + EPS)
    p = y_pred / (_sum_hw(y_pred) + EPS)
    return (t * torch.log(t / (p + EPS) + EPS)).sum(dim=(1, 2))[..., 0]


def metric_cc(y_pred, y_true):
    """Per-frame linear correlation."""
    t = y_true[..., 0:1]
    t = (t - _mean_hw(t)) / (_std_hw(t) + EPS)
    p = (y_pred - _mean_hw(y_pred)) / (_std_hw(y_pred) + EPS)
    t = t - _mean_hw(t)
    p = p - _mean_hw(p)
    r1 = (t * p).sum(dim=(1, 2))
    r2 = torch.sqrt((p * p).sum(dim=(1, 2)) * (t * t).sum(dim=(1, 2)))
    return (r1 / (r2 + EPS))[..., 0]


def metric_nss(y_pred, y_true):
    """Per-frame NSS."""
    f = y_true[..., 1:2]
    p = (y_pred - _mean_hw(y_pred)) / (_std_hw(y_pred) + EPS)
    return ((f * p).sum(dim=(1, 2)) / (f.sum(dim=(1, 2)) + EPS))[..., 0]


def metric_sim(y_pred, y_true):
    """Per-frame histogram similarity."""
    t = y_true[..., 0:1]
    t = (t - _min_hw(t)) / (_max_hw(t) - _min_hw(t) + EPS)
    p = (y_pred - _min_hw(y_pred)) / (_max_hw(y_pred) - _min_hw(y_pred) + EPS)
    t = t / (_sum_hw(t) + EPS)
    p = p / (_sum_hw(p) + EPS)
    return torch.minimum(t, p).sum(dim=(1, 2))[..., 0]


def per_frame_fu(y_pred, y_true):
    return (10.0 * metric_kl(y_pred, y_true) - 2.0 * metric_cc(y_pred, y_true)
            - metric_nss(y_pred, y_true))


def per_frame_kl(y_pred, y_true):
    return 10.0 * metric_kl(y_pred, y_true)


def per_frame_ml(y_pred, y_true):
    t = y_true[..., 0:1]
    p = y_pred / (_max_hw(y_pred) + EPS)
    return ((p - t) * (p - t) / (1.0 - t + 0.1)).mean(dim=(1, 2, 3))


def loss_fu(y_pred, y_true):
    """Composite 10*KLD - 2*CC - NSS."""
    return per_frame_fu(y_pred, y_true).mean()


def loss_fu_dy(y_pred, y_true):
    """`loss_fu` on 5-D (V, S, H, W, C) clips, video and frame axes flattened."""
    v, s = y_pred.shape[0], y_pred.shape[1]
    return loss_fu(y_pred.reshape(v * s, *y_pred.shape[2:]),
                   y_true.reshape(v * s, *y_true.shape[2:]))


def loss_kl(y_pred, y_true):
    """10*KLD."""
    return per_frame_kl(y_pred, y_true).mean()


def loss_ml(y_pred, y_true):
    """Max-normalized weighted MSE."""
    return per_frame_ml(y_pred, y_true).mean()


# Per-frame forms, (N, H, W, C) -> (N,): loss(pred, true) is the mean of its
# per-frame form, so a trainer can weight frames (padding masks) and reduce
# to the same scalar on full clips. Trainers flatten (V, S) before the loss,
# so loss_fu_dy's per-frame form is per_frame_fu.
PER_FRAME = {
    loss_fu: per_frame_fu,
    loss_fu_dy: per_frame_fu,
    loss_kl: per_frame_kl,
    loss_ml: per_frame_ml,
}

LOSSES = {"fu": loss_fu, "fu_dy": loss_fu_dy, "kl": loss_kl, "ml": loss_ml}
