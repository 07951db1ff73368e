"""Host-side (NumPy) saliency metrics — single-frame reference formulas
(own copy of `iip_uavsal_saliency_tpu/evaluation/metrics_np.py`, unchanged:
the same `RandomState` gives the same numbers bit for bit).

Re-statements of the reference's NumPy/torch metric definitions
(reference: utils_score.py:42-203, utils_score_torch.py:53-177). The
inherently data-dependent AUC variants (Borji / shuffled: random negative
sampling, value-dependent threshold grids) live here on the host; the
threshold counting is vectorized via `searchsorted` instead of the
reference's nested Python loops (utils_score_torch.py:107-118) — same
definition (100 random splits, 0.1 threshold steps), far fewer passes.

All functions take 2-D maps: `s` = saliency, `fmap` = blurred fixation map,
`fpts` = binary fixation points.
"""

from __future__ import annotations

import numpy as np

EPS = 2.2204e-16


def _norm01(x):
    x = x.astype(np.float64)
    return (x - x.min()) / (x.max() - x.min() + EPS)


def kld_np(s, fmap):
    t = fmap.astype(np.float64)
    p = s.astype(np.float64)
    t = t / (t.sum() + EPS)
    p = p / (p.sum() + EPS)
    return float(np.sum(t * np.log(t / (p + EPS) + EPS)))


def cc_np(s, fmap):
    t = fmap.astype(np.float64)
    p = s.astype(np.float64)
    t = (t - t.mean()) / (t.std(ddof=1) + EPS)
    p = (p - p.mean()) / (p.std(ddof=1) + EPS)
    t = t - t.mean()
    p = p - p.mean()
    r1 = np.sum(t * p)
    r2 = np.sqrt(np.sum(p * p) * np.sum(t * t))
    return float(r1 / (r2 + EPS))


def nss_np(s, fpts):
    f = fpts.astype(np.float64)
    p = s.astype(np.float64)
    p = (p - p.mean()) / (p.std(ddof=1) + EPS)
    return float(np.sum(f * p) / (f.sum() + EPS))


def sim_np(s, fmap):
    t = _norm01(fmap)
    p = _norm01(s)
    t = t / (t.sum() + EPS)
    p = p / (p.sum() + EPS)
    return float(np.minimum(t, p).sum())


def auc_judd_np(s, fpts, jitter: bool = True, rng: np.random.RandomState | None = None):
    """Exact reference threshold-sweep algorithm (utils_score_torch.py:53-88),
    with the per-threshold count replaced by a sort + searchsorted."""
    s = s.astype(np.float64).ravel()
    f = fpts.ravel() > 0.5
    if not np.any(s > 0) or not np.any(f):
        return float("nan")
    if jitter:
        rng = rng or np.random
        s = s + rng.rand(*s.shape) * 1e-7
    s = (s - s.min()) / (s.max() - s.min() + EPS)

    s_fix = s[f]
    n_fix = s_fix.size
    n_pix = s.size

    thresholds = np.sort(s_fix)[::-1]
    tp = np.zeros(n_fix + 2)
    fp = np.zeros(n_fix + 2)
    tp[-1] = 1.0
    fp[-1] = 1.0
    tp[1:-1] = (np.arange(n_fix) + 1) / float(n_fix)
    s_sorted = np.sort(s)
    above_th = n_pix - np.searchsorted(s_sorted, thresholds, side="left")
    fp[1:-1] = (above_th - np.arange(n_fix) - 1) / float(n_pix - n_fix)
    return float(np.trapezoid(tp, fp))


def _sweep_auc(s_fix, s_rand_cols, n_fix, n_fix_oth, step_size=0.1):
    """Shared Borji/shuffled threshold sweep over random splits.

    s_rand_cols: (n_samples, n_rep) negative-sample values.
    """
    n_rep = s_rand_cols.shape[1]
    aucs = np.empty(n_rep)
    fix_sorted = np.sort(s_fix)
    for rep in range(n_rep):
        col = s_rand_cols[:, rep]
        upper = max(s_fix.max(), col.max() if col.size else 0.0)
        thresholds = np.arange(0, upper, step_size)[::-1]
        nt = thresholds.size
        tp = np.zeros(nt + 2)
        fp = np.zeros(nt + 2)
        tp[-1] = 1.0
        fp[-1] = 1.0
        col_sorted = np.sort(col)
        tp[1:-1] = (n_fix - np.searchsorted(fix_sorted, thresholds, side="left")) / float(n_fix)
        fp[1:-1] = (col.size - np.searchsorted(col_sorted, thresholds, side="left")) / float(
            n_fix_oth
        )
        aucs[rep] = np.trapezoid(tp, fp)
    return float(np.mean(aucs))


def auc_borji_np(s, fpts, n_rep: int = 100, step_size: float = 0.1, rng=None):
    """AUC-Borji: negatives uniformly sampled over all pixels
    (reference: utils_score_torch.py:91-119)."""
    s = _norm01(s.astype(np.float64)).ravel()
    f = fpts.ravel() > 0.5
    if not np.any(s > 0) or not np.any(f):
        return float("nan")
    rng = rng or np.random
    s_fix = s[f]
    n_fix = s_fix.size
    r = rng.randint(0, s.size, (n_fix, n_rep))
    return _sweep_auc(s_fix, s[r], n_fix, n_fix, step_size)


def auc_shuffled_np(s, fpts, oth_map, n_rep: int = 100, step_size: float = 0.1, rng=None):
    """Shuffled AUC: negatives sampled from other-video fixation locations
    (reference: utils_score_torch.py:134-164)."""
    s = _norm01(s.astype(np.float64)).ravel()
    f = fpts.ravel() > 0.5
    if not np.any(s > 0) or not np.any(f):
        return float("nan")
    rng = rng or np.random
    s_fix = s[f]
    n_fix = s_fix.size
    ind = np.nonzero(oth_map.ravel())[0]
    n_ind = ind.size
    if n_ind == 0:
        return float("nan")
    n_fix_oth = min(n_fix, n_ind)
    # draw-then-slice looks wasteful but is the reference's exact RNG
    # consumption (utils_score.py AUC_shuffled: randint([n_ind, n_rep])
    # sliced to n_fix_oth) — seeded golden parity requires matching it;
    # the fast path is the device sweep in metrics_torch, not this one
    r = rng.randint(0, n_ind, (n_ind, n_rep))[:n_fix_oth, :]
    return _sweep_auc(s_fix, s[ind[r]], n_fix, n_fix_oth, step_size)


# metric name -> (fn, ground-truth kind): 'map' uses fixation maps,
# 'pts' uses binary points, 'shuf' additionally needs the shuffle map.
METRICS_NP = {
    "AUC_shuffled": (auc_shuffled_np, "shuf"),
    "NSS": (nss_np, "pts"),
    "AUC_Judd": (auc_judd_np, "pts"),
    "AUC_Borji": (auc_borji_np, "pts"),
    "KLD": (kld_np, "map"),
    "SIM": (sim_np, "map"),
    "CC": (cc_np, "map"),
}
