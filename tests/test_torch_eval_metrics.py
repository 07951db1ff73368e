"""The port's saliency metrics against the JAX package's on the CPU, at
small shapes (36x48 to 64x128, a few frames), on the same numpy inputs.

Tolerances:
- `metrics_np` is a copy: bit for bit, from the same `RandomState`, and the
  `RandomState` left in the same state.
- KLD, CC, NSS, SIM and the unjittered AUC-Judd on continuous (untied)
  inputs: within 1e-6 relative to the largest value of the JAX package's,
  and KLD, CC, NSS and SIM within 1e-6 of their f64 values (`metrics_np`).
  KLD and CC are held 4e-6 to the JAX package's: its own f32 KLD and CC
  lie farther than 1e-6 from f64 at these shapes (within 3e-6, which the
  test holds), so the two packages are 1e-6 + 3e-6 apart at most.
- The unjittered AUC-Judd on tied uint8 inputs: equal within 1e-6 (both
  sorts are stable, so ties fall in the same order).
- The jittered AUC-Judd: a Monte-Carlo draw of the tie order, held in
  distribution to `auc_judd_np`'s 1e-7 jitter over 24 seeds, as the JAX
  package's test holds its own (tests/test_losses_metrics.py).
- The composite sort key orders as the two stable sorts of a lexsort, index
  for index.
- `eval_auc_sweep` on the same negative indices and valid counts: within
  1e-6 of the JAX package's, with its NaN rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.evaluation import metrics_jax as mj
from iip_uavsal_saliency_tpu.evaluation import metrics_np as jnp_metrics
from iip_uavsal_saliency_tpu_torch.evaluation import metrics_np as tnp_metrics
from iip_uavsal_saliency_tpu_torch.evaluation import metrics_torch as mt
from test_torch_train_step import few_threads  # noqa: F401


def blob_frames(seed, n, h, w, quantize=False):
    """(pred (n, h, w, 1), true (n, h, w, 2)) f32: a smooth blob plus noise
    as saliency, ~40 fixations around the blob's centre, and a blurred
    fixation map; `quantize` makes the saliency 8-level uint8 values."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    preds, trues = [], []
    for _ in range(n):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        blob = np.exp(-(((yy - cy) / (0.2 * h)) ** 2 + ((xx - cx) / (0.2 * w)) ** 2))
        pred = blob + 0.3 * rng.rand(h, w)
        if quantize:
            pred = np.floor(pred / pred.max() * 7.999) * 32.0
        pts = np.zeros((h, w))
        pts[np.clip(rng.normal(cy, 0.15 * h, 40).astype(int), 0, h - 1),
            np.clip(rng.normal(cx, 0.15 * w, 40).astype(int), 0, w - 1)] = 1
        fmap = (np.exp(-(((yy - cy) / (0.15 * h)) ** 2 + ((xx - cx) / (0.15 * w)) ** 2))
                + 0.05 * rng.rand(h, w))
        preds.append(pred)
        trues.append(np.stack([fmap, pts], -1))
    return np.stack(preds)[..., None].astype(np.float32), np.stack(trues).astype(np.float32)


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def _port(fn, *arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


NP_CASES = {
    "kld_np": lambda m, s, fm, fp, oth, rng: m.kld_np(s, fm),
    "cc_np": lambda m, s, fm, fp, oth, rng: m.cc_np(s, fm),
    "nss_np": lambda m, s, fm, fp, oth, rng: m.nss_np(s, fp),
    "sim_np": lambda m, s, fm, fp, oth, rng: m.sim_np(s, fm),
    "auc_judd_np": lambda m, s, fm, fp, oth, rng: m.auc_judd_np(s, fp, rng=rng),
    "auc_borji_np": lambda m, s, fm, fp, oth, rng: m.auc_borji_np(s, fp, rng=rng),
    "auc_shuffled_np": lambda m, s, fm, fp, oth, rng: m.auc_shuffled_np(s, fp, oth, rng=rng),
}


@pytest.mark.parametrize("name", list(NP_CASES))
def test_metrics_np_is_the_jax_copy(name):
    pred, true = blob_frames(0, 1, 36, 48, quantize=True)
    oth = (np.random.RandomState(9).rand(36, 48) > 0.9).astype(np.uint8)
    args = (pred[0, ..., 0], true[0, ..., 0], true[0, ..., 1], oth)
    rngs = np.random.RandomState(4), np.random.RandomState(4)
    want = NP_CASES[name](jnp_metrics, *args, rngs[0])
    got = NP_CASES[name](tnp_metrics, *args, rngs[1])
    assert got == want  # bit for bit
    state_a, state_b = rngs[0].get_state(), rngs[1].get_state()
    assert all(np.array_equal(a, b) for a, b in zip(state_a, state_b))
    assert {k: v[1] for k, v in tnp_metrics.METRICS_NP.items()} == \
        {k: v[1] for k, v in jnp_metrics.METRICS_NP.items()}


F64 = {"eval_kl": (tnp_metrics.kld_np, 0), "eval_cc": (tnp_metrics.cc_np, 0),
       "eval_nss": (tnp_metrics.nss_np, 1), "eval_sim": (tnp_metrics.sim_np, 0)}
TOL_VS_JAX = {"eval_kl": 4e-6, "eval_cc": 4e-6, "eval_nss": 1e-6, "eval_sim": 1e-6,
              "eval_auc_judd": 1e-6}


@pytest.mark.parametrize("name", list(TOL_VS_JAX))
def test_device_metrics_match_jax_on_continuous_inputs(name):
    for seed, shape in enumerate([(4, 36, 48), (3, 45, 80), (4, 64, 128)]):
        pred, true = blob_frames(seed, *shape)
        want = _jax(getattr(mj, name), pred, true)
        got = _port(getattr(mt, name), pred, true)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_VS_JAX[name] * scale,
                                   err_msg=f"{name} at {shape}")
        if name in F64:
            fn, ch = F64[name]
            exact = np.array([fn(pred[i, ..., 0], true[i, ..., ch]) for i in range(len(pred))])
            top = np.abs(exact).max()
            np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6 * top,
                                       err_msg=f"{name} at {shape} against f64")
            np.testing.assert_allclose(want, exact, rtol=0, atol=3e-6 * top,
                                       err_msg=f"the JAX package's {name} at {shape} against f64")


def test_auc_judd_unjittered_on_tied_uint8_equals_jax():
    pred, true = blob_frames(3, 4, 45, 80, quantize=True)
    assert len(np.unique(pred[0])) <= 8  # heavily tied
    want = _jax(mj.eval_auc_judd, pred, true)
    got = _port(mt.eval_auc_judd, pred, true)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_auc_judd_jitter_moves_only_ties():
    """On untied inputs the tie-breaking draw changes nothing."""
    pred, true = blob_frames(5, 3, 36, 48)
    plain = _port(mt.eval_auc_judd, pred, true)
    jittered = _port(mt.eval_auc_judd, pred, true, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(jittered, plain)


def test_auc_judd_jittered_on_tied_uint8_matches_numpy_in_distribution():
    """The port's random tie order against `auc_judd_np`'s 1e-7 jitter in f64
    on an 8-level map: independent Monte-Carlo draws of the same tie order,
    so their means over seeds agree within noise (the JAX package's test of
    its own, tests/test_losses_metrics.py)."""
    rng = np.random.RandomState(11)
    h, w = 45, 80
    yy, xx = np.mgrid[0:h, 0:w]
    g = np.exp(-(((yy - 22) / 12.0) ** 2 + ((xx - 40) / 20.0) ** 2))
    sal = (np.floor(g * 8) / 8 * 255).astype(np.uint8).astype(np.float32)
    fpts = np.zeros((h, w), np.float32)
    fpts[rng.randint(5, 40, 30), rng.randint(5, 75, 30)] = 1.0
    pred = sal[None, :, :, None]
    true = np.stack([sal / 255.0, fpts], -1)[None]

    n_seeds = 24
    dev = np.array([_port(mt.eval_auc_judd, pred, true,
                          generator=torch.Generator().manual_seed(s))[0]
                    for s in range(n_seeds)])
    ref = np.array([tnp_metrics.auc_judd_np(sal, fpts, jitter=True,
                                            rng=np.random.RandomState(100 + s))
                    for s in range(n_seeds)])
    assert dev.std() > 0, "the jitter had no effect"
    np.testing.assert_allclose(dev.mean(), ref.mean(),
                               atol=3 * ref.std() / np.sqrt(n_seeds) + 1e-3)


@pytest.mark.parametrize("u_levels", [None, 3], ids=["u_continuous", "u_tied"])
def test_composite_key_sort_equals_two_sort_lexsort(u_levels):
    """`descending_order(s, u)` (one sort of a composite int64 key) against
    two stable sorts, by u and then by -s, and against `jnp.lexsort((u, -s))`,
    on heavily tied s (with zeros, whose negation is -0.0) and u."""
    rng = np.random.RandomState(2)
    s = np.floor(rng.rand(6, 500) * 5).astype(np.float32) / 4.0
    u = rng.rand(6, 500).astype(np.float32)
    if u_levels:
        u = np.floor(u * u_levels).astype(np.float32) / u_levels
    st, ut = torch.from_numpy(s), torch.from_numpy(u)
    got = mt.descending_order(st, ut)
    by_u = torch.sort(ut, dim=1, stable=True).indices
    then_s = torch.sort(torch.gather(-st, 1, by_u), dim=1, stable=True).indices
    two_sorts = torch.gather(by_u, 1, then_s)
    assert torch.equal(got, two_sorts)
    lex = np.asarray(jnp.lexsort((jnp.asarray(u), -jnp.asarray(s)), axis=-1))
    np.testing.assert_array_equal(got.numpy(), lex)


def _sweep_case(seed, b=4, h=36, w=48, nf=64, r=7):
    rng = np.random.RandomState(seed)
    s = rng.rand(b, h, w).astype(np.float32)
    f = (rng.rand(b, h, w) > 0.95).astype(np.float32)
    n_valid = np.array([int((f[i] > 0.5).sum()) for i in range(b)], np.int32)
    neg = rng.randint(0, h * w, (b, nf, r)).astype(np.int32)
    return s, f, neg, n_valid


def _sweep_both(s, f, neg, nv):
    pred, true = s[..., None], np.stack([f, f], -1)
    want = np.asarray(mj.eval_auc_sweep(jnp.asarray(pred), jnp.asarray(true),
                                        jnp.asarray(neg), jnp.asarray(nv)))
    got = mt.eval_auc_sweep(torch.from_numpy(pred), torch.from_numpy(true),
                            torch.from_numpy(neg), torch.from_numpy(nv)).numpy()
    return got, want


def test_auc_sweep_matches_jax():
    s, f, neg, nv = _sweep_case(0)
    got, want = _sweep_both(s, f, neg, nv)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_auc_sweep_nan_rules_match_jax():
    """All-zero saliency, no fixations, a constant frame and no valid
    negative rows are NaN in both; the other frame is finite and equal."""
    s, f, neg, nv = _sweep_case(1, b=5)
    s[1] = 0.0
    f[2] = 0.0
    nv[2] = 0
    s[3] = 128.0
    nv[4] = 0
    got, want = _sweep_both(s, f, neg, nv)
    np.testing.assert_array_equal(np.isnan(got), [False, True, True, True, True])
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_auc_sweep_counts_values_on_the_thresholds_as_jax():
    """Saliency values that lie on a threshold in f32 (0.1 * t rounded to
    f32, and its neighbours) count as the JAX package counts them."""
    rng = np.random.RandomState(3)
    grid = np.float32([0.1 * t for t in range(10)])
    vals = np.concatenate([grid, np.nextafter(grid, 1, dtype=np.float32),
                           np.nextafter(grid, 0, dtype=np.float32), [0.0, 1.0]])
    s = rng.choice(vals, (3, 24, 32)).astype(np.float32)
    s[:, 0, 0], s[:, 0, 1] = 0.0, 1.0  # the frame's min and max: norm01 is the identity
    f = (rng.rand(3, 24, 32) > 0.8).astype(np.float32)
    nv = np.array([int(f[i].sum()) for i in range(3)], np.int32)
    neg = rng.randint(0, 24 * 32, (3, 256, 5)).astype(np.int32)
    got, want = _sweep_both(s, f, neg, nv)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_auc_sweep_matches_numpy_borji_on_the_same_samples():
    """The fixed threshold grid is area-equivalent to `_sweep_auc`'s
    data-dependent one, given the same negative samples."""
    rng = np.random.RandomState(0)
    b, h, w, r, nf = 3, 24, 32, 7, 64
    s = rng.rand(b, h, w).astype(np.float32)
    f = (rng.rand(b, h, w) > 0.93).astype(np.float32)
    neg = np.zeros((b, nf, r), np.int32)
    nv = np.zeros(b, np.int32)
    want = []
    for i in range(b):
        sn = tnp_metrics._norm01(s[i]).ravel()
        fix = f[i].ravel() > 0.5
        n_fix = int(fix.sum())
        draw = rng.randint(0, sn.size, (n_fix, r))
        neg[i, :n_fix] = draw
        nv[i] = n_fix
        want.append(tnp_metrics._sweep_auc(sn[fix], sn[draw], n_fix, n_fix))
    got = mt.eval_auc_sweep(torch.from_numpy(s[..., None]),
                            torch.from_numpy(np.stack([f, f], -1)),
                            torch.from_numpy(neg), torch.from_numpy(nv)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_metric_tables_match():
    assert mt.KEYS_ORDER == mj.KEYS_ORDER
    assert set(mt.METRICS_TORCH) == set(mj.METRICS_JAX)
    assert mt.EPS == mj.EPS
