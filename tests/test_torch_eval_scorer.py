"""The port's evaluation drivers against the JAX package's on the CPU, at
small shapes (36x48 and 32x40, a few frames), from the same `RandomState`
seed.

Every draw of negative samples comes from that `RandomState` in both
packages, in the same order, so the two leave it in the same state and
agree on KLD, CC, NSS, SIM, AUC-Borji and AUC-shuffled within 1e-5. AUC-Judd
breaks ties with a draw of each package's own generator (a JAX key, a
`torch.Generator`), so on tied maps it agrees within the most a tie order
can move it: a group of equal saliency values holding k fixations and m
other pixels moves AUC-Judd by at most k*m / (n_fix * n_nonfix)
(`judd_tie_bound`), plus 1e-6 of f32 rounding. Degenerate frames are NaN
rows in both.
"""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
import scipy.io
import torch

from iip_uavsal_saliency_tpu.evaluation import scorer as js
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.data.matio import loadmat, savemat
from iip_uavsal_saliency_tpu_torch.evaluation import scorer as ts
from test_torch_train_step import few_threads  # noqa: F401

TOL = 1e-5
KEYS = js.KEYS_ORDER
JUDD = KEYS.index("AUC_Judd")
H, W = 36, 48


def judd_tie_bound(sal, pts):
    """Per frame, the most AUC-Judd can move between two orders of its tied
    pixels (module docstring), over (T, H, W) saliency and points."""
    out = []
    for s, p in zip(sal, pts):
        fix = p.ravel() > 0.5
        _, group = np.unique(s.ravel(), return_inverse=True)
        k = np.bincount(group, weights=fix)
        m = np.bincount(group, weights=~fix)
        n = fix.sum()
        out.append((k * m).sum() / (max(n, 1) * max(fix.size - n, 1)))
    return np.asarray(out)


def assert_scores_match(got, want, bound, what=""):
    """Six columns within TOL, AUC-Judd within `bound` (per row) + 1e-6, NaN
    rows in the same places."""
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want[:, 0])
    other = [k for k in range(len(KEYS)) if k != JUDD]
    np.testing.assert_allclose(got[ok][:, other], want[ok][:, other], rtol=0, atol=TOL,
                               err_msg=what)
    judd_err = np.abs(got[ok, JUDD] - want[ok, JUDD])
    assert (judd_err <= np.asarray(bound)[ok] + 1e-6).all(), (what, judd_err, bound)


def assert_same_rng(a, b):
    assert all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


def video(seed, t, h=H, w=W, sal_hw=None, gt_dtype=np.uint8, empty_frame=None, levels=16):
    """(salmap, fixmap, fixpts) in the .mat layout (H, W, 1, T): a blob
    moving over noise, quantized to `levels` uint8 values (ties); ~25
    fixations around it per frame and their blurred map. `sal_hw` gives the
    saliency another size than the ground truth."""
    rng = np.random.RandomState(seed)
    sh, sw = sal_hw or (h, w)
    sal = np.zeros((sh, sw, 1, t), np.uint8)
    fmap = np.zeros((h, w, 1, t))
    fpts = np.zeros((h, w, 1, t))
    yy, xx = np.mgrid[0:sh, 0:sw]
    gy, gx = np.mgrid[0:h, 0:w]
    for i in range(t):
        cy, cx = 0.5 + 0.2 * np.sin(i / 3.0), 0.5 + 0.2 * np.cos(i / 4.0)
        blob = np.exp(-(((yy / sh - cy) / 0.2) ** 2 + ((xx / sw - cx) / 0.25) ** 2))
        blob = blob + 0.3 * rng.rand(sh, sw)
        sal[:, :, 0, i] = (np.floor(blob / blob.max() * (levels - 0.001)) * (255 // levels))
        if i == empty_frame:
            continue
        ys = np.clip(rng.normal(cy * h, 0.12 * h, 25).astype(int), 0, h - 1)
        xs = np.clip(rng.normal(cx * w, 0.12 * w, 25).astype(int), 0, w - 1)
        fpts[ys, xs, 0, i] = 1
        fmap[:, :, 0, i] = np.exp(-(((gy / h - cy) / 0.15) ** 2 + ((gx / w - cx) / 0.15) ** 2))
    if gt_dtype == np.uint8:
        fmap = np.round(fmap * 255)
    return sal, fmap.astype(gt_dtype), fpts.astype(gt_dtype)


def pool(seed, n=30):
    rng = np.random.RandomState(seed)
    return [np.stack([rng.rand(20), rng.rand(20)], 1) for _ in range(n)]


@pytest.mark.parametrize("device_auc", [True, False], ids=["device_auc", "host_auc"])
@pytest.mark.parametrize("case", ["uint8", "f64_resized_degenerate"])
def test_score_video_matches_jax(device_auc, case):
    """7 frames in batches of 4 (the last batch padded), one video with
    uint8 ground truth, one with f64 ground truth, saliency of another size
    (the cv2 resize) and a frame without fixations (a NaN row)."""
    if case == "uint8":
        sal, fmap, fpts = video(0, 7)
    else:
        sal, fmap, fpts = video(1, 7, sal_hw=(30, 40), gt_dtype=np.float64, empty_frame=2)
    fix_pool = pool(3)
    rngs = np.random.RandomState(11), np.random.RandomState(11)
    want = js._score_video(sal, fmap, fpts, fix_pool, KEYS, 4, rngs[0], device_auc=device_auc)
    got = ts._score_video(sal, fmap, fpts, fix_pool, KEYS, 4, rngs[1], device_auc=device_auc,
                          device="cpu")
    assert_same_rng(*rngs)
    prepped = ts._prep_video(sal, fmap, fpts)
    assert_scores_match(got, want, judd_tie_bound(prepped[0], prepped[2]), case)
    assert np.isnan(got).any() == (case != "uint8")
    assert np.isfinite(got[~np.isnan(got[:, 0])]).all()


def test_score_video_fixed_shufmap_and_key_subset_match_jax():
    sal, fmap, fpts = video(4, 5)
    shufmap = (np.random.RandomState(5).rand(H, W) > 0.9).astype(np.float64)
    keys = ["AUC_shuffled", "CC", "AUC_Borji"]
    rngs = np.random.RandomState(2), np.random.RandomState(2)
    want = js._score_video(sal, fmap, fpts, [], keys, 3, rngs[0], fixed_shufmap=shufmap)
    got = ts._score_video(sal, fmap, fpts, [], keys, 3, rngs[1], fixed_shufmap=shufmap,
                          device="cpu")
    assert_same_rng(*rngs)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_score_video_zero_frames_is_one_nan_row():
    sal = np.zeros((8, 8, 1, 0), np.uint8)
    gt = np.zeros((8, 8, 1, 5), np.uint8)
    out = ts._score_video(sal, gt, gt, [], KEYS, 4, np.random.RandomState(0), device="cpu")
    want = js._score_video(sal, gt, gt, [], KEYS, 4, np.random.RandomState(0))
    assert out.shape == want.shape == (1, len(KEYS))
    assert np.isnan(out).all() and np.isnan(want).all()


def test_device_auc_close_to_host_auc():
    """Both paths of the port draw other samples: their AUC-Borji and
    AUC-shuffled means agree within Monte-Carlo noise (the JAX package's
    bound for its own, tests/test_losses_metrics.py)."""
    sal, fmap, fpts = video(6, 8, levels=64)
    keys = ["AUC_Borji", "AUC_shuffled"]
    dev = ts._score_video(sal, fmap, fpts, pool(7), keys, 4, np.random.RandomState(1),
                          device="cpu")
    host = ts._score_video(sal, fmap, fpts, pool(7), keys, 4, np.random.RandomState(1),
                           device_auc=False, device="cpu")
    np.testing.assert_allclose(dev.mean(0), host.mean(0), atol=0.05)


# a synthetic dataset in the reference layout: <root>/maps/<v>_fixMaps.mat,
# <root>/fixations/maps/<v>_fixPts.mat, <res>/Saliency/<m>/<v>.mat
VIDEOS = {
    "v1": dict(seed=10, t=7),
    "v2": dict(seed=11, t=5, sal_hw=(30, 40), gt_dtype=np.float64, empty_frame=2),
    "v3": dict(seed=12, t=6),
}
EMPTY = "v4"  # a video shorter than time_dims: an empty salmap


def write_dataset(root, res, method="M"):
    os.makedirs(os.path.join(root, "maps"))
    os.makedirs(os.path.join(root, "fixations", "maps"))
    sal_dir = os.path.join(res, "Saliency", method)
    os.makedirs(sal_dir)
    prepped = {}
    for name, kw in VIDEOS.items():
        sal, fmap, fpts = video(**kw)
        savemat(os.path.join(root, "maps", f"{name}_fixMaps.mat"), {"fixMap": fmap})
        savemat(os.path.join(root, "fixations", "maps", f"{name}_fixPts.mat"), {"fixLoc": fpts})
        savemat(os.path.join(sal_dir, f"{name}.mat"), {"salmap": sal})
        prepped[name] = ts._prep_video(sal, fmap, fpts)
    _, fmap, fpts = video(13, 3)
    savemat(os.path.join(root, "maps", f"{EMPTY}_fixMaps.mat"), {"fixMap": fmap})
    savemat(os.path.join(root, "fixations", "maps", f"{EMPTY}_fixPts.mat"), {"fixLoc": fpts})
    savemat(os.path.join(sal_dir, f"{EMPTY}.mat"), {"salmap": np.zeros((H, W, 1, 0), np.uint8)})
    return prepped


def read_scores(score_dir):
    return {f[6:-4]: loadmat(os.path.join(score_dir, f), "iscore")
            for f in sorted(os.listdir(score_dir)) if f.startswith("Score_")}


def judd_bounds(prepped):
    bounds = {name: judd_tie_bound(p[0], p[2]) for name, p in prepped.items()}
    bounds[EMPTY] = np.zeros(1)
    return bounds


@pytest.fixture(scope="module")
def jax_eval(tmp_path_factory):
    """The JAX drivers on a fresh dataset, seeds 0 (per-frame shufmaps) and 1
    (the summed shufmap): their scores, mean scores and caches."""
    base = tmp_path_factory.mktemp("jax_eval")
    root, res = str(base / "UAV2"), str(base / "res")
    prepped = write_dataset(root, res)
    js.evalscores_vid(root, res, "UAV2", ["M"], batch_size=4, rng=np.random.RandomState(0))
    js.evalscores_vid_sum(root, res, "UAV2", ["M"], batch_size=4, rng=np.random.RandomState(1))
    return {"root": root, "res": res, "prepped": prepped,
            "scores": read_scores(os.path.join(res, "Scores", "M")),
            "scores_sum": read_scores(os.path.join(res, "Scores_sum", "M")),
            "means": js.mean_scores(res, ["M"]),
            "means_sum": js.mean_scores(res, ["M"], score_subdir="Scores_sum")}


def _assert_dirs_match(got, want, bounds):
    assert sorted(got) == sorted(want) == sorted(VIDEOS) + [EMPTY]
    for name in want:
        assert_scores_match(got[name], want[name], bounds[name], name)
    assert np.isnan(got[EMPTY]).all() and got[EMPTY].shape == (1, len(KEYS))


def _assert_means_match(got, want, bounds):
    judd = float(np.mean([np.nanmean(b) for b in bounds.values()]))
    for key in KEYS:
        tol = TOL + (judd + 1e-6 if key == "AUC_Judd" else 0)
        assert abs(got["M"][key] - want["M"][key]) <= tol, key


@pytest.mark.parametrize("cache", ["jax_cache", "own_cache"])
def test_evalscores_vid_and_mean_scores_match_jax(jax_eval, tmp_path, cache):
    """The port's driver on the same dataset from the same seed: reading
    the `ALLFixPts_UAV2.npy` the JAX driver wrote, or writing its own (equal
    to it, and read back by the JAX driver to the JAX scores); the same
    `Score_*.mat`, `MeanScores.mat` and `MeanScores.json`; a second run
    skips every scored video."""
    root, res = str(tmp_path / "UAV2"), str(tmp_path / "res")
    write_dataset(root, res)
    jax_cache = os.path.join(jax_eval["root"], "ALLFixPts_UAV2.npy")
    own = os.path.join(root, "ALLFixPts_UAV2.npy")
    if cache == "jax_cache":
        shutil.copy(jax_cache, own)
    rng = np.random.RandomState(0)
    ts.evalscores_vid(root, res, "UAV2", ["M"], batch_size=4, rng=rng, device="cpu")
    bounds = judd_bounds(jax_eval["prepped"])
    _assert_dirs_match(read_scores(os.path.join(res, "Scores", "M")), jax_eval["scores"], bounds)
    means = ts.mean_scores(res, ["M"])
    _assert_means_match(means, jax_eval["means"], bounds)
    with open(os.path.join(res, "Scores", "MeanScores.json")) as f:
        saved = json.load(f)
    assert saved["keys_order"] == KEYS and saved["methods"] == means
    mat = loadmat(os.path.join(res, "Scores", "MeanScores.mat"), "meanscores")
    np.testing.assert_array_equal(mat, [[means["M"][k] for k in KEYS]])
    if cache == "own_cache":
        mine = np.load(own, allow_pickle=True)
        theirs = np.load(jax_cache, allow_pickle=True)
        assert len(mine) == len(theirs)
        assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))
        # the JAX driver reads the port's cache back to its own scores
        again = str(tmp_path / "res_jax")
        shutil.copytree(os.path.join(res, "Saliency"), os.path.join(again, "Saliency"))
        js.evalscores_vid(root, again, "UAV2", ["M"], batch_size=4, rng=np.random.RandomState(0))
        for name, want in jax_eval["scores"].items():
            got = loadmat(os.path.join(again, "Scores", "M", f"Score_{name}.mat"), "iscore")
            np.testing.assert_array_equal(got, want)
    # resume: every video has its score file, so nothing is read or drawn
    stamps = {f: os.path.getmtime(os.path.join(res, "Scores", "M", f))
              for f in os.listdir(os.path.join(res, "Scores", "M"))}
    state = rng.get_state()
    ts.evalscores_vid(root, res, "UAV2", ["M"], batch_size=4, rng=rng, device="cpu")
    assert stamps == {f: os.path.getmtime(os.path.join(res, "Scores", "M", f))
                      for f in os.listdir(os.path.join(res, "Scores", "M"))}
    assert all(np.array_equal(a, b) for a, b in zip(state, rng.get_state()))


@pytest.mark.parametrize("cache", ["jax_cache", "own_cache"])
def test_evalscores_vid_sum_matches_jax(jax_eval, tmp_path, cache):
    """The summed-shufmap driver; `Shuffle_UAV2.mat` read from the JAX
    driver, or written by the port and equal to the JAX driver's."""
    root, res = str(tmp_path / "UAV2"), str(tmp_path / "res")
    write_dataset(root, res)
    jax_cache = os.path.join(jax_eval["root"], "Shuffle_UAV2.mat")
    own = os.path.join(root, "Shuffle_UAV2.mat")
    if cache == "jax_cache":
        shutil.copy(jax_cache, own)
    ts.evalscores_vid_sum(root, res, "UAV2", ["M"], batch_size=4, rng=np.random.RandomState(1),
                          device="cpu")
    bounds = judd_bounds(jax_eval["prepped"])
    _assert_dirs_match(read_scores(os.path.join(res, "Scores_sum", "M")),
                       jax_eval["scores_sum"], bounds)
    _assert_means_match(ts.mean_scores(res, ["M"], score_subdir="Scores_sum"),
                        jax_eval["means_sum"], bounds)
    if cache == "own_cache":
        np.testing.assert_array_equal(loadmat(own, "ShufMap"), loadmat(jax_cache, "ShufMap"))
        from iip_uavsal_saliency_tpu.data.matio import loadmat as jloadmat

        np.testing.assert_array_equal(jloadmat(own, "ShufMap"), loadmat(jax_cache, "ShufMap"))


def test_cli_eval_equals_evalscores_vid_and_mean_scores(tmp_path, monkeypatch):
    """`cli eval --device cpu` against `evalscores_vid` + `mean_scores` with
    the batch of the config; the CLI's RandomState is unseeded, so both are
    given seed 0 here and must then agree bit for bit."""
    data_dir = str(tmp_path / "data")
    results = os.path.join(data_dir, "UAV2-TE", "Results", "Results_CLI")
    write_dataset(os.path.join(data_dir, "UAV2-TE"), results, method="CLI")
    direct = str(tmp_path / "direct")
    shutil.copytree(os.path.join(results, "Saliency"), os.path.join(direct, "Saliency"))
    shutil.copytree(os.path.join(data_dir, "UAV2-TE"), str(tmp_path / "root"),
                    ignore=shutil.ignore_patterns("Results"))
    ts.evalscores_vid(str(tmp_path / "root"), direct, "UAV2-TE", ["CLI"], batch_size=3,
                      rng=np.random.RandomState(0), device="cpu")
    want = ts.mean_scores(direct, ["CLI"])

    seeded = np.random.RandomState
    monkeypatch.setattr(ts.np.random, "RandomState",
                        lambda seed=None: seeded(0 if seed is None else seed))
    assert cli.main(["eval", "--data_dir", data_dir, "--method_name", "CLI",
                     "--eval_batch_size", "3", "--device", "cpu"]) == 0
    got = read_scores(os.path.join(results, "Scores", "CLI"))
    for name, scores in read_scores(os.path.join(direct, "Scores", "CLI")).items():
        np.testing.assert_array_equal(got[name], scores)
    with open(os.path.join(results, "Scores", "MeanScores.json")) as f:
        assert json.load(f)["methods"] == want


def write_images(data_dir, res_dir, method="M"):
    """5 images of 32x40 and one of 24x40 (a change of shape flushes the
    batch) with PNG maps and `I` fixation .mat files; image 2's saliency is
    all zero (a NaN row)."""
    for d in (os.path.join(data_dir, "maps"), os.path.join(data_dir, "fixations", "maps"),
              os.path.join(res_dir, "Saliency", method)):
        os.makedirs(d, exist_ok=True)
    names = []
    for i in range(6):
        h, w = (24, 40) if i == 5 else (32, 40)
        sal, fmap, fpts = video(30 + i, 1, h, w)
        name = f"img_{i:03d}"
        if i == 2:
            sal[:] = 0
        cv2.imwrite(os.path.join(res_dir, "Saliency", method, name + ".png"), sal[:, :, 0, 0])
        cv2.imwrite(os.path.join(data_dir, "maps", name + ".png"), fmap[:, :, 0, 0])
        scipy.io.savemat(os.path.join(data_dir, "fixations", "maps", name + ".mat"),
                         {"I": fpts[:, :, 0, 0]})
        names.append(name)
    return names


def image_bounds(data_dir, res_dir, names, method="M"):
    out = []
    for name in names:
        sal = cv2.imread(os.path.join(res_dir, "Saliency", method, name + ".png"), -1)
        pts = scipy.io.loadmat(os.path.join(data_dir, "fixations", "maps", name + ".mat"))["I"]
        out.append(judd_tie_bound(sal[None] / 255.0, pts[None])[0])
    return np.asarray(out)


@pytest.mark.parametrize("device_auc", [True, False], ids=["device_auc", "host_auc"])
@pytest.mark.parametrize("driver", ["evalscores_img", "evalscores_img_sum"])
def test_evalscores_img_matches_jax(tmp_path, driver, device_auc):
    runs = {}
    for pkg, mod in (("jax", js), ("port", ts)):
        data_dir, res_dir = str(tmp_path / pkg / "val"), str(tmp_path / pkg / "res")
        names = write_images(data_dir, res_dir)
        kw = {"device": "cpu"} if pkg == "port" else {}
        rng = np.random.RandomState(5)
        getattr(mod, driver)(data_dir, res_dir, "SALTEST", ["M"], rng=rng,
                             device_auc=device_auc, **kw)
        sub = "Scores" if driver == "evalscores_img" else "Scores_sum"
        runs[pkg] = (loadmat(os.path.join(res_dir, sub, "Score_M.mat"), "scores"), rng,
                     mod.mean_scores_img(res_dir, ["M"], score_subdir=sub))
    (want, rng_j, means_j), (got, rng_t, means_t) = runs["jax"], runs["port"]
    assert_same_rng(rng_j, rng_t)
    bound = image_bounds(data_dir, res_dir, names)
    if not device_auc:  # the host path, AUC-Judd's 1e-7 jitter drawn from the RandomState
        bound = np.zeros_like(bound)
    assert_scores_match(got, want, bound, driver)
    assert np.isnan(got[2]).all() and np.isfinite(np.delete(got, 2, 0)).all()
    for key in KEYS:
        tol = TOL + (bound.mean() + 1e-6 if key == "AUC_Judd" else 0)
        assert abs(means_t["M"][key] - means_j["M"][key]) <= tol, key


def test_cli_eval_img_runs_on_the_cpu(tmp_path):
    """`cli eval-img --device cpu` writes `Scores/Score_<m>.mat` in the JAX
    layout under salicon-15/val; unset `device_auc` on the CPU picks the
    per-image host path."""
    val = str(tmp_path / "salicon-15" / "val")
    res = os.path.join(val, "Results", "Results_IMG")
    write_images(val, res, method="IMG")
    assert ts._resolve_img_device_auc(None, "cpu") is False
    assert ts.device_dispatch_ms("cpu") > 0
    assert cli.main(["eval-img", "--data_dir", str(tmp_path), "--method_name", "IMG",
                     "--device", "cpu"]) == 0
    scores = loadmat(os.path.join(res, "Scores", "Score_IMG.mat"), "scores")
    assert scores.shape == (6, len(KEYS))
    assert np.isnan(scores[2]).all() and np.isfinite(np.delete(scores, 2, 0)).all()


def test_without_a_card_the_entry_points_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sal, fmap, fpts = video(0, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts._score_video(sal, fmap, fpts, [], KEYS, 4, np.random.RandomState(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.evalscores_vid(str(tmp_path), str(tmp_path), "UAV2", ["M"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.evalscores_img(str(tmp_path), str(tmp_path), "SALICON", ["M"])
    for cmd in ("eval", "eval-img"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([cmd, "--data_dir", str(tmp_path)])


def test_uint8_ships_as_uint8_and_f64_as_f32():
    assert ts._to_device(np.zeros((2, 2), np.uint8), torch.device("cpu")).dtype == torch.uint8
    assert ts._to_device(np.zeros((2, 2)), torch.device("cpu")).dtype == torch.float32


def test_scorer_tables_match_jax():
    assert ts.SHUFF_SIZE == js.SHUFF_SIZE
    assert ts.KEYS_ORDER == js.KEYS_ORDER
    for n in (0, 1, 255, 256, 257, 1000):
        assert ts._bucket(n) == js._bucket(n)
