"""Evaluation drivers: per-video 7-metric scoring with caches, and the mean
scores (counterpart of `iip_uavsal_saliency_tpu/evaluation/scorer.py`).

- `collect_all_fixations`: the pool of normalized fixation coordinates over
  the dataset, cached to `ALLFixPts_<DS>.npy`;
- `sample_shufmap`: a random 10-frame negative map;
- `build_shuffle_map`: the summed-fixation map, cached to `Shuffle_<DS>.mat`;
- `evalscores_vid`: per method, per video, resume-skip on an existing
  `Scores/<m>/Score_<vid>.mat`, saliency resized to the ground truth's size
  when they differ, NaN rows for degenerate frames;
- `mean_scores`: NaN-masked per-video means, then the dataset's mean;
- the image drivers `evalscores_img`, `evalscores_img_sum`, `mean_scores_img`.

Device and host: KLD, CC, NSS, SIM and AUC-Judd run batched on the device
(`metrics_torch`), a batch of frames per call. AUC-Borji and AUC-shuffled
run there too by default (`device_auc=True`): the host samples only the
negative pixel indices. `device_auc=False` is the reference-shaped host
path (`metrics_np`), chosen explicitly; nothing falls back to it.

Every random draw comes from one `np.random.RandomState`, in the JAX
scorer's order: per batch of frames the jitter seed of AUC-Judd, then the
Borji indices, then the shuffled maps and indices. The same seed therefore
leaves both packages' `RandomState` in the same state, and their AUC-Borji
and AUC-shuffled agree to f32 rounding; AUC-Judd's tie-breaking draws come
from a `torch.Generator` seeded by that integer, so tied frames agree only
in distribution.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
card and no explicit device they raise. cv2 (a resize of a saliency map to
the ground truth's size, the image drivers' PNGs) and h5py (`.mat` files)
are imported where they are used.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.letterbox import require_cv2, resize_fixation
from ..data.matio import loadmat, savemat
from ..device import resolve_device
from ..utils.logging import get_logger
from .metrics_np import (auc_borji_np, auc_judd_np, auc_shuffled_np, cc_np, kld_np, nss_np,
                         sim_np)
from .metrics_torch import (KEYS_ORDER, eval_auc_judd, eval_auc_sweep, eval_cc, eval_kl,
                            eval_nss, eval_sim)

log = get_logger("eval")

SHUFF_SIZE = {
    "SALICON": (480, 640),
    "DIEM": (480, 640),
    "DIEM20": (480, 640),
    "CITIUS": (240, 320),
    "SFU": (288, 352),
    "LEDOV": (1080, 1920),
    "LEDOV41": (1080, 1920),
    "UAV2-TE": (720, 1280),
    "UAV2": (720, 1280),
    "AVS1K-TE": (720, 1280),
    "AVS1K": (720, 1280),
    "default": (480, 640),
}

# the rows of `_device_metrics`
DEVICE_KEYS = ["KLD", "CC", "NSS", "SIM", "AUC_Judd"]


def _device_metrics(pred, true, generator):
    """KLD, CC, NSS, SIM and AUC-Judd of a batch, as one (5, N) tensor.
    `generator` breaks AUC-Judd's ties at random: saliency maps are uint8
    and heavily tied, and the reference always jitters. Takes uint8 inputs
    and converts them on the device."""
    pred = pred.float()
    true = true.float()
    return torch.stack([
        eval_kl(pred, true),
        eval_cc(pred, true),
        eval_nss(pred, true),
        eval_sim(pred, true),
        eval_auc_judd(pred, true, generator=generator),
    ])


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` on `device` as the JAX scorer ships it: float64 as f32, uint8
    as uint8 (converted on the device). On the card through pinned memory,
    the copy not waited for."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def device_dispatch_ms(device=None) -> float:
    """The host -> device -> host round trip of a scalar, in ms: the
    fastest of 5 after a warm-up."""
    device = resolve_device(device)
    x = torch.ones((8, 8), device=device)
    float(x.sum())
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(x.sum())
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def _resolve_img_device_auc(device_auc: Optional[bool], device=None) -> bool:
    """None = auto: the batched device path on a card whose round trip is
    under 2 ms, else per-image scoring on the host (the JAX scorer's rule:
    on the CPU the dense threshold sweep loses to numpy's searchsorted, and
    a remote device pays its round trip per batch)."""
    if device_auc is not None:
        return device_auc
    device = resolve_device(device)
    ms = device_dispatch_ms(device)
    use = device.type != "cpu" and ms < 2.0
    log.info("image eval auto-select: device=%s dispatch=%.2fms -> %s path",
             device, ms, "device-batched" if use else "per-image host")
    return use


def _bucket(n: int, step: int = 256) -> int:
    """Round up to a multiple of `step` (at least `step`): the number of
    negative rows a batch draws, as the JAX scorer draws them."""
    return max(step, -(-n // step) * step)


def _borji_neg_idx(gt_pts_batch, n_pix: int, n_rep: int, rng):
    """Uniform-over-pixels negative indices and per-frame valid-row counts
    (host side of the device AUC-Borji; the distribution of metrics_np)."""
    n_fix = [(f > 0.5).sum() for f in gt_pts_batch]
    nf = _bucket(int(max(n_fix)) if n_fix else 1)
    idx = rng.randint(0, n_pix, (len(gt_pts_batch), nf, n_rep))
    return idx.astype(np.int32), np.asarray(n_fix, np.int32)


def _shuffled_neg_idx(gt_pts_batch, shuf_inds, n_rep: int, rng):
    """Negative indices drawn from other videos' fixation locations (host
    side of the device shuffled AUC). `shuf_inds`: per frame, the flat
    indices of its shufmap's fixations."""
    b = len(gt_pts_batch)
    ks = []
    for f, ind in zip(gt_pts_batch, shuf_inds):
        n_fix = int((f > 0.5).sum())
        ks.append(min(n_fix, ind.size))
    nf = _bucket(int(max(ks)) if ks else 1)
    idx = np.zeros((b, nf, n_rep), np.int32)
    for i, (ind, k) in enumerate(zip(shuf_inds, ks)):
        if k:
            idx[i, :k] = ind[rng.randint(0, ind.size, (k, n_rep))]
    return idx, np.asarray(ks, np.int32)


def _jitter_generator(rng: np.random.RandomState, device: torch.device) -> torch.Generator:
    """AUC-Judd's tie-breaking generator for one batch, seeded by one draw
    from `rng` (the JAX scorer's `_jitter_key` draw)."""
    return torch.Generator(device=device).manual_seed(int(rng.randint(0, 2**31 - 1)))


def collect_all_fixations(fixs_dir: str, dataset: str = "", maxframes: float = float("inf")):
    """Pool of per-frame normalized fixation coordinate arrays."""
    fix_names = sorted(f for f in os.listdir(fixs_dir) if f.endswith(".mat"))
    dataset = dataset.upper()
    if dataset == "CITIUS":
        fix_names = fix_names[:45]
    if dataset == "DIEM20":
        maxframes = 300

    all_pts = []
    for name in fix_names:
        fixpts = loadmat(os.path.join(fixs_dir, name), "fixLoc")
        useframes = int(min(maxframes, fixpts.shape[3]))
        h, w = fixpts.shape[0], fixpts.shape[1]
        for i in range(useframes):
            fx, fy = np.where(fixpts[:, :, 0, i])
            all_pts.append(
                np.stack([fx / h, fy / w], axis=1) if fx.size else np.zeros((0, 2))
            )
    return all_pts


def sample_shufmap(all_fix_pts, size=(480, 640), nframes: int = 10, rng=None):
    """Random union of `nframes` frames' fixations as the negative set."""
    rng = rng or np.random
    nframes = min(nframes, len(all_fix_pts))
    idx = rng.randint(0, len(all_fix_pts), int(nframes))
    pts = np.concatenate([all_fix_pts[i] for i in idx], 0) if len(idx) else np.zeros((0, 2))
    pts = pts.copy()
    pts[:, 0] *= size[0]
    pts[:, 1] *= size[1]
    pts = np.round(pts).astype(np.int64)
    ok = (pts[:, 0] < size[0]) & (pts[:, 1] < size[1])
    pts = pts[ok]
    shufmap = np.zeros(size, np.uint8)
    if pts.size:
        shufmap[pts[:, 0], pts[:, 1]] = 1
    return shufmap


def build_shuffle_map(fixs_dir: str, dataset: str = "", size=None,
                      maxframes: float = float("inf")):
    """Summed fixation map over the dataset."""
    dataset = dataset.upper()
    if size is None:
        size = SHUFF_SIZE.get(dataset, SHUFF_SIZE["default"])
    fix_names = sorted(f for f in os.listdir(fixs_dir) if f.endswith(".mat"))
    if dataset == "DIEM20":
        maxframes = 300
    shufmap = np.zeros(size)
    for name in fix_names:
        fixpts = loadmat(os.path.join(fixs_dir, name), "fixLoc")
        useframes = int(min(maxframes, fixpts.shape[3]))
        fixpts = fixpts[:, :, :, :useframes]
        if fixpts.shape[:2] != tuple(size):
            stack = np.stack(
                [resize_fixation(fixpts[:, :, 0, i], size[0], size[1]) for i in range(useframes)],
                axis=2,
            )
            shufmap += stack.sum(axis=2)
        else:
            shufmap += fixpts[:, :, 0, :].sum(axis=2)
        shufmap = np.round(shufmap)
    return shufmap


def _prep_video(salmap, fixmap, fixpts):
    """Host prep shared by the video drivers: align the frame counts and
    bring the saliency to the ground truth's size. Returns (sal, gt_map,
    gt_pts, nframes) in (T, H, W) layout; runs on the prefetch thread.

    The resize is cv2's on the input dtype, as the reference resizes its
    uint8 frames (cv2 rounds the interpolated values back to uint8): a float
    resize would move NSS and CC by about 0.001 from every score the
    reference published."""
    nframes = min(salmap.shape[3], fixpts.shape[3], fixmap.shape[3])
    if nframes == 0:
        return None, None, None, 0
    if salmap.shape[:2] != fixmap.shape[:2]:
        cv2 = require_cv2()
        sal = np.stack(
            [
                cv2.resize(salmap[:, :, 0, i], (fixmap.shape[1], fixmap.shape[0]))
                for i in range(nframes)
            ]
        )
    else:
        sal = np.ascontiguousarray(salmap[:, :, 0, :nframes].transpose(2, 0, 1))
    gt_map = np.ascontiguousarray(fixmap[:, :, 0, :nframes].transpose(2, 0, 1))
    gt_pts = np.ascontiguousarray(fixpts[:, :, 0, :nframes].transpose(2, 0, 1))
    return sal, gt_map, gt_pts, nframes


def _score_video(salmap, fixmap, fixpts, all_fix_pts, keys_order, batch_size, rng,
                 fixed_shufmap=None, device_auc: bool = True, prepped=None, device=None):
    """(T, len(keys)) score matrix for one video. `fixed_shufmap`: one
    dataset-wide sAUC negative map instead of per-frame samples.
    `device_auc`: AUC-Borji/shuffled batched on the device (the host
    samples only the negative indices); False keeps the reference-shaped
    host path. `prepped`: the _prep_video result when the caller already
    ran it (salmap/fixmap/fixpts are then ignored)."""
    device = resolve_device(device)
    sal, gt_map, gt_pts, nframes = (
        prepped if prepped is not None else _prep_video(salmap, fixmap, fixpts)
    )
    if nframes == 0:
        # the serving runner writes an empty salmap for a video shorter than
        # time_dims: one all-NaN row, which mean_scores' nanmean skips
        return np.full((1, len(keys_order)), np.nan)
    scores = np.zeros((nframes, len(keys_order)))

    need_borji = device_auc and "AUC_Borji" in keys_order
    need_shuf = device_auc and "AUC_shuffled" in keys_order
    n_pix = sal.shape[1] * sal.shape[2]
    # fixed shufmap: its fixation index set is the same for every frame
    fixed_shuf_ind = (
        np.flatnonzero(fixed_shufmap) if need_shuf and fixed_shufmap is not None else None
    )

    # The final partial batch is padded to batch_size by repeating the last
    # frame (results sliced back), as the JAX scorer pads it to keep its
    # compiled shapes: the padded frames' negative indices and shufmaps are
    # drawn from `rng` too, so the padding keeps the two packages' draws in
    # step.
    def _pad_to_batch(a):
        pad = batch_size - len(a)
        return a if pad <= 0 else np.concatenate([a, np.repeat(a[-1:], pad, 0)])

    rows: List[np.ndarray] = []

    # Depth-2 pipeline over frame batches: the device work of batch k is
    # queued without waiting, the host samples batch k+1's negative indices
    # (the per-frame shufmaps are the expensive part) and queues its work,
    # and only then are batch k's scores read back (the one wait). All of
    # batch k's draws precede batch k+1's, the order of a sequential loop.
    def _dispatch(b):
        n_act = min(batch_size, nframes - b)
        p = _to_device(_pad_to_batch(sal[b:b + batch_size]), device).float()[..., None]
        t = torch.stack([_to_device(_pad_to_batch(gt[b:b + batch_size]), device).float()
                         for gt in (gt_map, gt_pts)], dim=-1)
        out = [_device_metrics(p, t, _jitter_generator(rng, device))]
        pts_b = _pad_to_batch(gt_pts[b:b + batch_size])
        if need_borji:
            idx, nv = _borji_neg_idx(pts_b, n_pix, 100, rng)
            out.append(eval_auc_sweep(p, t, _to_device(idx, device),
                                      _to_device(nv, device))[None])
        if need_shuf:
            shuf_inds = [
                fixed_shuf_ind
                if fixed_shuf_ind is not None
                else np.flatnonzero(sample_shufmap(all_fix_pts, size=sal.shape[1:], rng=rng))
                for _ in range(len(pts_b))
            ]
            idx, nv = _shuffled_neg_idx(pts_b, shuf_inds, 100, rng)
            out.append(eval_auc_sweep(p, t, _to_device(idx, device),
                                      _to_device(nv, device))[None])
        return torch.cat(out), n_act

    def _collect(job):
        out, n_act = job
        rows.append(out.cpu().numpy()[:, :n_act])

    pending = None
    for b in range(0, nframes, batch_size):
        job = _dispatch(b)
        if pending is not None:
            _collect(pending)
        pending = job
    if pending is not None:
        _collect(pending)
    device_keys = (DEVICE_KEYS + ["AUC_Borji"] * need_borji
                   + ["AUC_shuffled"] * need_shuf)
    device_vals = dict(zip(device_keys, np.concatenate(rows, axis=1)))

    for k, key in enumerate(keys_order):
        if key in device_vals:
            scores[:, k] = device_vals[key][:nframes]
        elif key == "AUC_Borji":
            scores[:, k] = [
                auc_borji_np(sal[i], gt_pts[i], rng=rng) for i in range(nframes)
            ]
        elif key == "AUC_shuffled":
            for i in range(nframes):
                shufmap = (
                    fixed_shufmap
                    if fixed_shufmap is not None
                    else sample_shufmap(all_fix_pts, size=sal.shape[1:], rng=rng)
                )
                scores[i, k] = auc_shuffled_np(sal[i], gt_pts[i], shufmap, rng=rng)
        else:
            raise KeyError(key)

    # NaN for degenerate frames
    for i in range(nframes):
        if not np.any(sal[i]) or not (np.any(gt_map[i]) and np.any(gt_pts[i])):
            scores[i, :] = np.nan
    return scores


def _prefetch_videos(sal_names, salmap_dir, maps_dir, fixs_dir):
    """Yield (file_name, prepped, gt_hw) with one video of lookahead: video
    n+1's three .mat loads and resize (_prep_video) run on a worker thread
    while video n is scored. No rng is touched here."""

    def load(name):
        file_name = name[:-4]
        salmap = loadmat(os.path.join(salmap_dir, name), "salmap")
        fixmap = loadmat(os.path.join(maps_dir, file_name + "_fixMaps.mat"), "fixMap")
        fixpts = loadmat(os.path.join(fixs_dir, file_name + "_fixPts.mat"), "fixLoc")
        return file_name, _prep_video(salmap, fixmap, fixpts), fixpts.shape[:2]

    pool = ThreadPoolExecutor(max_workers=1)
    future = None
    try:
        future = pool.submit(load, sal_names[0]) if sal_names else None
        for i in range(len(sal_names)):
            item = future.result()
            future = (
                pool.submit(load, sal_names[i + 1]) if i + 1 < len(sal_names) else None
            )
            yield item
    finally:
        # wait=False: a consumer error (or Ctrl-C) must not stall behind an
        # in-flight .mat load; report a worker failure the dying loop drops
        pool.shutdown(wait=False, cancel_futures=True)
        if future is not None:
            future.cancel()
            try:
                exc = future.exception(timeout=1)
            except Exception:  # still running or cancelled: nothing to report
                exc = None
            if exc is not None:
                log.error("prefetch .mat load failed: %s", exc)


def _pending_videos(salmap_dir: str, iscore_dir: str) -> List[str]:
    """The saliency files of a method without a score file yet (resume)."""
    return [f for f in sorted(os.listdir(salmap_dir)) if f.endswith(".mat")
            and not os.path.exists(os.path.join(iscore_dir, f"Score_{f[:-4]}.mat"))]


def evalscores_vid(
    root_dir: str,
    sal_dir: str,
    dataset: str,
    method_names: Sequence[str],
    keys_order: Sequence[str] = KEYS_ORDER,
    batch_size: int = 32,
    rng: Optional[np.random.RandomState] = None,
    device_auc: bool = True,
    device=None,
) -> None:
    """Main video eval driver: `<sal_dir>/Saliency/<m>/<vid>.mat` against
    `<root_dir>/maps/<vid>_fixMaps.mat` and `fixations/maps/<vid>_fixPts.mat`
    to `<sal_dir>/Scores/<m>/Score_<vid>.mat`. Video n+1 is read and resized
    on a worker thread while video n is scored (_prefetch_videos); within a
    video, device batches overlap the host's sampling (_score_video)."""
    device = resolve_device(device)
    rng = rng or np.random.RandomState()
    maps_dir = os.path.join(root_dir, "maps")
    fixs_dir = os.path.join(root_dir, "fixations", "maps")
    sals_dir = os.path.join(sal_dir, "Saliency")
    score_dir = os.path.join(sal_dir, "Scores")
    os.makedirs(score_dir, exist_ok=True)

    log.info("evaluate metrics: %s", list(keys_order))
    all_fix_pts = []
    if "AUC_shuffled" in keys_order:
        cache = os.path.join(root_dir, f"ALLFixPts_{dataset.upper()}.npy")
        if not os.path.exists(cache):
            all_fix_pts = collect_all_fixations(fixs_dir, dataset)
            np.save(cache, np.array(all_fix_pts, dtype=object), allow_pickle=True)
        else:
            all_fix_pts = list(np.load(cache, allow_pickle=True))

    for m_idx, method in enumerate(method_names):
        log.info("--- %d/%d: %s", m_idx + 1, len(method_names), method)
        iscore_dir = os.path.join(score_dir, method)
        os.makedirs(iscore_dir, exist_ok=True)
        salmap_dir = os.path.join(sals_dir, method)
        sal_names = _pending_videos(salmap_dir, iscore_dir)

        for n_idx, (file_name, prepped, _) in enumerate(
            _prefetch_videos(sal_names, salmap_dir, maps_dir, fixs_dir)
        ):
            t0 = time.time()
            iscores = _score_video(
                None, None, None, all_fix_pts, keys_order, batch_size, rng,
                device_auc=device_auc, prepped=prepped, device=device,
            )
            savemat(os.path.join(iscore_dir, f"Score_{file_name}.mat"), {"iscore": iscores})
            log.info("%d/%d %s: %d frames %.2fs", n_idx + 1, len(sal_names), file_name,
                     iscores.shape[0], time.time() - t0)


def evalscores_vid_sum(
    root_dir: str,
    sal_dir: str,
    dataset: str,
    method_names: Sequence[str],
    keys_order: Sequence[str] = KEYS_ORDER,
    batch_size: int = 32,
    rng: Optional[np.random.RandomState] = None,
    device_auc: bool = True,
    device=None,
) -> None:
    """Sum-shufmap variant: one dataset-wide summed fixation map as the sAUC
    negative set, cached to `Shuffle_<DS>.mat`; scores to `Scores_sum/`."""
    device = resolve_device(device)
    rng = rng or np.random.RandomState()
    maps_dir = os.path.join(root_dir, "maps")
    fixs_dir = os.path.join(root_dir, "fixations", "maps")
    sals_dir = os.path.join(sal_dir, "Saliency")
    score_dir = os.path.join(sal_dir, "Scores_sum")
    os.makedirs(score_dir, exist_ok=True)

    shufmap = None
    if "AUC_shuffled" in keys_order:
        cache = os.path.join(root_dir, f"Shuffle_{dataset.upper()}.mat")
        if not os.path.exists(cache):
            shufmap = build_shuffle_map(fixs_dir, dataset)
            savemat(cache, {"ShufMap": shufmap})
        else:
            shufmap = loadmat(cache, "ShufMap")

    for m_idx, method in enumerate(method_names):
        log.info("--- %d/%d: %s", m_idx + 1, len(method_names), method)
        iscore_dir = os.path.join(score_dir, method)
        os.makedirs(iscore_dir, exist_ok=True)
        salmap_dir = os.path.join(sals_dir, method)
        sal_names = _pending_videos(salmap_dir, iscore_dir)

        for n_idx, (file_name, prepped, gt_hw) in enumerate(
            _prefetch_videos(sal_names, salmap_dir, maps_dir, fixs_dir)
        ):
            t0 = time.time()
            ishufmap = shufmap
            if ishufmap is not None and ishufmap.shape != tuple(gt_hw):
                ishufmap = resize_fixation(ishufmap, gt_hw[0], gt_hw[1])
            iscores = _score_video(
                None, None, None, [], keys_order, batch_size, rng,
                fixed_shufmap=ishufmap, device_auc=device_auc, prepped=prepped, device=device,
            )
            savemat(os.path.join(iscore_dir, f"Score_{file_name}.mat"), {"iscore": iscores})
            log.info("%d/%d %s: %d frames %.2fs", n_idx + 1, len(sal_names), file_name,
                     iscores.shape[0], time.time() - t0)


def collect_all_fixations_img(fixs_dir: str):
    """Image-dataset pool of normalized fixation coordinates (key 'I')."""
    fix_names = sorted(f for f in os.listdir(fixs_dir) if f.endswith(".mat"))
    all_pts = []
    for name in fix_names:
        fixpts = np.asarray(loadmat(os.path.join(fixs_dir, name), "I")) > 0.5
        h, w = fixpts.shape[0], fixpts.shape[1]
        fx, fy = np.where(fixpts)
        all_pts.append(
            np.stack([fx / h, fy / w], axis=1) if fx.size else np.zeros((0, 2))
        )
    return all_pts


def build_shuffle_map_img(fixs_dir: str, dataset: str = "", size=None):
    """Summed fixation map over an image dataset: points thresholded at 0.5
    before summing, no rounding (the summands are integral). `size=None`
    takes the dataset's size from `SHUFF_SIZE`."""
    if size is None:
        size = SHUFF_SIZE.get(dataset.upper(), SHUFF_SIZE["default"])
    fix_names = sorted(f for f in os.listdir(fixs_dir) if f.endswith(".mat"))
    shufmap = np.zeros(size)
    for name in fix_names:
        fixpts = np.asarray(loadmat(os.path.join(fixs_dir, name), "I")) > 0.5
        if fixpts.shape[:2] != tuple(size):
            fixpts = resize_fixation(fixpts, size[0], size[1])
        shufmap += fixpts
    return shufmap


def _score_image(salmap, fixmap, fixpts, keys_order, shufmap, rng):
    """One image's score row (len(keys),), wholly on the host (metrics_np);
    NaN if any input is degenerate."""
    if not np.any(salmap) or not np.any(fixmap) or not np.any(fixpts):
        return np.full(len(keys_order), np.nan)
    host_vals = {
        "KLD": lambda: kld_np(salmap, fixmap),
        "CC": lambda: cc_np(salmap, fixmap),
        "NSS": lambda: nss_np(salmap, fixpts),
        "SIM": lambda: sim_np(salmap, fixmap),
        "AUC_Judd": lambda: auc_judd_np(salmap, fixpts, rng=rng),
        "AUC_Borji": lambda: auc_borji_np(salmap, fixpts, rng=rng),
        "AUC_shuffled": lambda: auc_shuffled_np(salmap, fixpts, shufmap, rng=rng),
    }
    row = np.zeros(len(keys_order))
    for k, key in enumerate(keys_order):
        row[k] = host_vals[key]()
    return row


def _score_image_batch(sals, fmaps, fpts, keys_order, shufmaps, rng, device=None):
    """(B, len(keys)) scores for same-shaped images, all 7 metrics batched
    on the device (an image with any degenerate input gets a NaN row). The
    batch is padded to a multiple of 8 by repeating the last image, as the
    JAX scorer pads it (its draws follow the padded batch)."""
    device = resolve_device(device)
    n_act = len(sals)
    pad = -(-n_act // 8) * 8 - n_act
    pred = np.stack(sals)[..., None].astype(np.float32)
    true = np.stack([np.stack(fmaps), np.stack(fpts)], axis=-1).astype(np.float32)
    if pad:
        pred = np.concatenate([pred, np.repeat(pred[-1:], pad, 0)])
        true = np.concatenate([true, np.repeat(true[-1:], pad, 0)])
        fpts = list(fpts) + [fpts[-1]] * pad
        shufmaps = list(shufmaps) + [shufmaps[-1]] * pad
    p, t = _to_device(pred, device), _to_device(true, device)
    out = [_device_metrics(p, t, _jitter_generator(rng, device))]
    keys = list(DEVICE_KEYS)
    n_pix = pred.shape[1] * pred.shape[2]
    if "AUC_Borji" in keys_order:
        idx, nv = _borji_neg_idx(fpts, n_pix, 100, rng)
        out.append(eval_auc_sweep(p, t, _to_device(idx, device), _to_device(nv, device))[None])
        keys.append("AUC_Borji")
    if "AUC_shuffled" in keys_order:
        shuf_inds = [np.flatnonzero(sm) for sm in shufmaps]
        idx, nv = _shuffled_neg_idx(fpts, shuf_inds, 100, rng)
        out.append(eval_auc_sweep(p, t, _to_device(idx, device), _to_device(nv, device))[None])
        keys.append("AUC_shuffled")
    device_vals = dict(zip(keys, torch.cat(out).cpu().numpy()))
    scores = np.stack([device_vals[k][:n_act] for k in keys_order], axis=1)
    for i in range(n_act):
        if not (np.any(sals[i]) and np.any(fmaps[i]) and np.any(fpts[i])):
            scores[i, :] = np.nan
    return scores


def _evalscores_img_common(
    data_dir, res_dir, method_names, keys_order, rng, shufmap_for, score_subdir,
    device_auc: Optional[bool] = None, batch_size: int = 32, device=None,
):
    device = resolve_device(device)
    device_auc = _resolve_img_device_auc(device_auc, device)
    maps_dir = os.path.join(data_dir, "maps")
    sals_dir = os.path.join(res_dir, "Saliency")
    score_dir = os.path.join(res_dir, score_subdir)
    os.makedirs(score_dir, exist_ok=True)
    cv2 = require_cv2()

    for m_idx, method in enumerate(method_names):
        log.info("--- %d/%d: %s", m_idx + 1, len(method_names), method)
        score_path = os.path.join(score_dir, f"Score_{method}.mat")
        if os.path.exists(score_path):  # resume
            continue
        salmap_dir = os.path.join(sals_dir, method)
        sal_names = sorted(f for f in os.listdir(salmap_dir) if f.endswith(".png"))
        fixs_dir = os.path.join(data_dir, "fixations", "maps")

        scores = np.zeros((len(sal_names), len(keys_order)))
        batch: List = []  # (row_idx, sal, fmap, fpts, shufmap, shape_key)

        def flush():
            if not batch:
                return
            idxs = [b[0] for b in batch]
            scores[idxs] = _score_image_batch(
                [b[1] for b in batch], [b[2] for b in batch],
                [b[3] for b in batch], keys_order, [b[4] for b in batch], rng, device,
            )
            batch.clear()

        for n_idx, name in enumerate(sal_names):
            salmap = cv2.imread(os.path.join(salmap_dir, name), -1)
            fixmap = cv2.imread(os.path.join(maps_dir, name), -1)
            if salmap is None:
                raise IOError(f"unreadable image: {os.path.join(salmap_dir, name)}")
            if fixmap is None:
                raise IOError(f"unreadable image: {os.path.join(maps_dir, name)}")
            salmap = salmap / 255.0
            fixmap = fixmap / 255.0
            fixpts = np.asarray(loadmat(os.path.join(fixs_dir, name[:-4] + ".mat"), "I"))
            if not device_auc:
                scores[n_idx] = _score_image(
                    salmap, fixmap, fixpts, keys_order, shufmap_for(fixpts), rng
                )
                continue
            # batch same-shaped images, flushed on a change of shape: the key
            # covers all three inputs, which one np.stack takes
            shape_key = (salmap.shape, fixmap.shape, fixpts.shape)
            if batch and batch[-1][5] != shape_key:
                flush()
            batch.append((n_idx, salmap, fixmap, fixpts, shufmap_for(fixpts), shape_key))
            if len(batch) >= batch_size:
                flush()
        flush()
        savemat(score_path, {"scores": scores})
        log.info("%s: %d images scored", method, len(sal_names))


def evalscores_img(
    data_dir: str,
    res_dir: str,
    dataset: str,
    method_names: Sequence[str],
    keys_order: Sequence[str] = KEYS_ORDER,
    rng: Optional[np.random.RandomState] = None,
    device_auc: Optional[bool] = None,
    batch_size: int = 32,
    device=None,
) -> None:
    """Image eval driver, per-image random shufmaps from the dataset's
    fixation pool cached to `ALLFixPts_<DS>.npy`; scores to
    `<res_dir>/Scores/Score_<m>.mat`."""
    device = resolve_device(device)
    rng = rng or np.random.RandomState()
    fixs_dir = os.path.join(data_dir, "fixations", "maps")
    all_fix_pts = []
    if "AUC_shuffled" in keys_order:
        cache = os.path.join(data_dir, f"ALLFixPts_{dataset.upper()}.npy")
        if not os.path.exists(cache):
            all_fix_pts = collect_all_fixations_img(fixs_dir)
            np.save(cache, np.array(all_fix_pts, dtype=object), allow_pickle=True)
        else:
            all_fix_pts = list(np.load(cache, allow_pickle=True))

    def shufmap_for(fixpts):
        if "AUC_shuffled" not in keys_order:
            return None
        return sample_shufmap(all_fix_pts, size=fixpts.shape, rng=rng)

    _evalscores_img_common(
        data_dir, res_dir, method_names, keys_order, rng, shufmap_for, "Scores",
        device_auc=device_auc, batch_size=batch_size, device=device,
    )


def evalscores_img_sum(
    data_dir: str,
    res_dir: str,
    dataset: str,
    method_names: Sequence[str],
    keys_order: Sequence[str] = KEYS_ORDER,
    rng: Optional[np.random.RandomState] = None,
    device_auc: Optional[bool] = None,
    batch_size: int = 32,
    device=None,
) -> None:
    """Image eval driver, one summed-fixation shufmap cached to
    `Shuffle_<DS>.mat`; scores to `<res_dir>/Scores_sum/Score_<m>.mat`."""
    device = resolve_device(device)
    rng = rng or np.random.RandomState()
    fixs_dir = os.path.join(data_dir, "fixations", "maps")
    shufmap = None
    if "AUC_shuffled" in keys_order:
        cache = os.path.join(data_dir, f"Shuffle_{dataset.upper()}.mat")
        if not os.path.exists(cache):
            shufmap = build_shuffle_map_img(fixs_dir, dataset)
            savemat(cache, {"ShufMap": shufmap})
        else:
            shufmap = loadmat(cache, "ShufMap")

    def shufmap_for(fixpts):
        if shufmap is None:
            return None
        if shufmap.shape != fixpts.shape[:2]:
            return resize_fixation(shufmap, fixpts.shape[0], fixpts.shape[1])
        return shufmap

    _evalscores_img_common(
        data_dir, res_dir, method_names, keys_order, rng, shufmap_for, "Scores_sum",
        device_auc=device_auc, batch_size=batch_size, device=device,
    )


def mean_scores_img(
    res_dir: str,
    method_names: Sequence[str],
    keys_order: Sequence[str] = KEYS_ORDER,
    score_subdir: str = "Scores",
) -> Dict[str, Dict[str, float]]:
    """NaN-masked dataset means per method of the image scores."""
    out: Dict[str, Dict[str, float]] = {}
    for method in method_names:
        scores = loadmat(os.path.join(res_dir, score_subdir, f"Score_{method}.mat"), "scores")
        with np.errstate(invalid="ignore"):
            means = np.nanmean(scores, axis=0)
        out[method] = {k: float(means[i]) for i, k in enumerate(keys_order)}
        log.info("%s: %s", method, {k: round(v, 4) for k, v in out[method].items()})
    return out


def mean_scores(
    sal_dir: str,
    method_names: Sequence[str],
    keys_order: Sequence[str] = KEYS_ORDER,
    save: bool = True,
    score_subdir: str = "Scores",
) -> Dict[str, Dict[str, float]]:
    """Dataset-mean scores per method: NaN-masked per-video frame means,
    then the mean over videos. With `save`, writes `MeanScores.json` and a
    (M, K) matrix `MeanScores.mat` under `score_subdir` (methods in
    `method_names` order). score_subdir='Scores_sum' aggregates the output
    of evalscores_vid_sum."""
    score_dir = os.path.join(sal_dir, score_subdir)
    out: Dict[str, Dict[str, float]] = {}
    rows = []
    for method in method_names:
        iscore_dir = os.path.join(score_dir, method)
        per_video = []
        for f in sorted(os.listdir(iscore_dir)):
            if not f.endswith(".mat"):
                continue
            iscores = loadmat(os.path.join(iscore_dir, f), "iscore")
            with np.errstate(invalid="ignore"):
                per_video.append(np.nanmean(iscores, axis=0))
        means = (np.nanmean(np.stack(per_video), axis=0) if per_video
                 else np.full(len(keys_order), np.nan))
        rows.append(means)
        out[method] = {k: float(means[i]) for i, k in enumerate(keys_order)}
        log.info("%s: %s", method, {k: round(v, 4) for k, v in out[method].items()})
    if save:
        with open(os.path.join(score_dir, "MeanScores.json"), "w") as f:
            json.dump({"keys_order": list(keys_order), "methods": out}, f, indent=2)
        savemat(os.path.join(score_dir, "MeanScores.mat"), {"meanscores": np.stack(rows)})
    return out
