"""The model's priors (own copy of parts of
`iip_uavsal_saliency_tpu/data/priors.py`).

- Center-bias Gaussians (`gaussian_priors`, and the min-max normalization
  of `get_gauss_priors`), computed analytically: no `.mat` cache is read or
  written (the JAX loader reads `gauss_priors.mat` from the working
  directory when given no cache directory, ROADMAP C.2).
- Observed priors (`get_ob_priors`): per-video temporal means of the
  training split's fixation maps, letterboxed and stacked into 20 channels,
  cached as `<DS>_ob_priors_train[_val].mat` (key `PriorMaps`) in the JAX
  package's layout, so a cache written by either package serves the other.
  cv2 and h5py are imported when they are called.

Priors are channel-last (H, W, C) float32.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .letterbox import padding, require_cv2
from .matio import loadmat, savemat

EPS = 2.2204e-16


def gaussian_priors(height: int, width: int, nb_gaussian: int = 8) -> np.ndarray:
    """(H, W, nb) float64 center Gaussians, sigma_x = sigma_y = e*k/16."""
    e = height / width
    e1 = (1 - e) / 2
    e2 = e1 + e
    mu_x = np.full(nb_gaussian, 0.5)
    mu_y = np.full(nb_gaussian, 0.5)
    sigma_x = e * np.arange(1, nb_gaussian + 1) / 16
    sigma_y = sigma_x
    x_t = np.ones((height, 1)) @ np.linspace(0.0, 1.0, width).reshape(1, width)
    y_t = np.linspace(e1, e2, height).reshape(height, 1) @ np.ones((1, width))
    x_t = np.repeat(x_t[..., None], nb_gaussian, axis=2)
    y_t = np.repeat(y_t[..., None], nb_gaussian, axis=2)
    return (
        1.0 / (2 * np.pi * sigma_x * sigma_y + EPS)
        * np.exp(-((x_t - mu_x) ** 2 / (2 * sigma_x**2 + EPS)
                   + (y_t - mu_y) ** 2 / (2 * sigma_y**2 + EPS)))
    )


def get_gauss_priors(shape_r: int = 45, shape_c: int = 80, channels: int = 8) -> np.ndarray:
    """Per-channel min-max normalized Gaussian priors, (H, W, C) float32."""
    ims = gaussian_priors(shape_r, shape_c, channels)
    lo, hi = ims.min((0, 1)), ims.max((0, 1))
    return ((ims - lo) / (hi - lo + EPS)).astype(np.float32)


def make_mean_maps(datapath: str, save_frames: float = float("inf")) -> None:
    """Each video's temporal-mean fixation map, min-max scaled to [0, 255],
    written to `<datapath>/priors/<video>.png` from
    `<datapath>/maps/<video>_fixMaps.mat`."""
    cv2 = require_cv2()
    out_dir = os.path.join(datapath, "priors")
    os.makedirs(out_dir, exist_ok=True)
    maps_dir = os.path.join(datapath, "maps")
    for name in sorted(f for f in os.listdir(maps_dir) if f.endswith(".mat")):
        fixmap = loadmat(os.path.join(maps_dir, name), "fixMap")
        num = int(min(save_frames, fixmap.shape[3]))
        priormap = np.mean(fixmap[:, :, 0, :num], axis=2)
        scaled = 255 * (priormap - priormap.min()) / (priormap.max() - priormap.min() + EPS)
        cv2.imwrite(os.path.join(out_dir, name[:-len("_fixMaps.mat")] + ".png"), scaled)


def _read_ob_prior_list(datapath: str, phase_gen: str = "train",
                        prior_ext: str = ".png") -> List[str]:
    """Sorted prior PNG paths of the videos listed in `<datapath>/txt/
    train.txt` (and `val.txt` for "train_val")."""
    if phase_gen not in ("train", "train_val"):
        raise NotImplementedError(phase_gen)
    names = []
    for phase in ["train"] if phase_gen == "train" else ["train", "val"]:
        with open(os.path.join(datapath, "txt", phase + ".txt")) as f:
            names += [line.strip() for line in f if line.strip()]
    return sorted(os.path.join(datapath, "priors", n + prior_ext) for n in names)


def get_ob_priors(datapath: str, dataset: str = "", phase_gen: str = "train",
                  shape_r: int = 45, shape_c: int = 80, channels: int = 20,
                  cache_dir: str = "") -> np.ndarray:
    """Observed priors (shape_r, shape_c, channels) float32 in [0, 1].

    Read from the cache `<cache_dir>/<DATASET>_ob_priors_train[_val].mat`
    when it exists; otherwise built and written there: the mean maps (made
    by `make_mean_maps` if any is missing) letterboxed one per channel,
    and, with more videos than channels, averaged in `channels` groups of
    len // channels with the last channel the mean of the last group's
    maps. A cache of another size is letterboxed to this one. Raises
    ValueError on an empty split, OSError when the split's list is missing."""
    suffix = "_ob_priors_train.mat" if phase_gen == "train" else "_ob_priors_train_val.mat"
    cache = os.path.join(cache_dir, dataset.upper() + suffix)
    if os.path.exists(cache):
        maps = loadmat(cache, "PriorMaps")
    else:
        cv2 = require_cv2()
        priors_list = _read_ob_prior_list(datapath, phase_gen)
        if not priors_list:
            raise ValueError(f"empty {phase_gen} split under {datapath}/txt: no videos "
                             "to build observed priors from")
        if not all(os.path.exists(p) for p in priors_list):
            make_mean_maps(datapath)
        maps = np.zeros((shape_r, shape_c, max(channels, len(priors_list))), np.uint8)
        for i, path in enumerate(priors_list):
            original = cv2.imread(path, 0)
            if original is None:
                raise FileNotFoundError(f"unreadable observed-prior map: {path}")
            maps[:, :, i] = padding(original, shape_r, shape_c, 1)
        if channels < len(priors_list):
            count = len(priors_list) // channels
            frames = channels * count
            tail_mean = np.mean(maps[:, :, frames - count:], axis=2)
            maps = np.mean(maps[:, :, :frames].reshape((shape_r, shape_c, channels, count)),
                           axis=3)
            maps[:, :, -1] = tail_mean
        maps = maps.astype(np.float32) / 255
        savemat(cache, {"PriorMaps": maps})
    if maps.shape[0] != shape_r or maps.shape[1] != shape_c:
        resized = np.zeros((shape_r, shape_c, maps.shape[2]), np.float32)
        for i in range(maps.shape[2]):
            resized[:, :, i] = padding(maps[:, :, i].astype(np.float32), shape_r, shape_c, 1)
        maps = resized
    return np.asarray(maps, np.float32)
