"""Center-bias Gaussian priors (own copy of
`iip_uavsal_saliency_tpu/data/priors.py::gaussian_priors` and the min-max
normalization of `get_gauss_priors`), computed analytically: no `.mat`
cache is read or written."""

from __future__ import annotations

import numpy as np

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
