"""Bilinear resizes as two small matmuls, `out = A_h @ img @ A_w^T`.

Counterpart of `iip_uavsal_saliency_tpu/ops/resize.py`, with its own copy of
the interpolation matrices:

- align_corners=True (`F.interpolate(..., align_corners=True)` in the
  reference model): `src = dst * (in - 1) / (out - 1)`;
- half-pixel (`cv2.resize(..., INTER_LINEAR)` in the reference
  postprocess): `src = (dst + 0.5) * in / out - 0.5`, clamped at the edges.

Inputs are (..., H, W): NCHW activations or stacks of 2-D maps. On a
spatial mesh (`parallel.spatial.over`) the align-corners resize takes a
band of an NCHW map of `height` rows and gives its band of the output: the
rows of A_h for the band, times the input rows those rows touch (fetched by
`parallel.spatial.rows`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel import spatial


@lru_cache(maxsize=128)
def interp_matrix_align_corners(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 bilinear matrix, align_corners=True."""
    a = np.zeros((n_out, n_in), np.float64)
    if n_out == 1 or n_in == 1:
        a[:, 0] = 1.0
        return a
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - lo
    a[np.arange(n_out), lo] = 1.0 - frac
    a[np.arange(n_out), lo + 1] += frac
    return a


@lru_cache(maxsize=128)
def interp_matrix_half_pixel(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 bilinear matrix, half-pixel (cv2 INTER_LINEAR)."""
    a = np.zeros((n_out, n_in), np.float64)
    if n_in == 1:
        a[:, 0] = 1.0
        return a
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - lo
    a[np.arange(n_out), lo] = 1.0 - frac
    a[np.arange(n_out), lo + 1] += frac
    return a


# (kind, n_in, n_out, dtype, device) -> the matrix on that device
_MATRICES: Dict[tuple, torch.Tensor] = {}


def _matrix(kind: str, n_in: int, n_out: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    key = (kind, n_in, n_out, dtype, device)
    a = _MATRICES.get(key)
    if a is None:
        build = (interp_matrix_align_corners if kind == "align_corners"
                 else interp_matrix_half_pixel)
        # a normal tensor even when first made by a serving step under
        # inference_mode: the cache hands the same one to a train step later;
        # in memory of its own, not the cached array's, which a trace's
        # constants at two call sites would otherwise share
        with torch.inference_mode(False):
            a = torch.from_numpy(build(n_in, n_out).copy()).to(device=device, dtype=dtype)
        if torch.compiler.is_compiling():
            return a  # a trace's (`torch.export`'s) tensor is fake: never cached
        _MATRICES[key] = a
    return a


def _resize(x: torch.Tensor, out_h: int, out_w: int, kind: str) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    ah = _matrix(kind, h, out_h, x.dtype, x.device)
    aw = _matrix(kind, w, out_w, x.dtype, x.device)
    return torch.matmul(torch.matmul(ah, x), aw.t())


def _resize_band(x: torch.Tensor, height: int, out_h: int, out_w: int) -> torch.Tensor:
    """The align-corners resize of this rank's band of a map of `height`
    rows to its band of `out_h` rows: each rank asks for the input rows
    that its rows of A_h touch."""
    axis = spatial.current()
    a = interp_matrix_align_corners(height, out_h)
    needs = []
    for q in range(axis.world):
        lo, hi = spatial.owned(out_h, axis.world, q)
        cols = np.nonzero(a[lo:hi].any(axis=0))[0]
        needs.append((int(cols[0]), int(cols[-1]) + 1) if len(cols) else (0, 0))
    xe = spatial.rows(x, height, needs)
    (lo, hi), (c0, c1) = spatial.owned(out_h, axis.world, axis.rank), needs[axis.rank]
    ah = torch.from_numpy(a[lo:hi, c0:c1].copy()).to(device=x.device, dtype=x.dtype)
    aw = _matrix("align_corners", x.shape[-1], out_w, x.dtype, x.device)
    return torch.matmul(torch.matmul(ah, xe), aw.t())


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int,
                                  height: Optional[int] = None) -> torch.Tensor:
    """Matches F.interpolate(mode='bilinear', align_corners=True). On a
    spatial mesh x is a band of a map of `height` rows (module docstring)."""
    if spatial.current() is not None:
        return _resize_band(x, height, out_h, out_w)
    return _resize(x, out_h, out_w, "align_corners")


def resize_bilinear_half_pixel(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Matches cv2.resize(..., INTER_LINEAR) on upsampling and mild
    downsampling (no area averaging)."""
    return _resize(x, out_h, out_w, "half_pixel")
