"""The letterbox and its inverse (counterparts of `iip_uavsal_saliency_tpu/
data/letterbox.py`: IMAGENET_MEAN/STD, `padding`, `resize_fixation`,
`padding_fixation`, `im2uint8`, `postprocess_prediction`).

`padding` letterboxes a decoded frame or map on the host with cv2, as the
JAX package does; cv2 is imported when it is called, and a machine without
it cannot decode. The un-letterbox postprocess runs in torch on the
saliency's device: the JAX package resizes with cv2 on the host, here the
same half-pixel bilinear resize (cv2 INTER_LINEAR) runs as two matmuls
(ops/resize.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_bilinear_half_pixel

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def require_cv2():
    """The cv2 module, or RuntimeError where OpenCV is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV (cv2) is required for video decode and the "
                           "host-side letterbox") from e
    return cv2


def padding(img: np.ndarray, shape_r: int = 480, shape_c: int = 640,
            channels: int = 3) -> np.ndarray:
    """Aspect-preserving resize (cv2 INTER_LINEAR) into a centered, zero
    padded (shape_r, shape_c[, channels]) frame of the input's dtype (the
    reference's uint8 buffer would zero float maps in [0, 1])."""
    cv2 = require_cv2()
    shape = (shape_r, shape_c) if channels == 1 else (shape_r, shape_c, channels)
    img_padded = np.zeros(shape, dtype=img.dtype)
    rows, cols = img.shape[:2]
    if rows / shape_r > cols / shape_c:
        new_cols = (cols * shape_r) // rows
        img = cv2.resize(img, (new_cols, shape_r))
        new_cols = min(new_cols, shape_c)
        off = (shape_c - new_cols) // 2
        img_padded[:, off:off + new_cols] = img[:, :new_cols]
    else:
        new_rows = (rows * shape_c) // cols
        img = cv2.resize(img, (shape_c, new_rows))
        new_rows = min(new_rows, shape_r)
        off = (shape_r - new_rows) // 2
        img_padded[off:off + new_rows, :] = img[:new_rows]
    return img_padded


def resize_fixation(img: np.ndarray, rows: int = 480, cols: int = 640) -> np.ndarray:
    """Resize a binary fixation map by remapping the points' coordinates,
    not by interpolation."""
    out = np.zeros((rows, cols), np.uint8)
    coords = np.argwhere(img)
    if coords.size:
        r = np.minimum(np.round(coords[:, 0] * (rows / img.shape[0])).astype(int), rows - 1)
        c = np.minimum(np.round(coords[:, 1] * (cols / img.shape[1])).astype(int), cols - 1)
        out[r, c] = 1
    return out


def padding_fixation(img: np.ndarray, shape_r: int = 480, shape_c: int = 640) -> np.ndarray:
    """Letterbox a binary fixation map by coordinate remap. As in the
    reference, a map already of the target size is returned unchanged (not
    binarized, not copied)."""
    if img.shape[0] == shape_r and img.shape[1] == shape_c:
        return img
    img_padded = np.zeros((shape_r, shape_c), np.uint8)
    rows, cols = img.shape[:2]
    if rows / shape_r > cols / shape_c:
        new_cols = (cols * shape_r) // rows
        rs = resize_fixation(img, rows=shape_r, cols=new_cols)
        new_cols = min(new_cols, shape_c)
        off = (shape_c - new_cols) // 2
        img_padded[:, off:off + new_cols] = rs[:, :new_cols]
    else:
        new_rows = (rows * shape_c) // cols
        rs = resize_fixation(img, rows=new_rows, cols=shape_c)
        new_rows = min(new_rows, shape_r)
        off = (shape_r - new_rows) // 2
        img_padded[off:off + new_rows, :] = rs[:new_rows]
    return img_padded


def im2uint8(img: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255], round half to even, cast to uint8."""
    if img.dtype == torch.uint8:
        return img
    return torch.round(img.clamp(0, 255)).to(torch.uint8)


def postprocess_prediction(pred: torch.Tensor, shape_r: int, shape_c: int) -> torch.Tensor:
    """Undo the letterbox of (..., ph, pw) saliency maps: upscale so the
    native (shape_r, shape_c) fits, center-crop, scale each map's max to 255."""
    ph, pw = pred.shape[-2], pred.shape[-1]
    if shape_r / ph > shape_c / pw:
        new_cols = (pw * shape_r) // ph
        pred = resize_bilinear_half_pixel(pred, shape_r, new_cols)
        off = (new_cols - shape_c) // 2
        img = pred[..., :, off:off + shape_c]
    else:
        new_rows = (ph * shape_c) // pw
        pred = resize_bilinear_half_pixel(pred, new_rows, shape_c)
        off = (new_rows - shape_r) // 2
        img = pred[..., off:off + shape_r, :]
    return img / img.amax(dim=(-2, -1), keepdim=True) * 255
