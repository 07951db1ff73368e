"""Frame normalization constants and the un-letterbox postprocess, in torch
on the frames' device (counterparts of `iip_uavsal_saliency_tpu/data/
letterbox.py`: IMAGENET_MEAN/STD, `im2uint8`, `postprocess_prediction`).

The JAX package resizes with cv2 on the host; here the same half-pixel
bilinear resize (cv2 INTER_LINEAR) runs as two matmuls (ops/resize.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_bilinear_half_pixel

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


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
