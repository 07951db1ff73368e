"""Static-image saliency to PNGs (counterpart of
`iip_uavsal_saliency_tpu/runners/infer_images.py`).

- `load_image_model`: a `.ckpt` path or a JAX tree of the image stage ->
  `SRFNetImage` in eval form on the device, BatchNorm folded into the
  convs as serving folds it.
- `predict_images`: the device part. A batch of uint8 images at the input
  size -> one uint8 map per image at its native size: the forward in f32,
  the bilinear resize back (`ops/resize.py`, cv2 INTER_LINEAR on
  upsampling), `/ (max + 2.2204e-16) * 255` and `im2uint8`.
- `test_images`: the host part. Every image of `<root>/<classes>/images`
  decoded and resized with cv2, in batches, to `<output>[/<method>]/
  <name>.png`, the layout `cli eval-img` reads; an image whose PNG exists
  is skipped.
"""

from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.images import salicon_file_lists
from ..data.letterbox import im2uint8, require_cv2
from ..device import resolve_device
from ..models.convert import from_jax_variables, table_of
from ..models.srfnet_image import SRFNetImage
from ..ops.fold import fold_conv_bn
from ..ops.layers import to_channels_last
from ..ops.resize import resize_bilinear_half_pixel
from ..training.checkpoint import load_checkpoint
from ..training.steps import _maybe_normalize
from ..utils.logging import get_logger

log = get_logger("infer_img")

EPS = 2.2204e-16


def load_image_model(model_path_or_variables: Union[str, os.PathLike, Mapping[str, Any]],
                     cnn_type: str = "mobilenet_v2", fold_bn: bool = True,
                     device=None) -> SRFNetImage:
    """`SRFNetImage` of `cnn_type` with the weights of an image-stage
    checkpoint (or JAX tree), in eval form on `device` (CUDA by default)."""
    device = resolve_device(device)
    model = SRFNetImage(cnn_type)
    if isinstance(model_path_or_variables, (str, os.PathLike)):
        tree = load_checkpoint(os.fspath(model_path_or_variables))
    else:
        tree = model_path_or_variables
    model.load_state_dict(from_jax_variables(tree, table_of(model)), strict=True)
    model.eval().requires_grad_(False)
    if fold_bn:
        fold_conv_bn(model)
    return to_channels_last(model, device)


@torch.inference_mode()
def predict_images(model: torch.nn.Module, x: Union[np.ndarray, torch.Tensor],
                   sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """uint8 (height, width) saliency of each image of x (B, H, W, 3) uint8
    at the model's input size, at its (height, width) in `sizes`; the work
    runs on the model's device, the maps come back to the host."""
    if len(sizes) != len(x):
        raise ValueError(f"{len(x)} images but {len(sizes)} sizes")
    device = next(model.parameters()).device
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = x.to(device)
    pred = model(_maybe_normalize(x))[..., 0].float()
    maps = []
    for p, (h, w) in zip(pred, sizes):
        sal = resize_bilinear_half_pixel(p, h, w)
        maps.append(im2uint8(sal / (sal.max() + EPS) * 255.0))
    return [m.cpu().numpy() for m in maps]


def test_images(data_root: str, output_path: str, model: torch.nn.Module,
                classes: str = "val", iosize: Tuple[int, int, int, int] = (480, 640, 60, 80),
                batch_size: int = 8, method_name: Optional[str] = None) -> None:
    """A saliency PNG for every image under `<data_root>/<classes>/images`,
    into `output_path[/method_name]`, served by `model` (from
    `load_image_model`) on its device."""
    cv2 = require_cv2()
    if method_name:
        output_path = os.path.join(output_path, method_name)
    os.makedirs(output_path, exist_ok=True)
    imgs, _, _ = salicon_file_lists(data_root, classes)
    in_h, in_w = iosize[0], iosize[1]
    batch, names, sizes = [], [], []

    def flush():
        if batch:
            for sal, name in zip(predict_images(model, np.stack(batch), sizes), names):
                cv2.imwrite(os.path.join(output_path, name + ".png"), sal)
        batch.clear()
        names.clear()
        sizes.clear()

    done = 0
    for img_path in imgs:
        name = os.path.splitext(os.path.basename(img_path))[0]
        if os.path.exists(os.path.join(output_path, name + ".png")):
            continue
        raw = cv2.imread(img_path, cv2.IMREAD_COLOR)
        if raw is None:
            raise IOError(f"unreadable image: {img_path}")
        batch.append(cv2.resize(raw[:, :, ::-1], (in_w, in_h), interpolation=cv2.INTER_LINEAR))
        names.append(name)
        sizes.append(raw.shape[:2])
        done += 1
        if len(batch) == batch_size:
            flush()
    flush()
    log.info("%s: %d images predicted -> %s", classes, done, output_path)
