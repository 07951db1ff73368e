"""SALICON-style static images for the SRF-Net image stage (own copy of
`iip_uavsal_saliency_tpu/data/images.py`: `salicon_file_lists`,
`load_salicon_example`, `salicon_batches`).

Directory layout:

    <root>/<classes>/images/*.jpg|png        RGB stimuli
    <root>/<classes>/maps/*.png              blurred gaze maps (grayscale)
    <root>/<classes>/fixations/maps/*.mat    binary fixation points, key "I"

Images get a plain (anisotropic) cv2 resize to (in_h, in_w) and the
ImageNet normalization, maps a plain resize to (out_h, out_w) scaled to
[0, 1], fixation points the coordinate-remapped letterbox
(`padding_fixation`), so no fixation is lost to interpolation. Batches are
(B, H, W, 3) f32 images and (B, Ho, Wo, 2) targets ordered [map,
fixations], decoded a few batches ahead on a thread.

cv2 is imported when a file is decoded. `salicon_array_batches` batches
images and targets already in memory (uint8 images at the input size,
normalized by the train step on its device) in the order
`salicon_batches` gives for the same `RandomState` draw: how a machine
without cv2 trains the image stage.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .letterbox import IMAGENET_MEAN, IMAGENET_STD, padding_fixation, require_cv2
from .loaders import _prefetched
from .matio import loadmat

_IMG_EXT = (".jpg", ".jpeg", ".png")


def salicon_file_lists(root: str, classes: str = "train"
                       ) -> Tuple[List[str], List[str], List[str]]:
    """Sorted (images, maps, fixations) path lists; "test" has images only."""
    imgs_dir = os.path.join(root, classes, "images")
    imgs = sorted(os.path.join(imgs_dir, f) for f in os.listdir(imgs_dir)
                  if f.lower().endswith(_IMG_EXT))
    if classes == "test":
        return imgs, [], []
    maps_dir = os.path.join(root, classes, "maps")
    fixs_dir = os.path.join(root, classes, "fixations", "maps")
    maps = sorted(os.path.join(maps_dir, f) for f in os.listdir(maps_dir)
                  if f.lower().endswith(_IMG_EXT))
    fixs = sorted(os.path.join(fixs_dir, f) for f in os.listdir(fixs_dir) if f.endswith(".mat"))
    return imgs, maps, fixs


def load_salicon_example(img_path: str, map_path: Optional[str], fix_path: Optional[str],
                         iosize: Sequence[int] = (480, 640, 60, 80), normalize: bool = True
                         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One (image (H, W, 3) f32, target (Ho, Wo, 2) f32 or None) pair."""
    cv2 = require_cv2()
    in_h, in_w, out_h, out_w = iosize
    img = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"unreadable image: {img_path}")
    img = cv2.resize(img[:, :, ::-1], (in_w, in_h), interpolation=cv2.INTER_LINEAR)
    img = img.astype(np.float32) / 255.0
    if normalize:
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
    if map_path is None:
        return img, None
    gt_map = cv2.imread(map_path, cv2.IMREAD_GRAYSCALE)
    gt_map = cv2.resize(gt_map, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    gt_map = gt_map.astype(np.float32) / 255.0
    gt_fix = padding_fixation(np.asarray(loadmat(fix_path, "I")), out_h, out_w)
    return img, np.stack([gt_map, gt_fix.astype(np.float32)], axis=-1)


def batch_indices(n: int, batch_size: int, shuffle: bool, drop_last: bool,
                  rng: Optional[np.random.RandomState] = None) -> List[np.ndarray]:
    """The examples of each batch: 0..n-1, shuffled in place by `rng` (the
    global numpy generator when None), cut into runs of `batch_size`, a
    short last run dropped with `drop_last`."""
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)
    return [order[s:s + batch_size] for s in range(0, n, batch_size)
            if not (drop_last and s + batch_size > n)]


def salicon_batches(root: str, classes: str = "train",
                    iosize: Sequence[int] = (480, 640, 60, 80), batch_size: int = 4,
                    shuffle: Optional[bool] = None, drop_last: bool = False,
                    rng: Optional[np.random.RandomState] = None, prefetch: int = 2
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(images (B, H, W, 3) f32, targets (B, Ho, Wo, 2) f32) batches of a
    split; `shuffle` defaults to `classes == "train"`. Unequal image, map
    and fixation lists raise ValueError."""
    imgs, maps, fixs = salicon_file_lists(root, classes)
    if len(maps) != len(imgs) or len(fixs) != len(imgs):
        raise ValueError(f"mismatched SALICON lists: {len(imgs)} images, {len(maps)} maps, "
                         f"{len(fixs)} fixations")
    if shuffle is None:
        shuffle = classes == "train"

    def make_batch(idx):
        pairs = [load_salicon_example(imgs[i], maps[i], fixs[i], iosize) for i in idx]
        return np.stack([x for x, _ in pairs]), np.stack([y for _, y in pairs])

    yield from _prefetched(batch_indices(len(imgs), batch_size, shuffle, drop_last, rng),
                           make_batch, prefetch)


def salicon_array_batches(images: np.ndarray, targets: np.ndarray, batch_size: int = 4,
                          shuffle: bool = False, drop_last: bool = False,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """`salicon_batches` over arrays in memory: uint8 images (N, H, W, 3)
    at the input size and f32 targets (N, Ho, Wo, 2) [map, fixations],
    batched in the order the file entry gives for the same `rng` draw."""
    if len(images) != len(targets):
        raise ValueError(f"mismatched SALICON arrays: {len(images)} images, "
                         f"{len(targets)} targets")
    for idx in batch_indices(len(images), batch_size, shuffle, drop_last, rng):
        yield images[idx], np.asarray(targets[idx], np.float32)
