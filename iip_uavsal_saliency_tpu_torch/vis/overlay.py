"""JET-heatmap overlays: images, videos and single video frames (own copy
of `iip_uavsal_saliency_tpu/vis/overlay.py`).

The blend is `0.8 * (1 - m^0.8) * img + m * map_color`, fixation points
optionally dilated and burned to white, rescaled by the bare max and cast
to uint8. Videos are written with the DIVX codec, by default shrunk to at
most 1280x720. This is host code: cv2 is imported when a function is
called.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..data.letterbox import require_cv2, resize_fixation
from ..data.matio import loadmat
from ..utils.logging import get_logger

log = get_logger("vis")

EPS = 2.2204e-16


def _im2uint8(img: np.ndarray) -> np.ndarray:
    """Clamp to [0, 255], round half to even, cast to uint8."""
    if img.dtype == np.uint8:
        return img
    return np.rint(np.clip(img, 0, 255)).astype(np.uint8)


def _rescale255(img: np.ndarray) -> np.ndarray:
    """`img / max(img) * 255` by the bare max (an epsilon in the divisor
    would move values that land on an x.5 rounding boundary down a level);
    an all-zero image is returned as it is."""
    m = np.max(img)
    return img / m * 255 if m > 0 else img


def _vid_ext(dataset: str) -> str:
    """The source videos' extension of a dataset."""
    d = dataset.upper()
    if d in ("CITIUS", "UAV2", "UAV2-TE"):
        return ".avi"
    if d in ("DHF1K-TE", "DHF1K"):
        return ".AVI"
    return ".mp4"


def _burn_fixations(cv2, overmap: np.ndarray, pts: np.ndarray) -> None:
    """Fixation points dilated by a 5x5 square, set to 1 in all channels."""
    dil = cv2.dilate(pts, np.ones((5, 5), np.uint8))
    overmap[np.repeat(dil[..., None], 3, 2) > 0.5] = 1


def heatmap_overlay(image: np.ndarray, heatmap: np.ndarray) -> np.ndarray:
    """The JET blend of `heatmap` over `image` (resized to the image's size
    where it differs), float in about [0, 1+]; callers rescale before
    writing."""
    cv2 = require_cv2()
    img = np.array(image, copy=True)
    hmap = np.array(heatmap, copy=True)
    if img.shape[:2] != hmap.shape[:2]:
        hmap = cv2.resize(hmap, (img.shape[1], img.shape[0]))
    hmap3 = np.repeat(hmap[..., None], 3, axis=2) if hmap.ndim == 2 else hmap
    if hmap3.dtype == np.uint8:
        map_color = cv2.applyColorMap(hmap3, cv2.COLORMAP_JET)
    else:
        map_color = cv2.applyColorMap(_im2uint8(_rescale255(hmap3)), cv2.COLORMAP_JET)
    img = img / (np.max(img) + EPS)
    hmap3 = hmap3 / (np.max(hmap3) + EPS)
    map_color = map_color / np.max(map_color)
    return 0.8 * (1 - hmap3 ** 0.8) * img + hmap3 * map_color


def visual_img(root_dir: str, sals_dir: str, method_names: Sequence[str],
               with_fix: int = 0) -> None:
    """Overlay each method's PNG maps (`<sals_dir>/<method>/*.png`) on the
    dataset's `images/*.jpg` into `<sals_dir>/<method>/Visual_color/`;
    `with_fix` burns in the `fixations/maps/*.mat` points. Existing
    outputs are skipped."""
    cv2 = require_cv2()
    imgs_dir = os.path.join(root_dir, "images")
    fixs_dir = os.path.join(root_dir, "fixations", "maps")
    for method in method_names:
        salmap_dir = os.path.join(sals_dir, method)
        out_path = os.path.join(salmap_dir, "Visual_color")
        os.makedirs(out_path, exist_ok=True)
        for name in sorted(f for f in os.listdir(salmap_dir) if f.endswith(".png")):
            file_name = name[:-4]
            outname = os.path.join(out_path, file_name + ".png")
            if os.path.exists(outname):
                continue
            img = cv2.imread(os.path.join(imgs_dir, file_name + ".jpg"), -1)
            salmap = cv2.imread(os.path.join(salmap_dir, name), -1)
            overmap = heatmap_overlay(img, salmap)
            fixname = os.path.join(fixs_dir, file_name + ".mat")
            if with_fix and os.path.exists(fixname):
                _burn_fixations(cv2, overmap, loadmat(fixname, "I"))
            cv2.imwrite(outname, _im2uint8(_rescale255(overmap)))


def _method_source(method: str, root_dir: str, sals_dir: str):
    """(maps directory, .mat key, file suffix) of a method; "GT" (any case)
    is the dataset's ground-truth fixMaps."""
    if method.lower() == "gt":
        return os.path.join(root_dir, "maps"), "fixMap", "_fixMaps.mat"
    return os.path.join(sals_dir, method), "salmap", ".mat"


def visual_vid(root_dir: str, sal_dir: str, dataset: str, method_names: Sequence[str],
               with_color: int = 0, with_fix: int = 0, small_out: bool = True) -> None:
    """Each method's `.mat` maps over the dataset's source videos, one DIVX
    `.mp4` per video under the maps' directory (`Visual_color_fix`,
    `Visual_color_map` or `Visual_gray`); `with_color` blends over the
    frames, else the gray maps; `with_fix` burns in the `_fixPts.mat`
    points; `small_out` caps the output at 1280x720. Existing outputs are
    skipped."""
    cv2 = require_cv2()
    vids_dir = os.path.join(root_dir, "Videos")
    fixs_dir = os.path.join(root_dir, "fixations", "maps")
    sals_dir = os.path.join(sal_dir, "Saliency")
    vid_ext = _vid_ext(dataset)
    for method in method_names:
        salmap_dir, sal_key, sal_suffix = _method_source(method, root_dir, sals_dir)
        if with_color:
            sub = "Visual_color_fix" if with_fix else "Visual_color_map"
        else:
            sub = "Visual_gray"
        out_path = os.path.join(salmap_dir, sub)
        os.makedirs(out_path, exist_ok=True)
        for name in sorted(f for f in os.listdir(salmap_dir) if f.endswith(".mat")):
            file_name = name[:-len(sal_suffix)]
            outname = os.path.join(out_path, file_name + ".mp4")
            if os.path.exists(outname):
                continue
            cap = cv2.VideoCapture(os.path.join(vids_dir, file_name + vid_ext))
            vid_w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            vid_h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            vid_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            fps = cap.get(cv2.CAP_PROP_FPS) or 30
            salmap = np.rint(loadmat(os.path.join(salmap_dir, name), sal_key)).astype(np.uint8)
            nframes = min(vid_frames, salmap.shape[3])
            fixname = os.path.join(fixs_dir, file_name + "_fixPts.mat")
            fixpts = None
            if with_fix and os.path.exists(fixname):
                fixpts = loadmat(fixname, "fixLoc")
                nframes = min(nframes, fixpts.shape[3])
            if small_out:
                scale = min(1280 / vid_w, 720 / vid_h)
                out_w, out_h = int(vid_w * scale), int(vid_h * scale)
            else:
                out_w, out_h = vid_w, vid_h
            writer = cv2.VideoWriter(outname, cv2.VideoWriter_fourcc("D", "I", "V", "X"), fps,
                                     (out_w, out_h), isColor=True)
            for i in range(nframes):
                isalmap = salmap[:, :, 0, i]
                if with_color:
                    ret, img = cap.read()
                    if not ret:
                        break
                    ratio = max(1, max(vid_w // 640, vid_h // 360))
                    img_small = cv2.resize(img, (vid_w // ratio, vid_h // ratio))
                    overmap = cv2.resize(heatmap_overlay(img_small, isalmap), (out_w, out_h))
                else:
                    overmap = np.repeat(isalmap[..., None], 3, 2) / 255
                    if overmap.shape[:2] != (out_h, out_w):
                        # a VideoWriter drops frames of another size
                        overmap = cv2.resize(overmap, (out_w, out_h))
                if fixpts is not None:
                    pts = fixpts[:, :, 0, i]
                    if small_out:
                        pts = resize_fixation(pts, out_h, out_w)
                    _burn_fixations(cv2, overmap, pts)
                writer.write(_im2uint8(_rescale255(overmap)))
            cap.release()
            writer.release()
            log.info("%s/%s: %d frames", method, file_name, nframes)


def visual_vid_frames(root_dir: str, sal_dir: str, dataset: str, method_names: Sequence[str],
                      frame_indices: Sequence[int] = (0,), with_color: int = 1,
                      with_fix: int = 0) -> None:
    """The frames `frame_indices` of each video as PNGs
    `<name>_f{index:05d}.png` (and with `with_color` the source frame as
    `..._frame.png`) under `<sal_dir>/Saliency/<method>/Visual_frames`, for
    "GT" too: never into the dataset's directory."""
    cv2 = require_cv2()
    vids_dir = os.path.join(root_dir, "Videos")
    fixs_dir = os.path.join(root_dir, "fixations", "maps")
    sals_dir = os.path.join(sal_dir, "Saliency")
    vid_ext = _vid_ext(dataset)
    for method in method_names:
        salmap_dir, sal_key, sal_suffix = _method_source(method, root_dir, sals_dir)
        out_path = os.path.join(sals_dir, method, "Visual_frames")
        os.makedirs(out_path, exist_ok=True)
        for name in sorted(f for f in os.listdir(salmap_dir) if f.endswith(sal_suffix)):
            file_name = name[:-len(sal_suffix)]
            salmap = np.rint(loadmat(os.path.join(salmap_dir, name), sal_key)).astype(np.uint8)
            fixname = os.path.join(fixs_dir, file_name + "_fixPts.mat")
            fixpts = loadmat(fixname, "fixLoc") if with_fix and os.path.exists(fixname) else None
            cap = cv2.VideoCapture(os.path.join(vids_dir, file_name + vid_ext))
            for fi in frame_indices:
                if fi >= salmap.shape[3]:
                    continue
                cap.set(cv2.CAP_PROP_POS_FRAMES, fi)
                ret, img = cap.read()
                if not ret:
                    continue
                frame = salmap[:, :, 0, fi]
                overmap = (heatmap_overlay(img, frame) if with_color
                           else np.repeat(frame[..., None], 3, 2) / 255)
                if fixpts is not None and fi < fixpts.shape[3]:
                    pts = fixpts[:, :, 0, fi]
                    if pts.shape != overmap.shape[:2]:
                        pts = resize_fixation(pts, overmap.shape[0], overmap.shape[1])
                    _burn_fixations(cv2, overmap, pts)
                cv2.imwrite(os.path.join(out_path, f"{file_name}_f{fi:05d}.png"),
                            _im2uint8(_rescale255(overmap)))
                if with_color:
                    imgname = os.path.join(out_path, f"{file_name}_f{fi:05d}_frame.png")
                    if not os.path.exists(imgname):
                        cv2.imwrite(imgname, img)
            cap.release()
