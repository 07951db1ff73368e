"""Video decode and the host-side letterbox of its frames (own copy of
`iip_uavsal_saliency_tpu/data/video.py`: `_read_frames`, `decode_video`,
`preprocess_videos`).

Frames stay uint8 through the letterbox: the clips go to the card as uint8
and are normalized there (serving/steps.py). cv2 is imported when a
function is called; without it they raise RuntimeError.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .letterbox import IMAGENET_MEAN, IMAGENET_STD, padding, require_cv2

# the first buffer is sized from the header's frame count, but never past
# this many bytes: a corrupt header must not drive the allocation
_FIRST_BUFFER_BYTES = 4 << 30
# slack past which a trimmed buffer is copied, so the oversized base is freed
_SLACK_BYTES = 256 << 20


def _read_frames(cap, max_frames: float,
                 transform: Callable[[np.ndarray], np.ndarray]) -> Tuple[Optional[np.ndarray], int]:
    """Decode until `cap.read()` fails (or `max_frames`), each frame through
    `transform`, into one buffer. The header's frame count is a hint, not a
    bound: a header that undercounts grows the buffer by doubling (toward the
    header's count while that is still ahead), one that overcounts is
    trimmed (with a copy when the slack is 2x or more than 256 MB). No frame
    is invented and none is dropped. Returns (frames or None, n)."""
    cv2 = require_cv2()
    header_n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    n = 0
    buf = None
    while n < max_frames:
        ret, frame = cap.read()
        if not ret:
            break
        f = transform(frame)
        if buf is None:
            hint = int(min(header_n, max_frames)) if header_n > 0 else 0
            cap_frames = max(1, _FIRST_BUFFER_BYTES // max(f.nbytes, 1))
            buf = np.empty((min(hint, cap_frames),) + f.shape, f.dtype)
        if n == buf.shape[0]:
            new_n = max(2 * n, 16)
            if header_n > n:
                new_n = max(min(new_n, int(min(header_n, max_frames))), n + 1)
            grown = np.empty((new_n,) + f.shape, f.dtype)
            grown[:n] = buf
            buf = grown
        buf[n] = f
        n += 1
    if buf is None:
        return None, 0
    slack_bytes = (buf.shape[0] - n) * buf[0].nbytes
    if n * 2 < buf.shape[0] or slack_bytes > _SLACK_BYTES:
        return buf[:n].copy(), n
    return buf[:n], n


def decode_video(path: str, max_frames: float = float("inf")) -> Tuple[np.ndarray, int, int, int]:
    """Every frame (BGR uint8): (frames (T, H, W, 3), n, height, width)."""
    cv2 = require_cv2()
    cap = cv2.VideoCapture(path)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    try:
        frames, n = _read_frames(cap, max_frames, lambda f: f)
    finally:
        cap.release()
    if frames is None:
        frames = np.zeros((0, height, width, 3), np.uint8)
    return frames, n, height, width


def preprocess_videos(path: str, shape_r: int, shape_c: int, frames: float = float("inf"),
                      mode: str = "RGB", normalize: bool = False):
    """Decode and letterbox to (T, shape_r, shape_c, 3) in RGB (or BGR)
    order: uint8, or with `normalize` float32 standardized by the ImageNet
    mean and std (the serving path normalizes on the card instead). Returns
    (frames, nframes, height, width) with the video's native size."""
    if mode not in ("RGB", "BGR"):
        raise ValueError(mode)
    cv2 = require_cv2()
    cap = cv2.VideoCapture(path)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    try:
        ims, nframes = _read_frames(cap, frames, lambda f: padding(f, shape_r, shape_c, 3))
    finally:
        cap.release()
    if ims is None:
        ims = np.zeros((0, shape_r, shape_c, 3), np.uint8)
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    if mode == "RGB":
        ims = ims[:, :, :, [2, 1, 0]]  # a copy: the clip loop reads contiguous frames
    else:
        mean, std = mean[::-1], std[::-1]
    if normalize:
        ims = (ims.astype(np.float32) / 255.0 - mean) / std
    return ims, nframes, height, width
