"""Stateful video saliency serving (counterpart of
`iip_uavsal_saliency_tpu/runners/infer.py`).

- `load_model_for_inference`: a `.ckpt` path or a JAX variables tree ->
  `UAVSal` with BatchNorm folded into the convs (the serving default), on
  the device.
- `predict_videos`: the per-group clip loop of the JAX `test_videos` over
  decoded, letterboxed uint8 videos: videos run V at a time in lock-step,
  clips of S = batch_size * time_dims frames carry the TWA state, ragged
  tails repeat the last frame (and are dropped), and every map is
  un-letterboxed to its video's native size as uint8 (H, W, 1, T).

Video decode and the `.mat` writer are not part of this module yet.
"""

from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.letterbox import im2uint8, postprocess_prediction
from ..device import resolve_device
from ..models.convert import from_jax_variables
from ..models.uavsal import UAVSal
from ..ops.fold import fold_conv_bn
from ..training.checkpoint import load_checkpoint


def load_model_for_inference(
    model_path_or_variables: Union[str, os.PathLike, Mapping[str, Any]],
    time_dims: int = 5,
    fold_bn: bool = True,
    device=None,
    fused_dwblock: bool = False,
) -> UAVSal:
    """The flagship `uavsal` model in eval form on `device` (CUDA by default).

    Loads an unfolded tree or one the JAX package folded alike. `fold_bn`
    folds every BatchNorm into the conv before it (`ops/fold.py::fold_conv_bn`),
    as serving does by default. `fused_dwblock` serves every DWBlock the
    fused kernel takes through it (`UAVSal(fused_dwblock=True)`)."""
    device = resolve_device(device)
    if isinstance(model_path_or_variables, (str, os.PathLike)):
        tree = load_checkpoint(os.fspath(model_path_or_variables))
    else:
        tree = model_path_or_variables
    model = UAVSal(time_dims=time_dims, fused_dwblock=fused_dwblock)
    model.load_state_dict(from_jax_variables(tree), strict=True)
    model.eval().requires_grad_(False)
    if fold_bn:
        fold_conv_bn(model)
    return model.to(device, memory_format=torch.channels_last)


def run_group(step, videos: Sequence[np.ndarray], clip_len: int,
              state: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Serve V videos in lock-step. `videos[i]` is (T_i, H, W, 3) uint8 with
    T_i a multiple of time_dims (0 for an empty slot); `step(x, state)`
    takes (V, clip_len, H, W, 3) uint8 clips. Returns each video's saliency
    (T_i, Ho, Wo) in f32 on the state's device, and the final state."""
    device = state.device
    v = len(videos)
    frame_shape = next((vid.shape[1:] for vid in videos if vid.shape[0]), None)
    totals = [vid.shape[0] for vid in videos]
    sals: List[Optional[torch.Tensor]] = [None] * v
    for start in range(0, max(totals), clip_len):
        clip = np.zeros((v, clip_len) + frame_shape, np.uint8)
        for i, vid in enumerate(videos):
            if totals[i] == 0:
                continue
            chunk = vid[start:start + clip_len]
            if chunk.shape[0] == 0:  # exhausted video: repeat its last frame
                chunk = np.repeat(vid[-1:], clip_len, 0)
            elif chunk.shape[0] < clip_len:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], clip_len - chunk.shape[0], 0)], 0)
            clip[i] = chunk
        out, state = step(torch.from_numpy(clip).to(device), state)
        for i in range(v):
            n_valid = min(clip_len, max(0, totals[i] - start))
            if n_valid:
                if sals[i] is None:
                    sals[i] = torch.empty((totals[i],) + tuple(out.shape[2:4]),
                                          dtype=torch.float32, device=device)
                sals[i][start:start + n_valid] = out[i, :n_valid, :, :, 0]
    empty = torch.zeros((0, 0, 0), dtype=torch.float32, device=device)
    return [s if s is not None else empty for s in sals], state


def predict_videos(
    step,
    model: UAVSal,
    videos: Sequence[np.ndarray],
    native_sizes: Sequence[Tuple[int, int]],
    batch_size: int = 4,
    time_dims: int = 5,
    videos_per_batch: int = 1,
) -> List[np.ndarray]:
    """uint8 (H, W, 1, T) saliency for each letterboxed uint8 video
    (T, H, W, 3), un-letterboxed to its (height, width) in `native_sizes`.

    Each video is cut to a multiple of `time_dims` frames. Groups of
    `videos_per_batch` videos share one clip loop with a fresh zero state;
    when there is more than one group a short final group is padded with
    empty videos, so every group runs at the same V, as in the JAX runner."""
    device = next(model.parameters()).device
    clip_len = batch_size * time_dims
    cut = [vid[: (vid.shape[0] // time_dims) * time_dims] for vid in videos]
    v_per = max(1, videos_per_batch)
    groups = [list(range(g0, min(g0 + v_per, len(cut)))) for g0 in range(0, len(cut), v_per)]
    results: List[np.ndarray] = []
    for idx in groups:
        members = [cut[i] for i in idx]
        if len(members) < v_per and len(groups) > 1:
            members += [members[0][:0]] * (v_per - len(members))
        h, w = members[0].shape[1:3]
        state = model.init_state(h, w, len(members), device=device)  # the step casts it
        sals, _ = run_group(step, members, clip_len, state)
        for i, sal in zip(idx, sals):
            height, width = native_sizes[i]
            if sal.shape[0] == 0:
                results.append(np.zeros((height, width, 1, 0), np.uint8))
                continue
            maps = im2uint8(postprocess_prediction(sal, height, width))
            results.append(maps.permute(1, 2, 0).unsqueeze(2).cpu().numpy())
    return results
