"""Stateful video saliency serving (counterpart of
`iip_uavsal_saliency_tpu/runners/infer.py`).

- `load_model_for_inference`: a `.ckpt` path or a JAX variables tree ->
  the zoo model of `model_name` (`UAVSal`, `UAVSalLSTM`, or another
  behind its `ZooModelAdapter`) with BatchNorm folded into the convs (the
  serving default), on the device.
- `test_videos`: every video of a directory to a `.mat` file
  `{'salmap': (H, W, 1, T) uint8}` at its native size; resumable (a video
  whose `.mat` exists is skipped), group g+1 decoded on a worker thread
  while group g is served.
- `predict_videos`: the same clip loop over videos already decoded and
  letterboxed (uint8 (T, H, W, 3)), returning the maps.

The clip loop (`run_group`) serves V videos in lock-step: clips of
S = batch_size * time_dims frames carry the TWA state, a ragged tail
repeats the last frame (and its maps are dropped), and each group starts
from a zero state. On the card it is the JAX runner's 3-stage pipeline:
while step k runs, clip k+1 is built on the host into one of two pinned
buffers and copied to the card on a copy stream, and clip k-1's maps,
un-letterboxed and cast to uint8 on the card right after its step, come
back into pinned memory and are written into the video's array. The maps
are un-letterboxed per clip, never per video: a long video at a large
native size never has more than a clip of full-size maps on the card. The
loop serves the step it is given; `test_videos` gives it the step
replayed from a CUDA graph (`serving/steps.py::graph_step`) on the card,
as the JAX runner serves one compiled program.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.letterbox import im2uint8, postprocess_prediction
from ..data.matio import savemat
from ..data.priors import get_gauss_priors, get_ob_priors
from ..data.video import preprocess_videos
from ..device import resolve_device
from ..models.adapters import build_adapted_model
from ..models.convert import from_jax_variables, table_of
from ..ops.fold import fold_conv_bn
from ..ops.layers import to_channels_last
from ..parallel.mesh import RankGroup, rank0_first
from ..serving.steps import graph_step, make_baked_infer_step, make_infer_step
from ..training.checkpoint import load_checkpoint
from ..utils.logging import get_logger

log = get_logger("infer")

VIDEO_EXTS = (".avi", ".AVI", ".mp4")


def load_model_for_inference(
    model_path_or_variables: Union[str, os.PathLike, Mapping[str, Any]],
    time_dims: int = 5,
    fold_bn: bool = True,
    device=None,
    fused_dwblock: bool = False,
    cnn_type: str = "mobilenet_v2",
    num_stblock: int = 2,
    bias_type: Sequence[int] = (1, 1, 1),
    s2d_stem: bool = False,
    model_name: str = "uavsal",
    st_type: str = "st",
    planes: int = 256,
) -> torch.nn.Module:
    """The zoo model `model_name` of this configuration in eval form on
    `device` (CUDA by default): `UAVSal` for "uavsal", `UAVSalLSTM` for
    "uavsal_lstm", else the model behind a `ZooModelAdapter`
    (`build_adapted_model(filter_kwargs=True)`: each class takes the keywords it has; `st_type` is read by
    `uavsal_stblocks_type` alone), as the JAX loader builds it.

    Loads an unfolded tree or one the JAX package folded alike, through the
    model's own bridge table. `fold_bn` folds every BatchNorm into the conv
    before it (`ops/fold.py::fold_conv_bn`, 3-D convs included), as serving
    does by default. `fused_dwblock` serves every DWBlock the fused kernel
    takes through it (`UAVSal(fused_dwblock=True)`). `s2d_stem`
    (MobileNetV2 only) computes the stem as its space-to-depth form from
    the same weights. Both are the flagship's: another `model_name` with
    either raises NotImplementedError, as the JAX loader refuses
    `s2d_stem` there (the JAX zoo has no fused dwBlock path). `planes` is
    the model's width (`models/uavsal.py`)."""
    if model_name.lower() != "uavsal" and (s2d_stem or fused_dwblock):
        raise NotImplementedError(
            f"s2d_stem and fused_dwblock are only implemented for the flagship 'uavsal' "
            f"model (got model_name={model_name!r})")
    device = resolve_device(device)
    # built first: an unknown name raises KeyError before any file is read
    model = build_adapted_model(model_name, filter_kwargs=True, time_dims=time_dims,
                                cnn_type=cnn_type, num_stblock=num_stblock,
                                bias_type=bias_type, st_type=st_type,
                                fused_dwblock=fused_dwblock, s2d_stem=s2d_stem, planes=planes)
    if isinstance(model_path_or_variables, (str, os.PathLike)):
        tree = load_checkpoint(os.fspath(model_path_or_variables))
    else:
        tree = model_path_or_variables
    model.load_state_dict(from_jax_variables(tree, table_of(model)), strict=True)
    model.eval().requires_grad_(False)
    if fold_bn:
        fold_conv_bn(model)
    return to_channels_last(model, device)


def run_group(step, videos: Sequence[np.ndarray], clip_len: int, state: torch.Tensor,
              native_sizes: Sequence[Tuple[int, int]]) -> Tuple[List[np.ndarray], torch.Tensor]:
    """Serve V videos in lock-step. `videos[i]` is (T_i, H, W, 3) uint8 with
    T_i a multiple of time_dims (0 for an empty slot); `step(x, state)`
    takes (V, clip_len, H, W, 3) uint8 clips on the state's device. Returns
    each video's uint8 saliency (height, width, 1, T_i) at its
    `native_sizes[i]`, and the final state.

    The maps are stored frame-major, as a `.mat` file holds them (`savemat`
    writes the transpose), and returned as (H, W, 1, T) views of that."""
    totals = [vid.shape[0] for vid in videos]
    stores = [np.empty((t, 1, w, h), np.uint8) for t, (h, w) in zip(totals, native_sizes)]
    results = [m.transpose(3, 2, 1, 0) for m in stores]
    starts = list(range(0, max(totals, default=0), clip_len))
    if not starts:
        return results, state
    device = state.device
    v = len(videos)
    on_card = device.type == "cuda"
    frame_shape = next(vid.shape[1:] for vid in videos if vid.shape[0])
    # two clips in flight each way: host buffers (pinned on the card's
    # host), the clips on the device, the uint8 maps coming back
    inbox = [torch.empty((v, clip_len) + frame_shape, dtype=torch.uint8, pin_memory=on_card)
             for _ in range(2)]
    clips = [torch.empty_like(b, device=device) for b in inbox] if on_card else inbox
    outbox = [[torch.empty((clip_len, w, h), dtype=torch.uint8, pin_memory=on_card)
               for h, w in native_sizes] for _ in range(2)]
    if on_card:
        # the step and the postprocess run on the current stream, the copies
        # to and from the card each on a stream of their own beside it
        compute = torch.cuda.current_stream(device)
        copier, returner = torch.cuda.Stream(device), torch.cuda.Stream(device)
        # sent[b]: inbox[b] is on the card; used[b]: the step that reads
        # clips[b] is issued; back[b]: outbox[b] holds its clip's maps
        sent, used, back = ([torch.cuda.Event() for _ in range(2)] for _ in range(3))

    def valid(i, start):
        return min(clip_len, max(0, totals[i] - start))

    def ship(k):
        """Build clip k on the host and start its copy to the card."""
        b, start = k % 2, starts[k]
        if on_card:
            sent[b].synchronize()  # inbox[b]'s copy of clip k-2 has left
        buf = inbox[b].numpy()
        for i, vid in enumerate(videos):
            n = valid(i, start)
            if totals[i] == 0:  # an empty slot: zero frames, no maps
                buf[i] = 0
            elif n == 0:  # an exhausted video repeats its last frame
                buf[i] = vid[-1]
            else:
                buf[i, :n] = vid[start:start + n]
                buf[i, n:] = vid[start + n - 1]
        if on_card:
            with torch.cuda.stream(copier):
                copier.wait_event(used[b])  # the step of clip k-2 has read clips[b]
                clips[b].copy_(inbox[b], non_blocking=True)
                sent[b].record(copier)

    def drain(k):
        """Write clip k's maps, back in outbox[k % 2], into the videos' arrays."""
        b, start = k % 2, starts[k]
        if on_card:
            back[b].synchronize()
        for i in range(v):
            n = valid(i, start)
            if n:
                stores[i][start:start + n, 0] = outbox[b][i][:n].numpy()

    ship(0)
    for k, start in enumerate(starts):
        b = k % 2
        if on_card:
            compute.wait_event(sent[b])
        out, state = step(clips[b], state)
        if on_card:
            used[b].record(compute)
        # un-letterbox clip k now, before the next step may overwrite `out`
        maps = {}
        for i, (height, width) in enumerate(native_sizes):
            n = valid(i, start)
            if n:
                sal = im2uint8(postprocess_prediction(out[i, :n, :, :, 0], height, width))
                maps[i] = sal.transpose(1, 2).contiguous()
        if on_card:
            returner.wait_stream(compute)
            with torch.cuda.stream(returner):
                for i, sal in maps.items():
                    outbox[b][i][:len(sal)].copy_(sal, non_blocking=True)
                    sal.record_stream(returner)
                back[b].record(returner)
        else:
            for i, sal in maps.items():
                outbox[b][i][:len(sal)].copy_(sal)
        if k + 1 < len(starts):
            ship(k + 1)
        if k:
            drain(k - 1)
    drain(len(starts) - 1)
    return results, state


def _zero_state(model, height: int, width: int, n: int) -> torch.Tensor:
    """The zero state of V=n videos: in the model's dtype and on its device,
    or an artifact's (`runners/export.py::ExportedServing`) own."""
    if isinstance(model, torch.nn.Module):
        param = next(model.parameters())
        return model.init_state(height, width, n, dtype=param.dtype, device=param.device)
    return model.init_state(height, width, n)


def _serve_group(step, model, members: Sequence[np.ndarray],
                native_sizes: Sequence[Tuple[int, int]], clip_len: int,
                pad_to: int) -> List[np.ndarray]:
    """One group through `run_group` from a zero state (`_zero_state`),
    padded with empty videos to `pad_to` so that every group runs at the
    same V. Returns the members' maps."""
    n = len(members)
    members = list(members) + [members[0][:0]] * (pad_to - n)
    native_sizes = list(native_sizes) + [(1, 1)] * (pad_to - n)
    h, w = members[0].shape[1:3]
    state = _zero_state(model, h, w, len(members))
    maps, _ = run_group(step, members, clip_len, state, native_sizes)
    return maps[:n]


def predict_videos(
    step,
    model,
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
    empty videos, so every group runs at the same V, as in the JAX runner.
    `step` is served as it is given: pass `graph_step(step)` to replay it
    from a CUDA graph, as `test_videos` does. `model` gives the zero state:
    the served model, or an artifact (`runners/export.py::ExportedServing`)
    whose step `step` is."""
    clip_len = batch_size * time_dims
    cut = [vid[: (vid.shape[0] // time_dims) * time_dims] for vid in videos]
    v_per = max(1, videos_per_batch)
    groups = [list(range(g0, min(g0 + v_per, len(cut)))) for g0 in range(0, len(cut), v_per)]
    results: List[np.ndarray] = []
    for idx in groups:
        results += _serve_group(step, model, [cut[i] for i in idx],
                               [native_sizes[i] for i in idx], clip_len,
                               v_per if len(groups) > 1 else len(idx))
    return results


def test_videos(
    input_path: str,
    output_path: str,
    model,
    iosize: Tuple[int, int, int, int] = (360, 640, 45, 80),
    batch_size: int = 4,
    time_dims: int = 5,
    bias_type: Sequence[int] = (1, 1, 1),
    save_frames: float = float("inf"),
    train_data_dir: str = "",
    dataset: str = "",
    priors_cache_dir: str = "",
    method_name: Optional[str] = None,
    videos_per_batch: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    infer_step=None,
    bake_params: bool = True,
    group: Optional[RankGroup] = None,
) -> List[str]:
    """Saliency for every video in `input_path` (sorted `*.avi`, `*.AVI`,
    `*.mp4`), one `<name>.mat` each under `output_path[/method_name]`
    (the paths written are returned):
    `{'salmap': (H, W, 1, min(T, save_frames))}` uint8 at the video's
    native size, T its decoded frames cut to a multiple of `time_dims`.

    `model` is a zoo model as `load_model_for_inference` returns it, on the
    device to serve on (CUDA unless `device="cpu"` was asked for there); it
    is taken over as `make_baked_infer_step` says, and cast to
    `compute_dtype` (None: f32). The Gaussian priors are analytic, the
    observed ones come from `train_data_dir`'s training split (cached in
    `priors_cache_dir`); only the priors `bias_type` switches on are
    built, and it must be the model's where the model has priors (a model
    without them is served them and ignores them, as in the JAX runner).
    A video whose `.mat` exists is
    skipped; one shorter than `time_dims` gets an empty (H, W, 1, 0) map.
    Groups of `videos_per_batch` videos are served in lock-step while the
    next group is decoded on a worker thread.

    `infer_step` is a prebuilt `step(x, state)` to serve instead of the
    model's baked step (as the JAX runner's `infer_step=`): then `model` is
    what gives its zero state, an artifact (`runners/export.py::
    ExportedServing`) whose priors are inside it, so `bias_type` must be (0,
    0, 0) and no prior is built. `bake_params=False` serves the
    argument-passing step (`serving/steps.py::make_infer_step`) instead of
    the baked one, as the JAX runner does. On the card any of these steps
    is replayed from a CUDA graph.

    `group` (a `parallel.RankGroup`) serves data-parallel, as the JAX runner
    under a mesh's `data` axis: `videos_per_batch` must be a multiple of
    the world size, every rank takes rank 0's list of videos, a short last
    group is padded to `videos_per_batch` with empty videos, and each rank
    decodes and serves its contiguous rows of each group with its own step
    (no collective: each rank runs the single-device program on its V /
    world videos, as the JAX `shard_map` does) and writes its own videos'
    files; a rank whose rows are all padding writes nothing. Every rank
    returns once every file is written."""
    if infer_step is not None and any(bias_type):
        raise ValueError(f"bias_type={tuple(bias_type)} with a prebuilt step: its priors are "
                         "its own, pass (0, 0, 0)")
    model_bias = getattr(model, "bias_type", None)
    if model_bias is not None and tuple(int(bool(b)) for b in bias_type) != model_bias:
        raise ValueError(f"bias_type={tuple(bias_type)} but the model was built with "
                         f"{model_bias}")
    v_per = max(1, videos_per_batch)
    if group is not None and v_per % group.world:
        raise ValueError(f"videos_per_batch={v_per} must be a multiple of the mesh 'data' axis "
                         f"({group.world}) so the video batch shards evenly")
    if method_name:
        output_path = os.path.join(output_path, method_name)
    os.makedirs(output_path, exist_ok=True)
    shape_r, shape_c, shape_r_out, shape_c_out = iosize
    if infer_step is None:
        gauss = get_gauss_priors(shape_r_out, shape_c_out, 8) if bias_type[0] else None
        ob = rank0_first(group, lambda: get_ob_priors(
            train_data_dir, dataset, "train", shape_r_out, shape_c_out, 20,
            priors_cache_dir)) if bias_type[1] else None
        make = make_baked_infer_step if bake_params else make_infer_step
        step = make(model, gauss, ob, compute_dtype=compute_dtype)
        on_card = next(model.parameters()).device.type == "cuda"
    else:
        step, on_card = infer_step, model.device.type == "cuda"
    if on_card:
        step = graph_step(step)

    file_names = [
        f for f in sorted(os.listdir(input_path)) if f.endswith(VIDEO_EXTS)
        and not os.path.exists(os.path.join(output_path, os.path.splitext(f)[0] + ".mat"))
    ]
    if group is not None:  # one list for every rank, before any rank writes
        file_names = group.broadcast_object(file_names)
    clip_len = batch_size * time_dims
    rows = slice(None) if group is None else group.rows(v_per)

    def decode_group(members):
        decoded = []
        for name in members[rows]:
            frames, nframes, height, width = preprocess_videos(
                os.path.join(input_path, name), shape_r, shape_c, save_frames,
                mode="RGB", normalize=False)
            total = (nframes // time_dims) * time_dims
            if total == 0:
                log.warning("video %s decoded to %d frames (< time_dims=%d); "
                            "writing an empty salmap", name, nframes, time_dims)
            decoded.append((name, frames[:total], height, width))
        return decoded

    # decode group g+1 while group g is served (cv2 releases the GIL); up
    # to two decoded groups are held in host memory at once
    groups = [file_names[g0:g0 + v_per] for g0 in range(0, len(file_names), v_per)]
    # every group at the same V, and always under a group of ranks (each
    # rank's rows of a short last group padded to its share)
    pad_to = v_per if len(groups) > 1 or group is not None else None
    if group is not None:
        pad_to //= group.world
    pool = ThreadPoolExecutor(max_workers=1)
    future = None
    written: List[str] = []
    try:
        future = pool.submit(decode_group, groups[0]) if groups else None
        for gi, members in enumerate(groups):
            log.info("videos %d-%d/%d: %s", gi * v_per + 1, gi * v_per + len(members),
                     len(file_names), members[rows])
            t0 = time.time()
            decoded = future.result()
            future = pool.submit(decode_group, groups[gi + 1]) if gi + 1 < len(groups) else None
            if not decoded:  # this rank's rows of a short last group are all padding
                continue
            maps = _serve_group(step, model, [d[1] for d in decoded],
                               [(d[2], d[3]) for d in decoded], clip_len,
                               pad_to or len(decoded))
            for (name, frames, _, _), pred in zip(decoded, maps):
                keep = int(min(frames.shape[0], save_frames))
                written.append(os.path.join(output_path, os.path.splitext(name)[0] + ".mat"))
                savemat(written[-1], {"salmap": pred[:, :, :, :keep]})
            n_frames = sum(d[1].shape[0] for d in decoded)
            seconds = max(time.time() - t0, 1e-9)
            log.info("  %d frames in %.2fs (%.1f FPS end-to-end)", n_frames, seconds,
                     n_frames / seconds)
    finally:
        # cancel the queued decode on error, and report a decode that failed
        # just before the main loop raised, without waiting long on one that
        # is still running
        pool.shutdown(wait=False, cancel_futures=True)
        if future is not None:
            future.cancel()
            try:
                exc = future.exception(timeout=1)
            except Exception:  # still running, or cancelled: nothing to report
                exc = None
            if exc is not None:
                log.error("prefetch decode failed: %s", exc)
    if group is not None:  # every rank's files are written
        group.barrier()
    return written
