"""The training loop: whole videos as clips with the TWA state carried
(counterpart of `iip_uavsal_saliency_tpu/training/trainer.py`; of its
mesh, the `data` axis: `group`, below).

- per epoch, a train and a val phase over the txt split lists;
- per video: decode and letterbox every frame, cut to a multiple of
  time_dims, slice into clips of batch_size * time_dims frames (the last
  one at its true size), skip a clip with an empty ground-truth frame;
- per clip: the forward with the priors and the carried state, the loss,
  and in the train phase the backward and Adam (`training/steps.py`); the
  state is carried to the next clip as data (TBPTT) and starts at zero for
  each video;
- `videos_per_step` > 1: groups of that many videos advance in lock-step,
  one (V, S) batch a step with a state of V videos. The split is sorted
  (stably) by frame count first, so that like-length videos share a group;
  a ragged clip is right-padded with its last frame, a video out of clips
  repeats its last one (or a donor's), a short last group is filled with
  copies of its first video, all with the loss mask at 0 there. The
  repeated frames still move the carried state and feed train-mode
  BatchNorm's statistics, as in the JAX trainer;
- early stop on the val phase's mean loss with patience, a `_best`
  checkpoint before each epoch checkpoint, and `_final` with the best
  weights at the end; `resume` continues from the newest epoch checkpoint.
  An epoch checkpoint holds Adam's state in optax's layout
  (`training/optim.py::optax_tree`), so either package resumes a run the
  other began; the port's own layout of earlier versions is read too.

`group` (a `parallel.RankGroup`) trains data-parallel, the JAX trainer
under a mesh's `data` axis: `videos_per_step` must be a multiple of the
world size, every rank walks the same groups in the same order (rank 0's
shuffle and sort, broadcast), decodes only its rows of each group (and the
video a padded row repeats, where that is another rank's), and steps with
the group (`training/steps.py`); the losses, and so the epoch means and
early stop, are the whole batch's on every rank. Only rank 0 writes
checkpoints and metrics, and every rank waits for it before a resume reads
them and before `train` returns.

The clip loop takes videos as paths (decoded one video, or one group,
ahead on a worker thread; the frame count for the sort read from the
header) or as arrays already decoded (`videos=`; sorted by their frame
count), which is how a machine without OpenCV or h5py drives it. The model
is the zoo model `model_name` of the configuration (`cnn_type`,
`num_stblock`, `bias_type`, `s2d_stem`, `st_type`;
`models/adapters.py::build_adapted_model`, each class taking the keywords
it has, as the JAX trainer builds it). `remat` recomputes the forward in
the backward (`training/steps.py`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.lists import read_video_list
from ..data.loaders import _prefetched
from ..data.priors import get_gauss_priors, get_ob_priors
from ..device import resolve_device
from ..models.adapters import build_adapted_model
from ..models.convert import from_jax_variables, table_of, to_jax_variables
from ..models.srfnet_image import is_image_stage_variables, transfer_sfnet
from ..models.uavsal import init_model
from ..ops.fold import looks_folded
from ..ops.layers import to_channels_last
from ..parallel.mesh import RankGroup, rank0_first
from ..utils.logging import get_logger
from ..utils.metrics_log import MetricsLogger
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .losses import LOSSES, PER_FRAME
from .optim import load_optimizer_state, make_frozen_mask, make_optimizer, optax_tree
from .steps import create_train_state, make_eval_step, make_train_step

log = get_logger("trainer")

Clip = Tuple[np.ndarray, np.ndarray]
# an in-memory video: (name, frames (T, H, W, 3) uint8 RGB letterboxed,
# maps (T, Ho, Wo, 1) and fixations (T, Ho, Wo, 1), letterboxed)
ArrayVideo = Tuple[str, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters, with the JAX package's defaults (the reference's)."""

    method_name: str = "UAVSal"
    model_name: str = "uavsal"
    cnn_type: str = "mobilenet_v2"
    iosize: Tuple[int, int, int, int] = (360, 640, 45, 80)
    time_dims: int = 5
    num_stblock: int = 2
    st_type: str = "st"
    bias_type: Tuple[int, int, int] = (1, 1, 1)
    s2d_stem: bool = False       # MobileNetV2's stem as its exact space-to-depth form
    batch_size: int = 2          # clips per step, flattened into S
    epochs: int = 20
    learning_rate: float = 1e-4  # fine-tune recipe: 1e-5
    weight_decay: float = 5e-5   # fine-tune recipe: 5e-6
    freeze: Tuple[str, ...] = ("trunk/sfnet", "trunk/st_layer")  # JAX tree paths
    is_early_stop: bool = True
    max_patience: int = 4
    is_best_only: bool = False
    shuffle_train: bool = True
    max_train_frames: float = float("inf")
    max_val_frames: float = float("inf")
    videos_per_step: int = 1     # videos advancing in lock-step, one (V, S) batch a step
    resume: bool = False         # continue from the newest epoch checkpoint
    loss_name: str = "fu"        # a key of training.losses.LOSSES
    mixed_precision: bool = False  # bf16 compute, f32 masters, moments and BN stats
    remat: bool = False          # recompute the forward in the backward
    prefetch_decode: bool = True  # decode video k+1 while video k trains


def _masked_loss(loss_fn: Callable, group: Optional[RankGroup] = None):
    """`loss_fn` over (pred, [true | validity mask]): the per-frame terms
    weighted by the mask, so padded frames contribute nothing; on full clips
    the result is `loss_fn(pred, true)`. With `group`, this rank's share of
    the loss of every rank's batch, sum(per * w) / max(sum of w over every
    rank, 1): the count is all-reduced (no gradient through it), so the
    shares add up to the JAX package's loss over the sharded batch, whose
    gradient the train step then sums over the ranks."""
    per_frame = PER_FRAME.get(loss_fn)
    if per_frame is None:
        raise ValueError(f"no per-frame form registered for {loss_fn!r}; "
                         "add it to training.losses.PER_FRAME")

    def fn(pred, true_and_mask):
        true, mask = true_and_mask[..., :2], true_and_mask[..., 2]
        per = per_frame(pred, true)
        w = (mask[:, 0, 0] > 0.5).to(per.dtype)
        count = w.sum() if group is None else group.all_reduce(w.sum().detach())
        return (per * w).sum() / count.clamp(min=1.0)

    fn.group = group
    return fn


class _NoMetrics:
    """The metrics logger of a rank that does not write."""

    def scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _masked_off(y: np.ndarray) -> np.ndarray:
    """y with its loss mask (channel 2) at 0."""
    return np.concatenate([y[..., :2], np.zeros_like(y[..., 2:])], -1)


def clips_of(frames: np.ndarray, maps: np.ndarray, fixs: np.ndarray, clip_len: int,
             time_dims: int, pad_ragged: bool = False) -> List[Clip]:
    """A decoded video as training clips: the frames cut to a multiple of
    `time_dims` (and to the shortest of frames, maps and fixations), slices
    of `clip_len` frames with the last one at its true size, each
    (x uint8 (n, H, W, 3), y f32 (n, Ho, Wo, 3) = [map, fixations, mask]);
    a clip with a ground-truth frame that is all zeros is skipped.
    `pad_ragged` right-pads a short last clip to `clip_len` by repeating
    its last frame and ground truth, with the mask 0 on the padding (the
    lock-step path stacks clips of one shape)."""
    nframes = min(len(frames), len(maps), len(fixs))
    n = nframes // time_dims * time_dims
    frames = frames[:n]
    gaze = np.concatenate([maps[:n], fixs[:n]], axis=-1)
    clips = []
    for start in range(0, n, clip_len):
        x = frames[start:start + clip_len]
        y = gaze[start:start + clip_len].astype(np.float32)
        if not np.all(np.any(y, axis=(1, 2))):
            continue
        n_valid = len(x)
        if pad_ragged and n_valid < clip_len:
            pad = clip_len - n_valid
            x = np.concatenate([x, np.repeat(x[-1:], pad, 0)], 0)
            y = np.concatenate([y, np.repeat(y[-1:], pad, 0)], 0)
        mask = np.zeros(y.shape[:3] + (1,), np.float32)
        mask[:n_valid] = 1.0
        clips.append((x, np.concatenate([y, mask], -1)))
    return clips


class Trainer:
    """Train and val epochs with TBPTT over clips, on `device` (CUDA unless
    "cpu" is passed).

    `pre_variables`: a JAX `{params, batch_stats}` tree of the model to
    start from (warm start), or of the image stage (`SRFNetImage`, from
    `train_salicon`), whose `sfnet` is transplanted into the model drawn
    from seed 0 (`transfer_sfnet`); else the weights are drawn by
    `init_model` from seed 0. A tree with BatchNorm folded is refused.
    `ob_prior`: the (Ho, Wo, 20) observed-prior map; else it is built from
    the train split as the JAX trainer builds it (neither when `bias_type`
    leaves the stream off). `videos`: {"train": [...],
    "val": [...]} of `ArrayVideo`s to train on instead of the txt splits
    under `train_data_dir`. `group`: this rank of a data-parallel run
    (module docstring), on the group's device."""

    def __init__(self, config: TrainConfig, train_data_dir: str, dataset: str,
                 save_model_dir: str, ext: str = ".avi", pre_variables=None,
                 priors_cache_dir: str = "", device=None, ob_prior: Optional[np.ndarray] = None,
                 videos: Optional[Mapping[str, Sequence[ArrayVideo]]] = None,
                 group: Optional[RankGroup] = None):
        self.cfg = config
        self._nframes_cache: Dict[str, int] = {}
        self.group = group
        if group is not None and config.videos_per_step % group.world:
            raise ValueError(f"videos_per_step={config.videos_per_step} must be a multiple of "
                             f"the mesh 'data' axis ({group.world}) so the video batch shards "
                             "evenly")
        self.device = resolve_device(device) if group is None else group.device
        self.writes = group is None or group.is_first
        self.train_data_dir = train_data_dir
        self.ext = ext
        self.videos = videos
        self.model_dir = os.path.join(save_model_dir, config.method_name)
        os.makedirs(self.model_dir, exist_ok=True)
        self.prefix = os.path.join(self.model_dir, config.method_name)
        self.metrics = MetricsLogger(self.model_dir) if self.writes else _NoMetrics()

        model = build_adapted_model(config.model_name, filter_kwargs=True,
                                    time_dims=config.time_dims, cnn_type=config.cnn_type,
                                    num_stblock=config.num_stblock, bias_type=config.bias_type,
                                    s2d_stem=config.s2d_stem, st_type=config.st_type)
        self.table = table_of(model)
        _, _, out_r, out_c = config.iosize
        use_gauss, use_ob, _ = config.bias_type
        if use_ob and ob_prior is None:  # rank 0 builds the cache, the others read it
            ob_prior = rank0_first(group, lambda: get_ob_priors(
                train_data_dir, dataset, "train", out_r, out_c, 20, priors_cache_dir))
        self.gauss = (torch.from_numpy(get_gauss_priors(out_r, out_c, 8)).to(self.device)
                      if use_gauss else None)
        self.ob = (torch.as_tensor(np.asarray(ob_prior, np.float32)).to(self.device)
                   if use_ob else None)
        if pre_variables is not None and is_image_stage_variables(pre_variables):
            # the image stage's checkpoint: the video model drawn from seed 0,
            # then the trained neck transplanted into it
            init_model(model, torch.Generator().manual_seed(0))
            pre_variables = transfer_sfnet(pre_variables,
                                           to_jax_variables(model.state_dict(), self.table))
            log.info("image-stage checkpoint: its SRF-Net transplanted into the video model")
        if pre_variables is None:
            init_model(model, torch.Generator().manual_seed(0))
        else:
            sd = from_jax_variables(pre_variables, self.table)
            if looks_folded(sd):
                raise ValueError(
                    "pre_variables carry fold_batchnorm's signature (BN scale absorbed into "
                    "the convs); training on them would count the BN scale twice under live "
                    "batch statistics. Load the unfolded checkpoint instead.")
            model.load_state_dict(sd, strict=True)
        to_channels_last(model, self.device)
        mask = make_frozen_mask(model, config.freeze) if config.freeze else None
        optimizer = make_optimizer(model, config.learning_rate, config.weight_decay,
                                   trainable_mask=mask)
        self.state = create_train_state(model, optimizer)
        loss = _masked_loss(LOSSES[config.loss_name], group)
        self.train_step = make_train_step(
            self.state, loss, torch.bfloat16 if config.mixed_precision else None,
            remat=config.remat, group=group)
        self.eval_step = make_eval_step(model, loss, group)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    # ------------------------------------------------------------------ #

    def _video_clips(self, vid_path: str, map_path: str, fix_path: str,
                     max_frames: float, pad_ragged: bool = False) -> List[Clip]:
        """Decode and letterbox one video and its ground truth into clips."""
        from ..data.video import preprocess_videos, preprocess_vidfixs, preprocess_vidmaps

        shape_r, shape_c, out_r, out_c = self.cfg.iosize
        maps = preprocess_vidmaps(map_path, out_r, out_c, max_frames)
        fixs = preprocess_vidfixs(fix_path, out_r, out_c, max_frames)
        frames, nframes, _, _ = preprocess_videos(vid_path, shape_r, shape_c, max_frames)
        return self._clips(frames[:nframes], maps, fixs, pad_ragged)

    def _clips(self, frames, maps, fixs, pad_ragged: bool = False) -> List[Clip]:
        cfg = self.cfg
        return clips_of(frames, maps, fixs, cfg.batch_size * cfg.time_dims, cfg.time_dims,
                        pad_ragged)

    def _nframes(self, path: str) -> int:
        """The header's frame count of the video at `path`, probed once per
        path for all epochs and phases."""
        if path not in self._nframes_cache:
            from ..data.video import probe_nframes

            self._nframes_cache[path] = probe_nframes(path)
        return self._nframes_cache[path]

    def _phase_videos(self, phase: str, max_frames: float):
        """The phase's videos: (names, items, load, nframes), where
        `load(item, pad_ragged)` gives an item's clips and `nframes(item)`
        its frame count before the `max_frames` cut."""
        if self.videos is not None:
            items = list(self.videos.get(phase, ()))
            cut = None if max_frames == float("inf") else int(max_frames)

            def load_array(item, pad_ragged=False):
                _, f, m, x = item
                return self._clips(f[:cut], m[:cut], x[:cut], pad_ragged)

            return [name for name, *_ in items], items, load_array, lambda item: len(item[1])
        shuffle = self.cfg.shuffle_train if phase == "train" else False
        triples = list(zip(*read_video_list(self.train_data_dir, phase, shuffle=shuffle,
                                            ext=self.ext)))
        if self.group is not None:  # one shuffle for every rank
            triples = self.group.broadcast_object(triples)

        def load_file(triple, pad_ragged=False):
            return self._video_clips(*triple, max_frames, pad_ragged=pad_ragged)

        return ([os.path.basename(t[0]) for t in triples], triples, load_file,
                lambda triple: self._nframes(triple[0]))

    def _decode_iter(self, items: Sequence, load: Callable):
        """`load(item)` for each item, the next one decoded on a worker
        thread while this one steps (unless `prefetch_decode` is off)."""
        if not self.cfg.prefetch_decode or len(items) < 2:
            return (load(it) for it in items)
        return _prefetched(items, load, prefetch=1)

    def _step(self, phase: str, x, y, rnn_state):
        if phase == "train":
            loss, rnn_state = self.train_step(x, self.gauss, self.ob, rnn_state, y)
        else:
            loss, rnn_state = self.eval_step(x, self.gauss, self.ob, rnn_state, y)
        return float(loss), rnn_state

    def _logged_step(self, phase: str, x: np.ndarray, y: np.ndarray, rnn_state):
        """One step on a host batch (V, S, ...) moved to the card (uint8
        frames: the step normalizes there); the train loss is logged."""
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        loss, rnn_state = self._step(phase, x, y, rnn_state)
        if phase == "train":
            self.metrics.scalar("train/loss", loss, self.state.step)
        return loss, rnn_state

    def _run_videos(self, phase: str, names: Sequence[str], clip_lists) -> List[float]:
        """The clip loop over videos given as lists of clips, one video a
        step: the loss of every step."""
        shape_r, shape_c = self.cfg.iosize[:2]
        losses: List[float] = []
        for idx, clips in enumerate(clip_lists):
            log.info("%s video %d/%d: %s", phase, idx + 1, len(names), names[idx])
            rnn_state = self.model.init_state(shape_r, shape_c, 1, device=self.device)
            video_losses = []
            for x, y in clips:
                loss, rnn_state = self._logged_step(phase, x[None], y[None], rnn_state)
                video_losses.append(loss)
            if clips:
                log.info("  mean %s loss: %.4f", phase, sum(video_losses) / len(clips))
            losses += video_losses
        return losses

    def _run_lockstep(self, phase: str, names: Sequence[str], items: Sequence, load: Callable,
                      nframes: Callable, max_frames: float) -> List[float]:
        """Groups of `videos_per_step` videos in lock-step (the JAX
        trainer's `_run_epoch_multivideo`, module docstring): the loss of
        every step. An unreadable header keeps the list order. With a group
        this rank steps its rows of each group."""
        v_per = self.cfg.videos_per_step
        shape_r, shape_c = self.cfg.iosize[:2]
        rows = range(v_per)[self.group.rows(v_per)] if self.group is not None else range(v_per)
        order = list(range(len(items)))
        try:
            lengths = [min(nframes(item), max_frames) for item in items]
            order.sort(key=lengths.__getitem__)  # stable: a shuffle stays within equal lengths
        except Exception:  # noqa: BLE001 -- any probe failure keeps the list order
            log.warning("length bucketing skipped: the frame-count probe failed")
        if self.group is not None:  # one order for every rank
            order = self.group.broadcast_object(order)
        items, names = [items[i] for i in order], [names[i] for i in order]
        groups = [items[g0:g0 + v_per] for g0 in range(0, len(items), v_per)]

        def load_rows(members):
            """This rank's rows of a group, as clip lists: a row past a
            short last group repeats the group's first video, masked."""
            lists = {i: load(members[i], pad_ragged=True) for i in rows if i < len(members)}
            if rows[-1] >= len(members):
                first = lists[0] if 0 in lists else load(members[0], pad_ragged=True)
                lists.update({i: [(x, _masked_off(y)) for x, y in first]
                              for i in rows if i >= len(members)})
            return [lists[i] for i in rows]

        losses: List[float] = []
        for gi, clip_lists in enumerate(self._decode_iter(groups, load_rows)):
            g0 = gi * v_per
            log.info("%s videos %d-%d/%d: %s", phase, g0 + 1, g0 + len(groups[gi]), len(items),
                     ", ".join(names[g0:g0 + v_per]))
            counts = [0] * v_per
            for i, clips in zip(rows, clip_lists):
                counts[i] = len(clips)
            if self.group is not None:  # every row's clip count, on every rank
                counts = self.group.all_reduce(torch.tensor(counts)).tolist()
            if not any(counts):
                continue
            # out of clips: its last one again, or the first video's with clips
            first = next(i for i, n in enumerate(counts) if n)
            donor = (clip_lists[rows.index(first)] if first in rows
                     else load(groups[gi][first], pad_ragged=True) if not all(clip_lists)
                     else None)
            rnn_state = self.model.init_state(shape_r, shape_c, len(rows), device=self.device)
            for t in range(max(counts)):
                xs, ys = [], []
                for clips in clip_lists:
                    if t < len(clips):
                        x, y = clips[t]
                    else:  # out of clips: its last one again (a donor's if none), masked
                        x, y = (clips or donor)[-1]
                        y = _masked_off(y)
                    xs.append(x)
                    ys.append(y)
                loss, rnn_state = self._logged_step(phase, np.stack(xs), np.stack(ys), rnn_state)
                losses.append(loss)
        return losses

    def _run_epoch(self, phase: str) -> float:
        """The phase's mean loss over its steps, or inf when no step ran."""
        max_frames = self.cfg.max_train_frames if phase == "train" else self.cfg.max_val_frames
        names, items, load, nframes = self._phase_videos(phase, max_frames)
        if self.cfg.videos_per_step > 1:
            losses = self._run_lockstep(phase, names, items, load, nframes, max_frames)
        else:
            losses = self._run_videos(phase, names, self._decode_iter(items, load))
        if not losses:
            # 0.0 would win the early-stop comparison and keep these weights
            log.warning("%s epoch ran no step (empty split, or every clip skipped for "
                        "empty ground truth)", phase)
            return float("inf")
        return sum(losses) / len(losses)

    # ------------------------------------------------------------------ #

    def _snapshot(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and BatchNorm stats, copied to the host."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}

    def _epoch_payload(self, epoch: int, min_val_loss: float, num_patience: int) -> dict:
        """What the JAX trainer's epoch checkpoint holds, in its layout."""
        return {**to_jax_variables(self.model.state_dict(), self.table),
                "opt_state": optax_tree(self.model, self.state.optimizer, self.table,
                                        bool(self.cfg.freeze)),
                "step": np.asarray(self.state.step, np.int32), "epoch": epoch,
                "min_val_loss": min_val_loss, "num_patience": num_patience}

    def _resume(self):
        """(start epoch, min val loss, patience, best weights) from the
        newest epoch checkpoint, which either package wrote; the weights,
        BatchNorm stats, Adam's state and the step are loaded."""
        if self.group is not None:  # rank 0's last checkpoint is on disk
            self.group.barrier()
        latest = latest_checkpoint(self.model_dir, self.cfg.method_name)
        if not latest:
            return 0, float("inf"), 0, None
        ckpt = load_checkpoint(latest)
        self.model.load_state_dict(from_jax_variables(ckpt, self.table), strict=True)
        load_optimizer_state(self.model, self.state.optimizer, ckpt["opt_state"], self.table,
                             bool(self.cfg.freeze))
        self.state.step = int(ckpt["step"])
        best = None
        best_ckpt = f"{self.prefix}_best.ckpt"
        if os.path.exists(best_ckpt):
            best = dict(from_jax_variables(load_checkpoint(best_ckpt), self.table))
        log.info("resumed from %s (epoch %d)", latest, int(ckpt["epoch"]) + 1)
        return (int(ckpt["epoch"]) + 1, float(ckpt.get("min_val_loss", float("inf"))),
                int(ckpt.get("num_patience", 0)), best)

    def train(self):
        try:
            return self._train()
        finally:
            self.metrics.close()

    def _train(self):
        cfg = self.cfg
        min_val_loss, num_patience, start_epoch, best = float("inf"), 0, 0, None
        max_patience = cfg.max_patience if cfg.is_early_stop else cfg.epochs + 1
        if cfg.resume:
            start_epoch, min_val_loss, num_patience, best = self._resume()
        if best is None:
            best = self._snapshot()

        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            for phase in ("train", "val"):
                mean_loss = self._run_epoch(phase)
                log.info("epoch %d/%d mean %s loss: %.4f", epoch + 1, cfg.epochs, phase,
                         mean_loss)
                self.metrics.scalar(f"{phase}/mean_loss", mean_loss, epoch)
            # the early-stop metric is the last phase's (val) mean loss
            is_new_best = mean_loss < min_val_loss
            if is_new_best:
                best = self._snapshot()
                if self.writes and not cfg.is_best_only:
                    # the new best is on disk before the epoch checkpoint names
                    # its loss as min_val_loss, so a resume never points at
                    # weights that were not saved
                    save_checkpoint(f"{self.prefix}_best.ckpt",
                                    to_jax_variables(best, self.table))
            if self.writes and not cfg.is_best_only:
                save_checkpoint(f"{self.prefix}_{epoch:02d}_{mean_loss:.4f}.ckpt",
                                self._epoch_payload(epoch, min(mean_loss, min_val_loss),
                                                    0 if is_new_best else num_patience + 1))
            if is_new_best:
                min_val_loss, num_patience = mean_loss, 0
            else:
                num_patience += 1
                if num_patience >= max_patience:
                    log.info("early stop at epoch %d", epoch + 1)
                    break
            log.info("epoch time: %.1fs", time.time() - t0)

        if self.writes:
            save_checkpoint(f"{self.prefix}_final.ckpt", to_jax_variables(best, self.table))
        if self.group is not None:  # returns once the final checkpoint is on disk
            self.group.barrier()
        self.model.load_state_dict(best, strict=True)
        return self.state
