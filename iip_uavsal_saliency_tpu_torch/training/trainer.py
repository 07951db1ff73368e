"""The training loop: whole videos as clips with the TWA state carried
(counterpart of `iip_uavsal_saliency_tpu/training/trainer.py`, its
single-video path).

- per epoch, a train and a val phase over the txt split lists;
- per video: decode and letterbox every frame, cut to a multiple of
  time_dims, slice into clips of batch_size * time_dims frames (the last
  one at its true size), skip a clip with an empty ground-truth frame;
- per clip: the forward with the priors and the carried state, the loss,
  and in the train phase the backward and Adam (`training/steps.py`); the
  state is carried to the next clip as data (TBPTT) and starts at zero for
  each video;
- early stop on the val phase's mean loss with patience, a `_best`
  checkpoint before each epoch checkpoint, and `_final` with the best
  weights at the end; `resume` continues from the newest epoch checkpoint.

The clip loop takes videos as paths (decoded one video ahead on a worker
thread) or as arrays already decoded (`videos=`), which is how a machine
without OpenCV or h5py drives it. Configurations outside the port so far
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.lists import read_video_list
from ..data.priors import get_gauss_priors, get_ob_priors
from ..device import resolve_device
from ..models.convert import from_jax_variables, to_jax_variables
from ..models.uavsal import UAVSal, init_uavsal
from ..ops.fold import looks_folded
from ..utils.logging import get_logger
from ..utils.metrics_log import MetricsLogger
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .losses import LOSSES, PER_FRAME
from .optim import load_optimizer_tree, make_frozen_mask, make_optimizer, optimizer_tree
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
    videos_per_step: int = 1     # > 1: ROADMAP A.9b
    resume: bool = False         # continue from the newest epoch checkpoint
    loss_name: str = "fu"        # a key of training.losses.LOSSES
    mixed_precision: bool = False  # bf16 compute, f32 masters, moments and BN stats
    remat: bool = False          # ROADMAP A.9b
    prefetch_decode: bool = True  # decode video k+1 while video k trains


# what the port trains (models/uavsal.py), and the ROADMAP item of the rest
_FLAGSHIP = {"model_name": ("uavsal", "A.10"), "cnn_type": ("mobilenet_v2", "A.10"),
             "num_stblock": (2, "A.10"), "st_type": ("st", "A.10"),
             "bias_type": ((1, 1, 1), "A.10"), "videos_per_step": (1, "A.9b"),
             "remat": (False, "A.9b")}


def check_supported(cfg: TrainConfig) -> None:
    for key, (want, item) in _FLAGSHIP.items():
        value = getattr(cfg, key)
        if (tuple(value) if isinstance(value, (list, tuple)) else value) != want:
            raise NotImplementedError(
                f"{key}={value!r}: the port trains the flagship UAVSal, one video per "
                f"step, without remat ({key}={want!r}); this is ROADMAP {item}")


def _masked_loss(loss_fn: Callable):
    """`loss_fn` over (pred, [true | validity mask]): the per-frame terms
    weighted by the mask, so padded frames contribute nothing; on full clips
    the result is `loss_fn(pred, true)`."""
    per_frame = PER_FRAME.get(loss_fn)
    if per_frame is None:
        raise ValueError(f"no per-frame form registered for {loss_fn!r}; "
                         "add it to training.losses.PER_FRAME")

    def fn(pred, true_and_mask):
        true, mask = true_and_mask[..., :2], true_and_mask[..., 2]
        per = per_frame(pred, true)
        w = (mask[:, 0, 0] > 0.5).to(per.dtype)
        return (per * w).sum() / w.sum().clamp(min=1.0)

    return fn


def clips_of(frames: np.ndarray, maps: np.ndarray, fixs: np.ndarray, clip_len: int,
             time_dims: int) -> List[Clip]:
    """A decoded video as training clips: the frames cut to a multiple of
    `time_dims` (and to the shortest of frames, maps and fixations), slices
    of `clip_len` frames with the last one at its true size, each
    (x uint8 (n, H, W, 3), y f32 (n, Ho, Wo, 3) = [map, fixations, mask]);
    a clip with a ground-truth frame that is all zeros is skipped."""
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
        mask = np.ones(y.shape[:3] + (1,), np.float32)
        clips.append((x, np.concatenate([y, mask], -1)))
    return clips


class Trainer:
    """Train and val epochs with TBPTT over clips, on `device` (CUDA unless
    "cpu" is passed).

    `pre_variables`: a JAX `{params, batch_stats}` tree to start from (warm
    start); else the weights are drawn by `init_uavsal` from seed 0.
    `ob_prior`: the (Ho, Wo, 20) observed-prior map; else it is built from
    the train split as the JAX trainer builds it. `videos`: {"train": [...],
    "val": [...]} of `ArrayVideo`s to train on instead of the txt splits
    under `train_data_dir`."""

    def __init__(self, config: TrainConfig, train_data_dir: str, dataset: str,
                 save_model_dir: str, ext: str = ".avi", pre_variables=None,
                 priors_cache_dir: str = "", device=None, ob_prior: Optional[np.ndarray] = None,
                 videos: Optional[Mapping[str, Sequence[ArrayVideo]]] = None):
        check_supported(config)
        self.cfg = config
        self.device = resolve_device(device)
        self.train_data_dir = train_data_dir
        self.ext = ext
        self.videos = videos
        self.model_dir = os.path.join(save_model_dir, config.method_name)
        os.makedirs(self.model_dir, exist_ok=True)
        self.prefix = os.path.join(self.model_dir, config.method_name)
        self.metrics = MetricsLogger(self.model_dir)

        _, _, out_r, out_c = config.iosize
        if ob_prior is None:
            ob_prior = get_ob_priors(train_data_dir, dataset, "train", out_r, out_c, 20,
                                     priors_cache_dir)
        self.gauss = torch.from_numpy(get_gauss_priors(out_r, out_c, 8)).to(self.device)
        self.ob = torch.as_tensor(np.asarray(ob_prior, np.float32)).to(self.device)

        model = UAVSal(time_dims=config.time_dims)
        if pre_variables is None:
            init_uavsal(model, torch.Generator().manual_seed(0))
        else:
            sd = from_jax_variables(pre_variables)
            if looks_folded(sd):
                raise ValueError(
                    "pre_variables carry fold_batchnorm's signature (BN scale absorbed into "
                    "the convs); training on them would count the BN scale twice under live "
                    "batch statistics. Load the unfolded checkpoint instead.")
            model.load_state_dict(sd, strict=True)
        model.to(self.device, memory_format=torch.channels_last)
        mask = make_frozen_mask(model, config.freeze) if config.freeze else None
        optimizer = make_optimizer(model, config.learning_rate, config.weight_decay,
                                   trainable_mask=mask)
        self.state = create_train_state(model, optimizer)
        loss = _masked_loss(LOSSES[config.loss_name])
        self.train_step = make_train_step(
            self.state, loss, torch.bfloat16 if config.mixed_precision else None)
        self.eval_step = make_eval_step(model, loss)

    @property
    def model(self) -> UAVSal:
        return self.state.model

    # ------------------------------------------------------------------ #

    def _video_clips(self, vid_path: str, map_path: str, fix_path: str,
                     max_frames: float) -> List[Clip]:
        """Decode and letterbox one video and its ground truth into clips."""
        from ..data.video import preprocess_videos, preprocess_vidfixs, preprocess_vidmaps

        shape_r, shape_c, out_r, out_c = self.cfg.iosize
        maps = preprocess_vidmaps(map_path, out_r, out_c, max_frames)
        fixs = preprocess_vidfixs(fix_path, out_r, out_c, max_frames)
        frames, nframes, _, _ = preprocess_videos(vid_path, shape_r, shape_c, max_frames)
        return self._clips(frames[:nframes], maps, fixs)

    def _clips(self, frames, maps, fixs) -> List[Clip]:
        cfg = self.cfg
        return clips_of(frames, maps, fixs, cfg.batch_size * cfg.time_dims, cfg.time_dims)

    def _phase_videos(self, phase: str, max_frames: float):
        """(names, the clips of each video as an iterator)."""
        if self.videos is not None:
            items = list(self.videos.get(phase, ()))
            names = [name for name, *_ in items]
            cut = None if max_frames == float("inf") else int(max_frames)
            return names, (self._clips(f[:cut], m[:cut], x[:cut]) for _, f, m, x in items)
        shuffle = self.cfg.shuffle_train if phase == "train" else False
        triples = list(zip(*read_video_list(self.train_data_dir, phase, shuffle=shuffle,
                                            ext=self.ext)))
        names = [os.path.basename(t[0]) for t in triples]

        def load(triple):
            return self._video_clips(*triple, max_frames)

        if not self.cfg.prefetch_decode or len(triples) < 2:
            return names, (load(t) for t in triples)
        from ..data.loaders import _prefetched

        return names, _prefetched(triples, load, prefetch=1)

    def _step(self, phase: str, x, y, rnn_state):
        if phase == "train":
            loss, rnn_state = self.train_step(x, self.gauss, self.ob, rnn_state, y)
        else:
            loss, rnn_state = self.eval_step(x, self.gauss, self.ob, rnn_state, y)
        return float(loss), rnn_state

    def _run_videos(self, phase: str, names: Sequence[str], clip_lists) -> float:
        """The clip loop over videos given as lists of clips: the mean loss
        over every clip of the phase, or inf when no clip ran."""
        shape_r, shape_c = self.cfg.iosize[:2]
        run_loss, num_step = 0.0, 0
        for idx, clips in enumerate(clip_lists):
            log.info("%s video %d/%d: %s", phase, idx + 1, len(names), names[idx])
            rnn_state = self.model.init_state(shape_r, shape_c, 1, device=self.device)
            video_loss = 0.0
            for x, y in clips:
                # uint8 to the card; the step normalizes there
                x = torch.from_numpy(np.ascontiguousarray(x))[None].to(self.device)
                y = torch.from_numpy(y)[None].to(self.device)
                loss, rnn_state = self._step(phase, x, y, rnn_state)
                video_loss += loss
                run_loss += loss
                num_step += 1
                if phase == "train":
                    self.metrics.scalar("train/loss", loss, self.state.step)
            if clips:
                log.info("  mean %s loss: %.4f", phase, video_loss / len(clips))
        if not num_step:
            # 0.0 would win the early-stop comparison and keep these weights
            log.warning("%s epoch ran no step (empty split, or every clip skipped for "
                        "empty ground truth)", phase)
            return float("inf")
        return run_loss / num_step

    def _run_epoch(self, phase: str) -> float:
        max_frames = self.cfg.max_train_frames if phase == "train" else self.cfg.max_val_frames
        names, clip_lists = self._phase_videos(phase, max_frames)
        return self._run_videos(phase, names, clip_lists)

    # ------------------------------------------------------------------ #

    def _snapshot(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and BatchNorm stats, copied to the host."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}

    def _epoch_payload(self, epoch: int, min_val_loss: float, num_patience: int) -> dict:
        return {**to_jax_variables(self.model.state_dict()),
                "opt_state": optimizer_tree(self.model, self.state.optimizer),
                "step": self.state.step, "epoch": epoch, "min_val_loss": min_val_loss,
                "num_patience": num_patience}

    def _resume(self):
        """(start epoch, min val loss, patience, best weights) from the
        newest epoch checkpoint, which this port wrote; the state is loaded."""
        latest = latest_checkpoint(self.model_dir, self.cfg.method_name)
        if not latest:
            return 0, float("inf"), 0, None
        ckpt = load_checkpoint(latest)
        if not set(ckpt.get("opt_state", {})) <= {n for n, _ in self.model.named_parameters()}:
            raise NotImplementedError(
                f"{latest} holds another optimizer layout (the JAX package's?): resuming "
                "across packages is ROADMAP A.9b")
        self.model.load_state_dict(from_jax_variables(ckpt), strict=True)
        load_optimizer_tree(self.model, self.state.optimizer, ckpt["opt_state"])
        self.state.step = int(ckpt["step"])
        best = None
        best_ckpt = f"{self.prefix}_best.ckpt"
        if os.path.exists(best_ckpt):
            best = dict(from_jax_variables(load_checkpoint(best_ckpt)))
        log.info("resumed from %s (epoch %d)", latest, int(ckpt["epoch"]) + 1)
        return (int(ckpt["epoch"]) + 1, float(ckpt["min_val_loss"]),
                int(ckpt["num_patience"]), best)

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
                if not cfg.is_best_only:
                    # the new best is on disk before the epoch checkpoint names
                    # its loss as min_val_loss, so a resume never points at
                    # weights that were not saved
                    save_checkpoint(f"{self.prefix}_best.ckpt", to_jax_variables(best))
            if not cfg.is_best_only:
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

        save_checkpoint(f"{self.prefix}_final.ckpt", to_jax_variables(best))
        self.model.load_state_dict(best, strict=True)
        return self.state
