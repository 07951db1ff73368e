"""The SALICON image stage, SRF-Net's fine-tuning before the video model
(counterpart of `iip_uavsal_saliency_tpu/training/image_trainer.py`).

`train_salicon` trains `SRFNetImage` with the video model's loss and Adam
(no frozen part): per epoch a train pass over batches shuffled by
`RandomState(rng_seed + epoch)` with the short last batch dropped, and a
val pass in eval mode weighted per example (the short last batch kept);
`<prefix>_{epoch:02d}_{val:.4f}.ckpt` every epoch, early stop with
patience, and `<prefix>_final.ckpt` with the best weights. The checkpoints
hold `{params, batch_stats}` in the JAX tree through the port's msgpack
codec, so the JAX package reads them, and `cli train --model-path` takes
one to transplant its neck (`models/srfnet_image.py::transfer_sfnet`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.images import salicon_array_batches, salicon_batches
from ..device import resolve_device
from ..models.convert import from_jax_variables, table_of, to_jax_variables
from ..models.srfnet_image import SRFNetImage
from ..models.uavsal import init_model
from ..ops.layers import to_channels_last
from ..utils.logging import get_logger
from .checkpoint import save_checkpoint
from .optim import make_optimizer
from .steps import create_train_state, make_image_eval_step, make_image_train_step

log = get_logger("image_trainer")


@dataclasses.dataclass
class ImageTrainConfig:
    """Hyperparameters, with the JAX package's defaults."""

    method_name: str = "SRFNet"
    cnn_type: str = "mobilenet_v2"
    iosize: Tuple[int, int, int, int] = (480, 640, 60, 80)  # SALICON's
    batch_size: int = 4
    epochs: int = 10
    learning_rate: float = 1e-4
    weight_decay: float = 5e-5
    is_early_stop: bool = True
    max_patience: int = 4


def train_salicon(config: ImageTrainConfig, data_root: str, save_model_dir: str,
                  pre_variables: Optional[Mapping[str, Any]] = None, rng_seed: int = 0,
                  device=None, arrays: Optional[Mapping[str, Tuple[np.ndarray, np.ndarray]]] = None
                  ) -> Tuple[SRFNetImage, Dict[str, Any]]:
    """Train `SRFNetImage` on `<data_root>/{train,val}` (the SALICON layout)
    on `device` (CUDA unless "cpu" is passed). Returns (the model with the
    best weights, those weights as a JAX `{params, batch_stats}` tree).

    `pre_variables`: a JAX image-stage tree to start from; else the weights
    are drawn by `init_model` from `rng_seed`. `arrays`: {"train": (images,
    targets), "val": (...)} in memory (`data/images.py::
    salicon_array_batches`: uint8 images at the input size) instead of the
    files under `data_root`."""
    device = resolve_device(device)
    model = SRFNetImage(cnn_type=config.cnn_type)
    table = table_of(model)
    if pre_variables is None:
        init_model(model, torch.Generator().manual_seed(rng_seed))
    else:
        model.load_state_dict(from_jax_variables(pre_variables, table), strict=True)
    to_channels_last(model, device)
    state = create_train_state(model, make_optimizer(model, config.learning_rate,
                                                     config.weight_decay))
    train_step, eval_step = make_image_train_step(state), make_image_eval_step(model)
    model_dir = os.path.join(save_model_dir, config.method_name)
    os.makedirs(model_dir, exist_ok=True)
    prefix = os.path.join(model_dir, config.method_name)

    def batches(phase: str, rng: Optional[np.random.RandomState]):
        train = phase == "train"
        if arrays is not None:
            return salicon_array_batches(*arrays[phase], config.batch_size, shuffle=train,
                                         drop_last=train, rng=rng)
        return salicon_batches(data_root, phase, config.iosize, config.batch_size,
                               drop_last=train, rng=rng)

    def on_device(x, y):
        return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def snapshot() -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}

    best_loss, best = float("inf"), snapshot()
    patience = config.max_patience
    for epoch in range(config.epochs):
        t0, n, total = time.time(), 0, 0.0
        for x, y in batches("train", np.random.RandomState(rng_seed + epoch)):
            total += float(train_step(*on_device(x, y)))
            n += 1
        train_loss = total / max(n, 1)
        # per example, so that the kept short last batch is not over-weighted
        n, total = 0, 0.0
        for x, y in batches("val", None):
            total += float(eval_step(*on_device(x, y))) * x.shape[0]
            n += x.shape[0]
        val_loss = total / n if n else float("inf")
        log.info("epoch %02d: train %.4f val %.4f (%.1fs)", epoch, train_loss, val_loss,
                 time.time() - t0)
        save_checkpoint(f"{prefix}_{epoch:02d}_{val_loss:.4f}.ckpt",
                        to_jax_variables(model.state_dict(), table))
        if val_loss < best_loss:
            best_loss, best = val_loss, snapshot()
            patience = config.max_patience
        elif config.is_early_stop:
            patience -= 1
            if patience <= 0:
                log.info("early stop at epoch %d (best %.4f)", epoch, best_loss)
                break

    variables = to_jax_variables(best, table)
    save_checkpoint(f"{prefix}_final.ckpt", variables)
    model.load_state_dict(best, strict=True)
    return model, variables
