"""Command line of the port (counterpart of `iip_uavsal_saliency_tpu/cli.py`).

    python -m iip_uavsal_saliency_tpu_torch.cli train [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli test [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]

`train` trains the flagship on `<data_dir>/<train_dataset>` (its txt
splits, videos and ground truth in the reference's layout) as the JAX
package's `train` does, writing `<save_model_dir>/<method_name>/` epoch
checkpoints, `_best.ckpt` and `_final.ckpt`; `--model-path` is a video-model
`.ckpt` to start from (warm start), else the weights are drawn from seed 0.

`test` serves every video of `<data_dir>/<test_dataset>/Videos` to `.mat`
files under `<...>/Results/Results_<method_name>/Saliency/<method_name>`,
as the JAX package's `test` does: the checkpoint is `--model-path`, else
`<save_model_dir>/<method_name>/<method_name>_final.ckpt`; `serve_bf16`
selects bf16; the device is CUDA unless `--device cpu` is given. The
configuration is the JAX package's (utils/config.py); values the port does
not implement yet raise NotImplementedError naming their ROADMAP item. The
other subcommands of the JAX CLI are ROADMAP A.8-A.11.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

from .utils.config import Config, load_config

# what the port's UAVSal is (models/uavsal.py), and the JAX Config's value for it
FLAGSHIP = {"cnn_type": "mobilenet_v2", "model_name": "uavsal", "num_stblock": 2,
            "bias_type": (1, 1, 1), "st_type": "st", "s2d_stem": False}


def _split_cli(argv: Sequence[str]) -> Tuple[Optional[str], Optional[str], List[str]]:
    """(--config path, --device, the rest with --model-path as
    --pre_model_path) for `load_config`."""
    cfg_path, device, rest = None, None, []
    argv = list(argv)
    i = 0
    while i < len(argv):
        if argv[i] in ("--config", "--model-path", "--device"):
            if i + 1 >= len(argv):
                raise SystemExit(f"flag {argv[i]} needs a value")
            if argv[i] == "--config":
                cfg_path = argv[i + 1]
            elif argv[i] == "--device":
                device = argv[i + 1]
            else:
                rest += ["--pre_model_path", argv[i + 1]]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    return cfg_path, device, rest


def _final_ckpt(cfg: Config) -> str:
    if cfg.pre_model_path:
        return cfg.pre_model_path
    return os.path.join(cfg.save_model_dir, cfg.method_name, f"{cfg.method_name}_final.ckpt")


def _check_supported(cfg: Config) -> None:
    for key, flagship in FLAGSHIP.items():
        value = getattr(cfg, key)
        if (tuple(value) if isinstance(value, (list, tuple)) else value) != flagship:
            raise NotImplementedError(
                f"{key}={value!r}: the port runs the flagship UAVSal only ({key}="
                f"{flagship!r}); the zoo and the other backbones are ROADMAP A.10")
    if cfg.dp_devices > 1:
        raise NotImplementedError(f"dp_devices={cfg.dp_devices}: multi-GPU serving and "
                                  "training are ROADMAP A.11")


def cmd_train(cfg: Config, device: Optional[str] = None):
    from .training.checkpoint import load_checkpoint
    from .training.trainer import TrainConfig, Trainer

    _check_supported(cfg)
    names = ("method_name", "model_name", "cnn_type", "iosize", "time_dims", "num_stblock",
             "st_type", "bias_type", "batch_size", "epochs", "learning_rate", "weight_decay",
             "is_early_stop", "max_patience", "is_best_only", "shuffle_train",
             "videos_per_step", "resume", "mixed_precision", "remat", "prefetch_decode")
    tc = TrainConfig(**{name: getattr(cfg, name) for name in names})
    pre_vars = None
    if cfg.pre_model_path:
        ckpt = load_checkpoint(cfg.pre_model_path)
        if "params" not in ckpt or "trunk" not in ckpt["params"]:
            raise NotImplementedError(
                f"{cfg.pre_model_path} is not a video-model checkpoint; warm starts from the "
                "image stage (train-img) are ROADMAP A.9b")
        pre_vars = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    trainer = Trainer(tc, cfg.train_data_dir, cfg.train_dataset, cfg.save_model_dir,
                      ext=cfg.ext, pre_variables=pre_vars,
                      priors_cache_dir=cfg.priors_cache_dir, device=device)
    return trainer.train()


def cmd_test(cfg: Config, device: Optional[str] = None) -> None:
    import torch

    from .runners.infer import load_model_for_inference, test_videos

    _check_supported(cfg)
    model = load_model_for_inference(_final_ckpt(cfg), time_dims=cfg.time_dims,
                                     fold_bn=cfg.fold_bn, device=device)
    test_videos(
        cfg.test_input_path,
        cfg.test_output_path,
        model,
        iosize=cfg.iosize,
        batch_size=cfg.test_batch_size,
        time_dims=cfg.time_dims,
        bias_type=cfg.bias_type,
        train_data_dir=cfg.train_data_dir,
        dataset=cfg.train_dataset,
        priors_cache_dir=cfg.priors_cache_dir,
        method_name=cfg.method_name,
        videos_per_batch=cfg.videos_per_batch,
        compute_dtype=torch.bfloat16 if cfg.serve_bf16 else None,
    )


COMMANDS = {"train": cmd_train, "test": cmd_test}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}\n{__doc__}")
        return 2
    cfg_path, device, rest = _split_cli(rest)
    COMMANDS[cmd](load_config(cfg_path, rest), device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
