"""Command line of the port (counterpart of `iip_uavsal_saliency_tpu/cli.py`).

    python -m iip_uavsal_saliency_tpu_torch.cli train [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli test [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli eval [--config cfg.json]
        [--methods A,B] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli eval-img [--config cfg.json]
        [--methods A,B] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli modelsize [--config cfg.json]
        [--key value ...]

`train` trains the model `model_name` on `<data_dir>/<train_dataset>`
(its txt splits, videos and ground truth in the reference's layout) as the
JAX package's `train` does, writing `<save_model_dir>/<method_name>/` epoch
checkpoints, `_best.ckpt` and `_final.ckpt`; `--model-path` is a video-model
`.ckpt` to start from (warm start), else the weights are drawn from seed 0.

`test` serves every video of `<data_dir>/<test_dataset>/Videos` to `.mat`
files under `<...>/Results/Results_<method_name>/Saliency/<method_name>`,
as the JAX package's `test` does: the checkpoint is `--model-path`, else
`<save_model_dir>/<method_name>/<method_name>_final.ckpt`; `serve_bf16`
selects bf16; the device is CUDA unless `--device cpu` is given. The
configuration is the JAX package's (utils/config.py): both commands build
any `model_name` of the JAX `MODEL_ZOO` (`uavsal`, the flagship, and the
ablations `uavsal_spconv`, `uavsal_teconv`, `uavsal_stblocks`,
`uavsal_stblocks_type`, `uavsal_stc3d`, `uavsal_stc2_3d`, `uavsal_mp`,
`uavsal_lstm`), with `cnn_type` (mobilenet_v2, resnet18/34/50/101/152,
vgg16), `num_stblock`, `bias_type`, `st_type` (the ordering of
`uavsal_stblocks_type`: st, s2t, t2s, s_s2t) and `s2d_stem`; a model takes
the keywords its class has and ignores the rest, as the JAX CLI's
`filter_kwargs` does, and an unknown `model_name` raises KeyError.
`dp_devices` above 1 raises NotImplementedError naming ROADMAP A.11.

`modelsize` prints the bytes of the configured UAVSal's parameters and
BatchNorm statistics per top-level part of the JAX variable tree, as the
JAX package's `modelsize` does (the flagship class whatever `model_name`
says, as there; no device is used).

`eval` scores the `.mat` files of each method (`--methods`, else
`method_name`) under `<data_dir>/<test_dataset>/Results/Results_<method_name>/
Saliency/<method>` against the dataset's ground truth with the seven
metrics, as the JAX package's `eval` does: `Scores/<method>/Score_<vid>.mat`
per video, then `Scores/MeanScores.{mat,json}`, the means logged. The
batch is `eval_batch_size`; AUC-Borji and AUC-shuffled run on the device
unless `device_auc` is false. `eval-img` scores the PNGs of
`<data_dir>/salicon-15/val/Results/Results_<method_name>/Saliency/<method>`
(`Scores/Score_<method>.mat`, means logged; `device_auc` unset picks the
path by the device's round trip). The other subcommands of the JAX CLI
(`train-img`, `vis`, `convert`, `export`, `test-aot`, `pipeline`) are
ROADMAP A.9b and A.11.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

from .utils.config import Config, load_config
from .utils.logging import get_logger

log = get_logger("cli")


def _split_cli(argv: Sequence[str]
               ) -> Tuple[Optional[str], Optional[str], Optional[List[str]], List[str]]:
    """(--config path, --device, --methods split at commas, the rest with
    --model-path as --pre_model_path) for `load_config`."""
    cfg_path, device, methods, rest = None, None, None, []
    argv = list(argv)
    i = 0
    while i < len(argv):
        if argv[i] in ("--config", "--model-path", "--device", "--methods"):
            if i + 1 >= len(argv):
                raise SystemExit(f"flag {argv[i]} needs a value")
            if argv[i] == "--config":
                cfg_path = argv[i + 1]
            elif argv[i] == "--device":
                device = argv[i + 1]
            elif argv[i] == "--methods":
                methods = argv[i + 1].split(",")
            else:
                rest += ["--pre_model_path", argv[i + 1]]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    return cfg_path, device, methods, rest


def _final_ckpt(cfg: Config) -> str:
    if cfg.pre_model_path:
        return cfg.pre_model_path
    return os.path.join(cfg.save_model_dir, cfg.method_name, f"{cfg.method_name}_final.ckpt")


def _check_supported(cfg: Config) -> None:
    if cfg.dp_devices > 1:
        raise NotImplementedError(f"dp_devices={cfg.dp_devices}: multi-GPU serving and "
                                  "training are ROADMAP A.11")


def cmd_train(cfg: Config, device: Optional[str] = None):
    from .training.checkpoint import load_checkpoint
    from .training.trainer import TrainConfig, Trainer

    _check_supported(cfg)
    names = ("method_name", "model_name", "cnn_type", "iosize", "time_dims", "num_stblock",
             "st_type", "bias_type", "s2d_stem", "batch_size", "epochs", "learning_rate",
             "weight_decay", "is_early_stop", "max_patience", "is_best_only", "shuffle_train",
             "videos_per_step", "resume", "mixed_precision", "remat", "prefetch_decode")
    tc = TrainConfig(**{name: getattr(cfg, name) for name in names})
    pre_vars = None
    if cfg.pre_model_path:
        ckpt = load_checkpoint(cfg.pre_model_path)
        # the image stage's tree is exactly {sfnet, conv_out} (JAX
        # `is_image_stage_variables`); the zoo's flat trees also hold `sfnet`
        params = ckpt.get("params")
        if params is None or set(params) == {"sfnet", "conv_out"}:
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
                                     fold_bn=cfg.fold_bn, device=device,
                                     cnn_type=cfg.cnn_type, num_stblock=cfg.num_stblock,
                                     bias_type=cfg.bias_type, s2d_stem=cfg.s2d_stem,
                                     model_name=cfg.model_name, st_type=cfg.st_type)
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


def cmd_eval(cfg: Config, device: Optional[str] = None,
             methods: Optional[Sequence[str]] = None):
    from .evaluation.scorer import evalscores_vid, mean_scores

    methods = methods or [cfg.method_name]
    evalscores_vid(
        cfg.test_data_dir,
        cfg.test_result_path,
        cfg.test_dataset,
        methods,
        batch_size=cfg.eval_batch_size,
        # only an explicit False takes the host path
        device_auc=cfg.device_auc if cfg.device_auc is not None else True,
        device=device,
    )
    means = mean_scores(cfg.test_result_path, methods)
    for m, scores in means.items():
        log.info("%s mean scores: %s", m, {k: round(v, 4) for k, v in scores.items()})
    return means


def cmd_eval_img(cfg: Config, device: Optional[str] = None,
                 methods: Optional[Sequence[str]] = None):
    from .evaluation.scorer import evalscores_img, mean_scores_img

    methods = methods or [cfg.method_name]
    data_dir = os.path.join(cfg.data_dir, "salicon-15", "val")
    res_dir = os.path.join(data_dir, "Results", f"Results_{cfg.method_name}")
    evalscores_img(data_dir, res_dir, "SALICON", methods, device_auc=cfg.device_auc,
                   batch_size=cfg.eval_batch_size, device=device)
    return mean_scores_img(res_dir, methods)


def cmd_modelsize(cfg: Config, device: Optional[str] = None) -> str:
    """The JAX package's `modelsize` report of the configured UAVSal, from
    the port's model on the CPU (sizes need no device and no weights)."""
    from .models.convert import table_of, to_jax_variables
    from .models.uavsal import UAVSal
    from .ops.stats import model_size_report

    model = UAVSal(time_dims=cfg.time_dims, cnn_type=cfg.cnn_type, num_stblock=cfg.num_stblock,
                   bias_type=cfg.bias_type, s2d_stem=cfg.s2d_stem)
    report = model_size_report(to_jax_variables(model.state_dict(), table_of(model)))
    print(report)
    return report


COMMANDS = {"train": cmd_train, "test": cmd_test, "eval": cmd_eval, "eval-img": cmd_eval_img,
            "modelsize": cmd_modelsize}
# the commands that take --methods
SCORING = ("eval", "eval-img")
# the JAX CLI's commands the port does not have yet, and their ROADMAP items
NOT_PORTED = {"train-img": "A.9b", "vis": "A.11", "convert": "A.11", "export": "A.11",
              "test-aot": "A.11", "pipeline": "A.11"}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in NOT_PORTED:
        print(f"{cmd}: not in the port yet (ROADMAP {NOT_PORTED[cmd]})")
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}\n{__doc__}")
        return 2
    cfg_path, device, methods, rest = _split_cli(rest)
    if methods is not None and cmd not in SCORING:
        raise SystemExit(f"flag --methods is only valid for {' and '.join(SCORING)}")
    cfg = load_config(cfg_path, rest)
    if cmd in SCORING:
        COMMANDS[cmd](cfg, device, methods)
    else:
        COMMANDS[cmd](cfg, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
