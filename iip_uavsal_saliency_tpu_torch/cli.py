"""Command line of the port (counterpart of `iip_uavsal_saliency_tpu/cli.py`).
`python -m iip_uavsal_saliency_tpu_torch <command> ...` runs it too.

    python -m iip_uavsal_saliency_tpu_torch.cli train [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli train-img [--config cfg.json]
        [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli test [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli eval [--config cfg.json]
        [--methods A,B] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli eval-img [--config cfg.json]
        [--methods A,B] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli vis [--config cfg.json]
        [--methods A,B|GT] [--frames 0,5,10] [--with-fix] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli pipeline [--config cfg.json]
        [--model-path ckpt] [--methods A,B] [--frames ...] [--with-fix]
        [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli modelsize [--config cfg.json]
        [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli convert <reference.pth> <out.ckpt>
        [--model_name NAME] [--num_stblock N] [--bias_type 1,1,1] [--st_type st]
        [--cnn_type mobilenet_v2]
    python -m iip_uavsal_saliency_tpu_torch.cli export <in.ckpt> <out.aot>
        [--config cfg.json] [--device cuda|cpu] [--key value ...]
    python -m iip_uavsal_saliency_tpu_torch.cli test-aot <in.aot>
        [--config cfg.json] [--method_name NAME] [--key value ...]

`train` trains the model `model_name` on `<data_dir>/<train_dataset>`
(its txt splits, videos and ground truth in the reference's layout) as the
JAX package's `train` does, writing `<save_model_dir>/<method_name>/` epoch
checkpoints, `_best.ckpt` and `_final.ckpt`; `--model-path` is a video-model
`.ckpt` to start from (warm start), or an image-stage `.ckpt` from
`train-img`, whose SRF-Net is transplanted into the video model drawn from
seed 0; else the weights are drawn from seed 0. `--videos_per_step N`
trains N videos in lock-step, `--remat true` recomputes the forward in the
backward, and `--resume true` continues from the newest epoch checkpoint,
which either package may have written.

`train-img` is the reference recipe's SALICON stage: `SRFNetImage`
trained on `<data_dir>/salicon-15/{train,val}` at `img_iosize` with
`batch_size`, `epochs`, `learning_rate`, `weight_decay` and early stop,
writing `<save_model_dir>/<method_name>_srfnet/<method_name>_srfnet_final.ckpt`
for `train --model-path`.

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
`bake_params` false serves the argument-passing step instead of the one
with the weights and priors baked in, as the JAX runner does.

`--dp_devices N` (N > 1) runs `train` and `test` data-parallel over
videos, as the JAX CLI's pure-`data` mesh does: N ranks, one process each
(`parallel/`), on `cuda:0` ... `cuda:N-1` over NCCL, or with `--device cpu`
on the CPU over gloo. More ranks than visible cards end the run, and the
ranks never go to the CPU unless `--device cpu` was given. `train` splits
each lock-step group of `videos_per_step` videos (a multiple of N) over the
ranks, with train-mode BatchNorm, the loss and the gradients reduced over
them, so that N ranks take the step one process takes on the whole group;
rank 0 writes the checkpoints and metrics. `test` splits each group of
`videos_per_batch` videos (a multiple of N) over the ranks, each serving
its own videos and writing their files. A rank waits at most 30 minutes
at a collective for the others (one that fails or stops alone then ends
the run); the run itself has no time limit.

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
path by the device's round trip).

`vis` overlays each method's `.mat` maps (`--methods`, else `method_name`;
"GT" for the ground-truth fixMaps) on the test videos as DIVX videos
under the maps' directory, or with `--frames i,j,k` those frames as PNGs
under `Saliency/<method>/Visual_frames`; `--with-fix` burns in the
fixation points. It is host work (cv2) and takes no device. `pipeline`
runs `train`, then `test`, `eval` and `vis` on the checkpoint it trained.
`--frames` and `--with-fix` are refused by every other command.

`convert`, `export` and `test-aot` are the reference's released-weights
flow, as in the JAX CLI:

    python -m iip_uavsal_saliency_tpu_torch.cli convert UAVSal_UAV2.pth uavsal.ckpt
    python -m iip_uavsal_saliency_tpu_torch.cli export uavsal.ckpt uavsal.aot
    python -m iip_uavsal_saliency_tpu_torch.cli test-aot uavsal.aot

`convert` reads a reference `.pth` (a pickled module or a raw state_dict;
it unpickles, so convert only files you trust) on the CPU and writes the
`.ckpt` that `test --model-path` and `train --model-path` read: the
entries of the model that `--model_name`, `--num_stblock`, `--bias_type`,
`--st_type` and `--cnn_type` build, the rest of the file (BatchNorm's
`num_batches_tracked`, torchvision's unused last MobileNetV2 conv) left
out, as the JAX converter does; a missing entry is named. (The JAX
converter reads a MobileNetV2 backbone whatever `--cnn_type` says.)
`export` bakes a checkpoint into one serving artifact (`runners/export.py`):
the model of the configuration with `fold_bn`, bf16 if `serve_bf16`, the
Gaussian prior and the observed prior of `train_data_dir` inside, at the
fixed shapes of `iosize`, `test_batch_size` x `time_dims` frames and
`videos_per_batch` videos, on the device it is exported on
(`--export_platforms` may name that device's type, cuda or cpu, and
nothing else). `test-aot` serves an artifact over the test videos as
`test` does, on the device it was exported for; it needs this package
(the artifact's K1 and K2 are the port's kernels) but not the checkpoint
or the priors. A JAX artifact (StableHLO) is refused with a message.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .utils.config import Config, load_config
from .utils.logging import get_logger

log = get_logger("cli")


def _split_cli(argv: Sequence[str], cmd: str = "vis"):
    """(--config path, --device, --methods split at commas, the vis options
    {"frames": --frames as ints or None, "with_fix": 0 or 1}, the rest with
    --model-path as --pre_model_path) for `load_config`. --frames and
    --with-fix are only taken where vis runs (`VIS`); elsewhere they end the
    run, as an unknown flag does: dropping one silently would start a long
    run without it."""
    cfg_path, device, methods, rest = None, None, None, []
    vis_opts = {"frames": None, "with_fix": 0}
    argv = list(argv)
    i = 0
    while i < len(argv):
        if argv[i] in ("--with-fix", "--frames") and cmd not in VIS:
            raise SystemExit(f"flag {argv[i]} is only valid for the vis and pipeline commands")
        if argv[i] == "--with-fix":
            vis_opts["with_fix"] = 1
            i += 1
        elif argv[i] in ("--config", "--model-path", "--device", "--methods", "--frames"):
            if i + 1 >= len(argv):
                raise SystemExit(f"flag {argv[i]} needs a value")
            value = argv[i + 1]
            if argv[i] == "--config":
                cfg_path = value
            elif argv[i] == "--device":
                device = value
            elif argv[i] == "--methods":
                methods = value.split(",")
            elif argv[i] == "--frames":
                try:
                    vis_opts["frames"] = [int(v) for v in value.split(",")]
                except ValueError:
                    raise SystemExit(f"--frames wants comma-separated ints, got {value!r}")
            else:
                rest += ["--pre_model_path", value]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    return cfg_path, device, methods, vis_opts, rest


def _final_ckpt(cfg: Config) -> str:
    if cfg.pre_model_path:
        return cfg.pre_model_path
    return os.path.join(cfg.save_model_dir, cfg.method_name, f"{cfg.method_name}_final.ckpt")


def _data_parallel(rank_fn, cfg: Config, device: Optional[str], batch: str) -> list:
    """`rank_fn(group, cfg)` on `cfg.dp_devices` ranks: one per card over
    NCCL, or with `device` "cpu" on the CPU over gloo, each rank with its
    share of this process's threads; what each rank returned. SystemExit
    where there are fewer cards than ranks, and ValueError where the
    videos a batch (`batch`, a field of `cfg`) do not split over the ranks,
    as the JAX trainer and runner refuse them, before any rank starts."""
    import torch

    from .parallel.mesh import check_cards, spawn

    world = cfg.dp_devices
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        check_cards(world)
    if getattr(cfg, batch) % world:
        raise ValueError(f"{batch}={getattr(cfg, batch)} must be a multiple of the mesh 'data' "
                         f"axis ({world}) so the video batch shards evenly")
    threads = max(1, torch.get_num_threads() // world) if on_cpu else 0
    return spawn(rank_fn, world, "gloo" if on_cpu else "nccl", args=(cfg,),
                 device_type="cpu" if on_cpu else "cuda", threads=threads)


def _train_rank(group, cfg: Config) -> None:
    _train(cfg, group.device, group)


def cmd_train(cfg: Config, device: Optional[str] = None):
    if cfg.dp_devices > 1:
        return _data_parallel(_train_rank, cfg, device, "videos_per_step")
    return _train(cfg, device)


def _train(cfg: Config, device, group=None):
    from .training.checkpoint import load_checkpoint
    from .training.trainer import TrainConfig, Trainer

    names = ("method_name", "model_name", "cnn_type", "iosize", "time_dims", "num_stblock",
             "st_type", "bias_type", "s2d_stem", "batch_size", "epochs", "learning_rate",
             "weight_decay", "is_early_stop", "max_patience", "is_best_only", "shuffle_train",
             "videos_per_step", "resume", "mixed_precision", "remat", "prefetch_decode")
    tc = TrainConfig(**{name: getattr(cfg, name) for name in names})
    pre_vars = None
    if cfg.pre_model_path:
        # a video model's checkpoint, or the image stage's (the Trainer
        # transplants its SRF-Net)
        ckpt = load_checkpoint(cfg.pre_model_path)
        pre_vars = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    trainer = Trainer(tc, cfg.train_data_dir, cfg.train_dataset, cfg.save_model_dir,
                      ext=cfg.ext, pre_variables=pre_vars,
                      priors_cache_dir=cfg.priors_cache_dir,
                      device=None if group is not None else device, group=group)
    return trainer.train()


def cmd_train_img(cfg: Config, device: Optional[str] = None):
    """The SALICON image stage; its `<method_name>_srfnet_final.ckpt` is
    what `train --model-path` transplants from."""
    from .training.image_trainer import ImageTrainConfig, train_salicon

    tc = ImageTrainConfig(method_name=f"{cfg.method_name}_srfnet", cnn_type=cfg.cnn_type,
                          iosize=cfg.img_iosize, batch_size=cfg.batch_size, epochs=cfg.epochs,
                          learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                          is_early_stop=cfg.is_early_stop, max_patience=cfg.max_patience)
    return train_salicon(tc, os.path.join(cfg.data_dir, "salicon-15"), cfg.save_model_dir,
                         device=device)


def _test_rank(group, cfg: Config) -> List[str]:
    return _test(cfg, group.device, group)


def cmd_test(cfg: Config, device: Optional[str] = None):
    """The `.mat` files written: a list, or with `dp_devices` > 1 one list
    per rank."""
    if cfg.dp_devices > 1:
        return _data_parallel(_test_rank, cfg, device, "videos_per_batch")
    return _test(cfg, device)


def _test(cfg: Config, device, group=None) -> List[str]:
    import torch

    from .runners.infer import load_model_for_inference, test_videos

    model = load_model_for_inference(_final_ckpt(cfg), time_dims=cfg.time_dims,
                                     fold_bn=cfg.fold_bn, device=device,
                                     cnn_type=cfg.cnn_type, num_stblock=cfg.num_stblock,
                                     bias_type=cfg.bias_type, s2d_stem=cfg.s2d_stem,
                                     model_name=cfg.model_name, st_type=cfg.st_type)
    return test_videos(
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
        bake_params=cfg.bake_params,
        group=group,
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


def cmd_vis(cfg: Config, methods: Optional[Sequence[str]] = None,
            frames: Optional[Sequence[int]] = None, with_fix: int = 0) -> None:
    """Overlay videos of each method's maps, or with `frames` those frames
    as PNGs ("GT": the ground-truth fixMaps), on the host."""
    from .vis.overlay import visual_vid, visual_vid_frames

    methods = methods or [cfg.method_name]
    if frames is not None:
        visual_vid_frames(cfg.test_data_dir, cfg.test_result_path, cfg.test_dataset, methods,
                          frame_indices=frames, with_color=1, with_fix=with_fix)
    else:
        visual_vid(cfg.test_data_dir, cfg.test_result_path, cfg.test_dataset, methods,
                   with_color=1, with_fix=with_fix)


def cmd_pipeline(cfg: Config, device: Optional[str] = None,
                 methods: Optional[Sequence[str]] = None,
                 frames: Optional[Sequence[int]] = None, with_fix: int = 0):
    """train -> test -> eval -> vis; the stages after training serve the
    checkpoint it wrote, not the one `--model-path` started it from."""
    cmd_train(cfg, device)
    cfg = dataclasses.replace(cfg, pre_model_path="")
    cmd_test(cfg, device)
    means = cmd_eval(cfg, device, methods)
    cmd_vis(cfg, methods, frames, with_fix)
    return means


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


def cmd_convert(cfg: Config, src: str, dst: str) -> None:
    """A reference `.pth` -> the port's `.ckpt` (`{params, batch_stats}` in
    the JAX package's layout, which both packages read), on the CPU."""
    if not os.path.exists(src):
        raise SystemExit(f"checkpoint not found: {src}")
    from .models.adapters import build_adapted_model
    from .models.convert import (load_torch_checkpoint, reference_state_dict, table_of,
                                 to_jax_variables)
    from .training.checkpoint import save_checkpoint

    model = build_adapted_model(cfg.model_name, filter_kwargs=True, cnn_type=cfg.cnn_type,
                                num_stblock=cfg.num_stblock, bias_type=cfg.bias_type,
                                st_type=cfg.st_type, time_dims=cfg.time_dims)
    table = table_of(model)
    variables = to_jax_variables(reference_state_dict(load_torch_checkpoint(src), table), table)
    save_checkpoint(dst, {"params": variables["params"],
                          "batch_stats": variables["batch_stats"]})
    log.info("converted %s (%s) -> %s", src, cfg.model_name, dst)


def _export_device(cfg: Config, device: Optional[str]):
    """The device to export on: `--device` (CUDA by default), which
    `--export_platforms`, where it is set, must name."""
    from .device import resolve_device

    dev = resolve_device(device)
    wanted = [p.strip() for p in cfg.export_platforms.split(",") if p.strip()]
    if any(p not in ("cuda", "cpu") for p in wanted):
        raise SystemExit(f"--export_platforms {cfg.export_platforms}: the port exports for "
                         "cuda or cpu; a TPU artifact is the JAX package's `cli export`")
    if wanted and wanted != [dev.type]:
        raise SystemExit(f"--export_platforms {cfg.export_platforms} is not the device the "
                         f"export runs on ({dev.type}): an artifact is exported on the "
                         "device type it serves on (pass --device)")
    return dev


def cmd_export(cfg: Config, src: str, dst: str, device: Optional[str] = None) -> None:
    """A checkpoint -> one serving artifact (weights, priors, fold, dtype
    and serving shape inside, `runners/export.py`), for `test-aot`."""
    if not os.path.exists(src):
        raise SystemExit(f"checkpoint not found: {src}")
    import torch

    from .data.priors import get_gauss_priors, get_ob_priors
    from .runners.export import export_serving, save_exported
    from .runners.infer import load_model_for_inference

    dev = _export_device(cfg, device)
    model = load_model_for_inference(src, time_dims=cfg.time_dims, fold_bn=cfg.fold_bn,
                                     device=dev, cnn_type=cfg.cnn_type,
                                     num_stblock=cfg.num_stblock, bias_type=cfg.bias_type,
                                     s2d_stem=cfg.s2d_stem, model_name=cfg.model_name,
                                     st_type=cfg.st_type)
    shape_r_out, shape_c_out = cfg.iosize[2], cfg.iosize[3]
    gauss = get_gauss_priors(shape_r_out, shape_c_out, 8) if cfg.bias_type[0] else None
    ob = get_ob_priors(cfg.train_data_dir, cfg.train_dataset, "train", shape_r_out,
                       shape_c_out, 20, cfg.priors_cache_dir) if cfg.bias_type[1] else None
    program, meta = export_serving(
        model, iosize=cfg.iosize, batch_size=cfg.test_batch_size, time_dims=cfg.time_dims,
        videos_per_batch=cfg.videos_per_batch, bias_type=cfg.bias_type, gauss=gauss, ob=ob,
        compute_dtype=torch.bfloat16 if cfg.serve_bf16 else None)
    save_exported(dst, program, meta)
    log.info("exported %s -> %s (platforms=%s, %s, S=%d, V=%d, %.1f MB)", src, dst,
             meta["platforms"], meta["compute_dtype"], meta["x_shape"][1],
             meta["videos_per_batch"], os.path.getsize(dst) / 1e6)


def cmd_test_aot(cfg: Config, artifact: str, device: Optional[str] = None) -> None:
    """Serve an artifact over the test videos (resumable `.mat` output, the
    flow of `test`), on the device type it was exported for."""
    if not os.path.exists(artifact):
        raise SystemExit(f"artifact not found: {artifact}")
    from .runners.export import ExportedServing, run_exported

    try:
        art = ExportedServing(artifact)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if device is not None and art.device.type != device.split(":")[0]:
        raise SystemExit(f"{artifact} was exported for {art.device.type}, not {device}")
    run_exported(cfg.test_input_path, cfg.test_output_path, art, method_name=cfg.method_name)


COMMANDS = {"train": cmd_train, "train-img": cmd_train_img, "test": cmd_test,
            "eval": cmd_eval, "eval-img": cmd_eval_img, "vis": cmd_vis,
            "pipeline": cmd_pipeline, "modelsize": cmd_modelsize, "convert": cmd_convert,
            "export": cmd_export, "test-aot": cmd_test_aot}
# the commands that take --methods, and those that run vis (--frames, --with-fix)
SCORING = ("eval", "eval-img")
VIS = ("vis", "pipeline")
# the JAX CLI's commands the port does not have yet, and their ROADMAP item
NOT_PORTED: Dict[str, str] = {}
# the commands that take paths before their flags, how many, and their usage
POSITIONAL = {
    "convert": (2, "convert <reference.pth> <out.ckpt> [--model_name NAME] [--num_stblock N] "
                   "[--bias_type 1,1,1] [--st_type st]"),
    "export": (2, "export <in.ckpt> <out.aot> [--export_platforms tpu] [--test_batch_size N] "
                  "[--videos_per_batch V] [--serve_bf16 true] [--fold_bn true]"),
    "test-aot": (1, "test-aot <in.aot> [--method_name NAME]"),
}


def _split_positionals(cmd: str, rest: Sequence[str]) -> Tuple[List[str], List[str]]:
    """(the paths, the flags) of a command in `POSITIONAL`: every flag of
    this CLI is `--key value`, so the paths are what no flag takes, as in
    the JAX CLI; a wrong count ends the run with the command's usage."""
    positionals: List[str] = []
    flags: List[str] = []
    i = 0
    while i < len(rest):
        if rest[i].startswith("--"):
            flags += rest[i:i + 2]
            i += 2
        else:
            positionals.append(rest[i])
            i += 1
    count, usage = POSITIONAL[cmd]
    if len(positionals) != count:
        raise SystemExit(f"usage: {usage}")
    return positionals, flags


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
    paths: List[str] = []
    if cmd in POSITIONAL:
        paths, rest = _split_positionals(cmd, rest)
    cfg_path, device, methods, vis_opts, rest = _split_cli(rest, cmd)
    if methods is not None and cmd not in SCORING + VIS:
        raise SystemExit(f"flag --methods is only valid for {', '.join(SCORING + VIS)}")
    cfg = load_config(cfg_path, rest)
    if cmd == "convert":
        cmd_convert(cfg, *paths)
    elif cmd in POSITIONAL:
        COMMANDS[cmd](cfg, *paths, device)
    elif cmd == "vis":
        cmd_vis(cfg, methods, vis_opts["frames"], vis_opts["with_fix"])
    elif cmd == "pipeline":
        cmd_pipeline(cfg, device, methods, vis_opts["frames"], vis_opts["with_fix"])
    elif cmd in SCORING:
        COMMANDS[cmd](cfg, device, methods)
    else:
        COMMANDS[cmd](cfg, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
