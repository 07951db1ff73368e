"""Command line of the port (counterpart of `iip_uavsal_saliency_tpu/cli.py`).

    python -m iip_uavsal_saliency_tpu_torch.cli test [--config cfg.json]
        [--model-path ckpt] [--device cuda|cpu] [--key value ...]

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
                f"{key}={value!r}: the port serves the flagship UAVSal only ({key}="
                f"{flagship!r}); the zoo and the other backbones are ROADMAP A.10")
    if cfg.dp_devices > 1:
        raise NotImplementedError(f"dp_devices={cfg.dp_devices}: multi-GPU serving is "
                                  "ROADMAP A.11")


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd != "test":
        print(f"unknown command: {cmd}\n{__doc__}")
        return 2
    cfg_path, device, rest = _split_cli(rest)
    cmd_test(load_config(cfg_path, rest), device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
