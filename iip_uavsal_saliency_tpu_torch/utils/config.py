"""Run configuration (own copy of `iip_uavsal_saliency_tpu/utils/config.py`:
`Config`, `load_config`).

One dataclass holds paths and run settings, loaded from a JSON file and
overridden by `--key value` flags. It has every field of the JAX package's
`Config`, so a JSON config written for the JAX CLI loads unchanged; the
port's CLI reads what its commands use and refuses values it does not
implement yet (cli.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class Config:
    # datasets
    data_dir: str = os.environ.get("UAVSAL_DATA_DIR", "/data/DataSet")
    train_dataset: str = "UAV2"
    test_dataset: str = "UAV2-TE"

    # run layout
    save_model_dir: str = "./weights/temp_weights/"
    pre_model_path: str = ""
    priors_cache_dir: str = ""

    # model and run settings
    method_name: str = "UAVSal"
    model_name: str = "uavsal"
    cnn_type: str = "mobilenet_v2"
    iosize: Tuple[int, int, int, int] = (360, 640, 45, 80)
    img_iosize: Tuple[int, int, int, int] = (480, 640, 60, 80)
    time_dims: int = 5
    num_stblock: int = 2
    st_type: str = "st"
    bias_type: Tuple[int, int, int] = (1, 1, 1)
    batch_size: int = 2
    test_batch_size: int = 4
    eval_batch_size: int = 32
    epochs: int = 20
    learning_rate: float = 1e-4
    weight_decay: float = 5e-5
    is_early_stop: bool = True
    max_patience: int = 4
    is_best_only: bool = False
    shuffle_train: bool = True
    num_workers: int = 4
    videos_per_step: int = 1
    resume: bool = False
    mixed_precision: bool = False
    remat: bool = False
    donate: bool = False
    prefetch_decode: bool = True
    videos_per_batch: int = 1   # videos served in lock-step by `test`
    dp_devices: int = 1
    serve_bf16: bool = True     # bf16 serving for `test` (False: f32)
    bake_params: bool = True
    fold_bn: bool = True        # fold BatchNorm into the convs at load
    s2d_stem: bool = False
    export_platforms: str = ""
    device_auc: Optional[bool] = None

    @property
    def train_data_dir(self) -> str:
        return os.path.join(self.data_dir, self.train_dataset)

    @property
    def test_data_dir(self) -> str:
        return os.path.join(self.data_dir, self.test_dataset)

    @property
    def test_input_path(self) -> str:
        return os.path.join(self.test_data_dir, "Videos")

    @property
    def test_result_path(self) -> str:
        return os.path.join(self.test_data_dir, "Results", f"Results_{self.method_name}")

    @property
    def test_output_path(self) -> str:
        return os.path.join(self.test_result_path, "Saliency")

    @property
    def ext(self) -> str:
        """The video container of the train dataset."""
        from ..data.lists import dataset_ext

        return dataset_ext(self.train_dataset)


def _parse(field: dataclasses.Field, raw: str):
    ftype = str(field.type)
    if "Tuple" in ftype or "tuple" in ftype:
        return tuple(int(x) for x in raw.strip("()[]").split(","))
    if "Optional[bool]" in ftype:  # tri-state: auto / true / false
        return None if raw.lower() in ("none", "auto") else raw.lower() in ("1", "true", "yes")
    if ftype == "int":
        return int(raw)
    if ftype == "float":
        return float(raw)
    if ftype == "bool":
        return raw.lower() in ("1", "true", "yes")
    return raw


def load_config(path: Optional[str] = None, argv: Optional[Sequence[str]] = None) -> Config:
    """Config from an optional JSON file and `--key value` overrides. An
    unknown key, a flag without a value or a missing file raise SystemExit:
    a run with silent defaults is worse than none."""
    cfg = Config()
    if path:
        if not os.path.exists(path):
            raise SystemExit(f"config file not found: {path}")
        with open(path) as f:
            data = json.load(f)
        fields = {f.name for f in dataclasses.fields(Config)}
        unknown = sorted(set(data) - fields)
        if unknown:
            raise SystemExit(f"unknown config keys in {path}: {unknown}")
        data = {k: tuple(v) if isinstance(v, list) else v for k, v in data.items()}
        cfg = dataclasses.replace(cfg, **data)
    if argv:
        fields = {f.name: f for f in dataclasses.fields(Config)}
        updates = {}
        argv = list(argv)
        i = 0
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("--"):
                raise SystemExit(f"unexpected argument {arg!r} (flags are --key value)")
            key = arg[2:].replace("-", "_")
            if key not in fields:
                raise SystemExit(f"unknown flag --{key}")
            if i + 1 >= len(argv):
                raise SystemExit(f"flag --{key} needs a value")
            updates[key] = _parse(fields[key], argv[i + 1])
            i += 2
        cfg = dataclasses.replace(cfg, **updates)
    return cfg
