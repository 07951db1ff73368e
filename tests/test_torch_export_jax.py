"""Both packages' released-weights flow on the CPU at 64x128, f32, from one
checkpoint (`tests/test_torch_runner.py`'s world, an empty priors cache
each): the JAX `cli export --export_platforms cpu` then `cli test-aot`,
against the port's `cli export` then `cli test-aot`: the same `.mat`
files, every map within one uint8 level. The port refuses the JAX
artifact (StableHLO) with a message, and the JAX package refuses the
port's."""

import os
import shutil

import numpy as np
import pytest

from iip_uavsal_saliency_tpu import cli as jcli
from iip_uavsal_saliency_tpu.training.checkpoint import save_checkpoint
from iip_uavsal_saliency_tpu_torch import cli
from test_torch_train_step import few_threads  # noqa: F401
from test_torch_runner import (BATCH, DATASET, IOSIZE, T, VIDEOS, _read_dir,  # noqa: F401
                               world)


def _flags(data_dir, priors, method):
    return ["--data_dir", data_dir, "--train_dataset", DATASET, "--test_dataset", DATASET,
            "--iosize", ",".join(map(str, IOSIZE)), "--time_dims", str(T),
            "--test_batch_size", str(BATCH), "--serve_bf16", "false",
            "--priors_cache_dir", priors, "--method_name", method]


def test_port_and_jax_artifacts_serve_the_same_maps(world, tmp_path):
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": world["variables"]["params"],
                           "batch_stats": world["variables"]["batch_stats"]})
    runs = {}
    for name, main, root in (("JAX", jcli.main, world["jax_root"]),
                             ("PORT", cli.main, world["port_root"])):
        data_dir = str(tmp_path / name)
        shutil.copytree(root, os.path.join(data_dir, DATASET),
                        ignore=shutil.ignore_patterns("priors"))
        os.makedirs(tmp_path / f"{name}_priors")
        flags = _flags(data_dir, str(tmp_path / f"{name}_priors"), name)
        aot = str(tmp_path / f"{name}.aot")
        device = ["--device", "cpu"] if name == "PORT" else []
        assert main(["export", ckpt, aot, "--export_platforms", "cpu"] + flags + device) in (
            0, None)
        assert main(["test-aot", aot] + flags) in (0, None)
        runs[name] = (aot, _read_dir(os.path.join(data_dir, DATASET, "Results",
                                                  f"Results_{name}", "Saliency", name)))
    (jax_aot, want), (port_aot, got) = runs["JAX"], runs["PORT"]
    assert sorted(got) == sorted(want) == sorted(VIDEOS)
    for name, maps in got.items():
        assert maps.shape == want[name].shape and maps.dtype == np.uint8
        if maps.size:
            diff = np.abs(maps.astype(np.int16) - want[name].astype(np.int16))
            assert diff.max() <= 1, f"{name}: max uint8 diff {diff.max()}"
            assert maps.std() > 1
    with pytest.raises(SystemExit, match="a JAX StableHLO serving artifact"):
        cli.main(["test-aot", jax_aot])
    with pytest.raises(ValueError, match="not a UAVSal AOT serving artifact"):
        jcli.main(["test-aot", port_aot])
