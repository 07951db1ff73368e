"""`cli test` and `cli train` of the port against the JAX package's CLI for
two models of the ablation zoo on the CPU: `uavsal_lstm` (priors and a
ConvLSTM state of (V, 2, H/8, W/8, 256)) and `uavsal_stc3d` (3-D convs, no
priors, a dummy state), at 64x128, T=5, S=10 (`test_batch_size`/
`batch_size` 2), f32, each package with an empty priors cache of its own,
over `tests/test_torch_train_trainer.py`'s synthetic dataset (a 25-frame
and a 10-frame video at 72x120, with ground truth).

- `cli test` on one seeded checkpoint the JAX package wrote: the same
  `.mat` files, every map within one uint8 level (as
  `tests/test_torch_runner.py` holds the flagship);
- `cli train` (one epoch) in each package: each reads the other's
  `_final.ckpt` and runs it to the same saliency as its writer (f32,
  within 2e-5), and the port warm-starts from the JAX package's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu import cli as jcli
from iip_uavsal_saliency_tpu.models.adapters import build_adapted_model as j_build_adapted
from iip_uavsal_saliency_tpu.runners import infer as jinfer
from iip_uavsal_saliency_tpu.training.checkpoint import save_checkpoint
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.data import matio as tmatio
from iip_uavsal_saliency_tpu_torch.runners import infer as tinfer
from test_torch_train_step import few_threads, randomized  # noqa: F401
from test_torch_train_trainer import DATASET, VIDEOS, write_dataset

H, W, T = 64, 128, 5
HO, WO = H // 8, W // 8
NAMES = ["uavsal_lstm", "uavsal_stc3d"]
ATOL = 2e-5


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_data")
    write_dataset(str(root / DATASET), np.random.RandomState(11))
    return str(root)


def write_config(path, data_dir, name, **extra):
    cfg = {"data_dir": data_dir, "train_dataset": DATASET, "test_dataset": DATASET,
           "iosize": [H, W, HO, WO], "time_dims": T, "batch_size": 2, "test_batch_size": 2,
           "serve_bf16": False, "model_name": name, "num_stblock": 2, "epochs": 1,
           "shuffle_train": False, "save_model_dir": os.path.join(os.path.dirname(path), "w"),
           **extra}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def seeded_variables(name):
    jm = j_build_adapted(name, filter_kwargs=True, time_dims=T, num_stblock=2)
    state = jm.init_state(H, W, 1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 2 * T, H, W, 3)),
                            jnp.zeros((HO, WO, 8)), jnp.zeros((HO, WO, 20)), state)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    return randomized(zeros, np.random.RandomState(len(name)))


def read_dir(path):
    return {f[:-4]: tmatio.loadmat(os.path.join(path, f), "salmap")
            for f in sorted(os.listdir(path)) if f.endswith(".mat")}


def results(data_dir, method):
    return read_dir(os.path.join(data_dir, DATASET, "Results", f"Results_{method}",
                                 "Saliency", method))


@pytest.mark.parametrize("name", NAMES)
def test_cli_test_matches_jax(name, data_dir, tmp_path):
    """Both CLIs serve every video of the dataset from one checkpoint: the
    same files, shapes (native 72x120, frames cut to a multiple of T) and
    maps within one uint8 level."""
    ckpt = str(tmp_path / "zoo.ckpt")
    save_checkpoint(ckpt, seeded_variables(name))
    cfg = write_config(str(tmp_path / "cfg.json"), data_dir, name)
    for who, main in (("JAX", jcli.main), ("Port", cli.main)):
        os.makedirs(tmp_path / who)
        argv = ["test", "--config", cfg, "--model-path", ckpt, "--method_name", who + name,
                "--priors_cache_dir", str(tmp_path / who)]
        assert main(argv + (["--device", "cpu"] if who == "Port" else [])) in (0, None)
    want, got = results(data_dir, "JAX" + name), results(data_dir, "Port" + name)
    assert sorted(got) == sorted(want) == sorted(VIDEOS)
    for vid, maps in got.items():
        assert maps.shape == want[vid].shape == (72, 120, 1, VIDEOS[vid] // T * T)
        diff = np.abs(maps.astype(np.int16) - want[vid].astype(np.int16))
        assert diff.max() <= 1, f"{vid}: max uint8 diff {diff.max()}"
        assert maps.std() > 1, f"{vid}: the maps have no structure to compare"


def saliency_both(name, ckpt):
    """One clip through the JAX model and the port, each loaded from `ckpt`
    by its own `load_model_for_inference` (BatchNorm unfolded)."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 2 * T, H, W, 3).astype(np.float32)
    g = rng.rand(HO, WO, 8).astype(np.float32)
    o = rng.rand(HO, WO, 20).astype(np.float32)
    jm, jvars = jinfer.load_model_for_inference(ckpt, time_dims=T, num_stblock=2,
                                                model_name=name, fold_bn=False)
    state = np.array(jm.init_state(H, W, 1))
    want, _ = jm.apply(jvars, jnp.asarray(x), g, o, jnp.asarray(state))
    m = tinfer.load_model_for_inference(ckpt, time_dims=T, num_stblock=2, model_name=name,
                                        fold_bn=False, device="cpu")
    with torch.no_grad():
        got, _ = m(*(torch.from_numpy(a) for a in (x, g, o, state)))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_cli_train_checkpoints_read_by_both(name, data_dir, tmp_path):
    """One epoch of `cli train` in each package (the port from seed 0, the
    JAX package from its own init): each `_final.ckpt` loads into the other
    package's model of that name and serves the saliency its writer's
    package serves; the port warm-starts from the JAX package's."""
    cfg = write_config(str(tmp_path / "cfg.json"), data_dir, name)
    for who, main in (("J", jcli.main), ("P", cli.main)):
        os.makedirs(tmp_path / who)
        argv = ["train", "--config", cfg, "--method_name", who,
                "--priors_cache_dir", str(tmp_path / who)]
        assert main(argv + (["--device", "cpu"] if who == "P" else [])) in (0, None)
    for who in ("J", "P"):
        final = str(tmp_path / "w" / who / f"{who}_final.ckpt")
        want, got = saliency_both(name, final)
        assert float(np.std(want)) > 1e-4
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=who)
    os.makedirs(tmp_path / "P2")
    assert cli.main(["train", "--config", cfg, "--method_name", "P2", "--model-path",
                     str(tmp_path / "w" / "J" / "J_final.ckpt"), "--priors_cache_dir",
                     str(tmp_path / "P2"), "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "w" / "P2" / "P2_final.ckpt")
