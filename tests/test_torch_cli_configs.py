"""`cli test` and `cli train` at another configuration than the flagship,
end to end on the CPU: `--cnn_type resnet18 --bias_type 1,0,1
--num_stblock 1` at 64x128, T=5, f32.

`cli test` serves a `.ckpt` the JAX package wrote to the `.mat` files the
JAX runner writes from it (JAX `load_model_for_inference`, folded as the
JAX `cli test` folds, then `test_videos` with its step run un-jitted),
within one uint8 level; the JAX run takes an empty temporary
`priors_cache_dir` (the committed 8x8x8 `gauss_priors.mat` at the repo
root would otherwise stand in for the analytic Gaussian priors).
`cli train` trains that configuration and writes a `_final.ckpt` that the
JAX package reads into the same tree as its own model's and serves to the
port's maps."""

import json
import os

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from iip_uavsal_saliency_tpu.parallel.steps import _build_infer_fn  # noqa: E402
from iip_uavsal_saliency_tpu.runners import infer as jinfer  # noqa: E402
from iip_uavsal_saliency_tpu.training import checkpoint as jckpt  # noqa: E402
from iip_uavsal_saliency_tpu_torch import cli  # noqa: E402
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal  # noqa: E402
from iip_uavsal_saliency_tpu_torch.runners import infer as tinfer  # noqa: E402
from test_torch_runner import BATCH, _read_dir, _write_dataset  # noqa: E402
from test_torch_train_step import few_threads  # noqa: E402,F401
from test_torch_train_trainer import write_dataset as write_train_dataset  # noqa: E402
from test_torch_uavsal_configs import (ATOL_SALIENCY, ATOL_STATE, H, HO, T, W, WO,  # noqa: E402
                                       as_jax, as_torch, clip, jax_config)

CFG = ("resnet18", 1, (1, 0, 1), False)
FLAGS = ["--cnn_type", "resnet18", "--bias_type", "1,0,1", "--num_stblock", "1"]
IOSIZE = (H, W, HO, WO)
DATASET = "UAV2"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A `.ckpt` the JAX package wrote: the configuration's seeded tree."""
    _, variables = jax_config(*CFG)
    path = str(tmp_path_factory.mktemp("ckpt") / "resnet18.ckpt")
    jckpt.save_checkpoint(path, variables)
    return path


def test_cli_test_matches_the_jax_runner(ckpt, tmp_path):
    root = str(tmp_path / "data" / DATASET)
    _write_dataset(root, np.random.RandomState(11))
    jmodel, jvars = jinfer.load_model_for_inference(ckpt, cnn_type=CFG[0], time_dims=T,
                                                    num_stblock=CFG[1], bias_type=CFG[2])
    fn = _build_infer_fn(jmodel)
    params, stats = jvars["params"], jvars["batch_stats"]
    jax_cache, port_cache = tmp_path / "jax_priors", tmp_path / "port_priors"
    os.makedirs(jax_cache)
    os.makedirs(port_cache)
    jinfer.test_videos(os.path.join(root, "Videos"), str(tmp_path / "jax_out"), jmodel, jvars,
                       iosize=IOSIZE, batch_size=BATCH, time_dims=T, bias_type=CFG[2],
                       train_data_dir=root, dataset=DATASET, priors_cache_dir=str(jax_cache),
                       method_name="JAX",
                       infer_step=lambda p, b, x, g, o, st: fn(params, stats, x, g, o, st))
    want = _read_dir(str(tmp_path / "jax_out" / "JAX"))
    cfg = {"data_dir": str(tmp_path / "data"), "train_dataset": DATASET,
           "test_dataset": DATASET, "iosize": list(IOSIZE), "time_dims": T,
           "test_batch_size": BATCH, "serve_bf16": False, "priors_cache_dir": str(port_cache),
           "method_name": "CLI"}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    assert cli.main(["test", "--config", str(tmp_path / "cfg.json"), "--model-path", ckpt,
                     "--device", "cpu", *FLAGS]) == 0
    got = _read_dir(os.path.join(root, "Results", "Results_CLI", "Saliency", "CLI"))
    assert sorted(got) == sorted(want) and len(want) == 4
    served = 0
    for name, maps in want.items():
        assert got[name].shape == maps.shape and got[name].dtype == np.uint8
        if maps.size:  # a video shorter than time_dims has an empty map
            diff = np.abs(got[name].astype(np.int16) - maps.astype(np.int16))
            assert diff.max() <= 1, name  # one uint8 level
            assert got[name].std() > 1, name  # maps with structure
            served += maps.shape[-1]
    assert served == 35  # 20 + 5 + 0 + 10 frames
    assert not os.listdir(port_cache)  # the ob stream is off: no observed priors built


def test_cli_train_writes_a_final_ckpt_both_packages_read(ckpt, tmp_path):
    root = str(tmp_path / "data" / DATASET)
    write_train_dataset(root, np.random.RandomState(12))
    cfg = {"data_dir": str(tmp_path / "data"), "train_dataset": DATASET,
           "save_model_dir": str(tmp_path / "w"), "priors_cache_dir": str(tmp_path),
           "iosize": list(IOSIZE), "time_dims": T, "batch_size": 2, "epochs": 1,
           "method_name": "CLI", "shuffle_train": False}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    # a warm start from the JAX package's checkpoint of this configuration
    assert cli.main(["train", "--config", str(tmp_path / "cfg.json"), "--model-path", ckpt,
                     "--device", "cpu", *FLAGS]) == 0
    final = str(tmp_path / "w" / "CLI" / "CLI_final.ckpt")
    tree = jckpt.load_checkpoint(final)
    jmodel, start = jax_config(*CFG)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(start)
    moved = [not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(variables),
                                                      jax.tree_util.tree_leaves(start))]
    assert any(moved)  # trained
    model = tinfer.load_model_for_inference(final, time_dims=T, fold_bn=False, device="cpu",
                                            cnn_type=CFG[0], num_stblock=CFG[1],
                                            bias_type=CFG[2])
    data = clip(13, CFG[2])
    want, wstate = jmodel.apply(variables, *as_jax(*data))
    with torch.no_grad():
        got, gstate = model(*as_torch(*data))
    assert float(np.std(np.asarray(want))) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_SALIENCY, rtol=0)
    np.testing.assert_allclose(gstate.numpy(), np.asarray(wstate), atol=ATOL_STATE, rtol=0)


def test_test_videos_refuses_a_bias_type_the_model_was_not_built_with(tmp_path):
    """`test_videos` builds the priors `bias_type` asks for; a model built
    with other streams would be handed a None prior it needs (or a prior it
    has no layers for), so the mismatch raises before any work."""
    with pytest.raises(ValueError, match="bias_type"):
        tinfer.test_videos(str(tmp_path), str(tmp_path), UAVSal(bias_type=(1, 0, 1)),
                           bias_type=(1, 1, 1))
    assert not os.listdir(tmp_path)
