"""The port's `Trainer` and `cli train` end to end on the CPU, against the
JAX package's `Trainer`, on a synthetic dataset in the reference layout
(written as `tests/test_pipeline.py` writes one, its blurred maps scaled
to a peak of 255 so that they survive the letterbox down to 8x16): 64x128 input, T=5,
batch_size=2 (clips of S=10 frames), 2 epochs of train and val, every
parameter trained, no shuffle, the same starting variables for both, an
empty priors cache for each.

The train video has 25 frames, so its clips are 10, 10 and a ragged 5 at
its true size, and frame 12 has no fixation, so its second clip is skipped;
the val video has 10 frames. The learning rate is 1e-7: with the default
1e-4 two f32 trajectories part after the first Adam step (see
`tests/test_torch_train_step.py`), and this test is about the loop around
the step (clips, skips, the carried state, epochs, val, checkpoints)."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from iip_uavsal_saliency_tpu.data.matio import savemat as jsavemat  # noqa: E402
from iip_uavsal_saliency_tpu.training import checkpoint as jckpt  # noqa: E402
from iip_uavsal_saliency_tpu.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from iip_uavsal_saliency_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from iip_uavsal_saliency_tpu_torch import cli  # noqa: E402
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables  # noqa: E402
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training.trainer import (TrainConfig, Trainer,  # noqa: E402
                                                            clips_of)
from test_torch_train_step import H, HO, T, W, WO, few_threads, variables  # noqa: E402,F401

IOSIZE = (H, W, HO, WO)
DATASET = "UAV2"
NATIVE_H, NATIVE_W = 72, 120
VIDEOS = {"vid_a": 25, "vid_b": 10}  # train, val
NO_FIXATION = ("vid_a", 12)
TOL_EPOCH_LOSS = 1e-4  # relative
CONFIG = dict(method_name="Tiny", iosize=IOSIZE, time_dims=T, batch_size=2, epochs=2,
              learning_rate=1e-7, freeze=(), shuffle_train=False)


def write_dataset(root, rng, videos=VIDEOS, splits=None):
    """Videos/, maps/<v>_fixMaps.mat, fixations/maps/<v>_fixPts.mat and
    txt/{train,val}.txt: `videos` {name: frames}, `splits` {phase: [names]}
    (by default the first video trains and the second validates)."""
    for d in ("Videos", "maps", os.path.join("fixations", "maps"), "txt"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name, n in videos.items():
        wr = cv2.VideoWriter(os.path.join(root, "Videos", name + ".avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10, (NATIVE_W, NATIVE_H))
        for _ in range(n):
            wr.write(rng.randint(0, 255, (NATIVE_H, NATIVE_W, 3), np.uint8))
        wr.release()
        fmap = np.zeros((NATIVE_H, NATIVE_W, 1, n), np.uint8)
        floc = np.zeros((NATIVE_H, NATIVE_W, 1, n), np.uint8)
        for t in range(n):
            yy, xx = rng.randint(8, NATIVE_H - 8), rng.randint(8, NATIVE_W - 8)
            if (name, t) != NO_FIXATION:
                floc[yy, xx, 0, t] = 1
            blur = np.zeros((NATIVE_H, NATIVE_W), np.float32)
            blur[yy, xx] = 255
            blur = cv2.GaussianBlur(blur, (41, 41), 10)
            fmap[:, :, 0, t] = (blur / blur.max() * 255).astype(np.uint8)
        jsavemat(os.path.join(root, "maps", name + "_fixMaps.mat"), {"fixMap": fmap})
        jsavemat(os.path.join(root, "fixations", "maps", name + "_fixPts.mat"), {"fixLoc": floc})
    splits = splits or {phase: [name] for phase, name in zip(("train", "val"), videos)}
    for phase, names in splits.items():
        with open(os.path.join(root, "txt", phase + ".txt"), "w") as f:
            f.write("".join(name + "\n" for name in names))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / DATASET)
    write_dataset(root, np.random.RandomState(0))
    return root


def _metrics(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(dataset, variables, tmp_path_factory):
    """Both trainers over the dataset: {package: (model dir, trainer)}."""
    out = {}
    base = tmp_path_factory.mktemp("runs")
    for cache in ("jax_priors", "port_priors"):
        os.makedirs(base / cache)
    jt = JTrainer(JTrainConfig(**CONFIG), dataset, DATASET, str(base / "jax"), ext=".avi",
                  pre_variables=variables, priors_cache_dir=str(base / "jax_priors"))
    jt.train()
    out["jax"] = (os.path.join(str(base / "jax"), "Tiny"), jt)
    pt = Trainer(TrainConfig(**CONFIG), dataset, DATASET, str(base / "port"), ext=".avi",
                 pre_variables=variables, priors_cache_dir=str(base / "port_priors"),
                 device="cpu")
    pt.train()
    out["port"] = (os.path.join(str(base / "port"), "Tiny"), pt)
    return out


def test_trainer_matches_jax(runs):
    """The same ob map reaches both; per epoch, the mean train and val
    losses within 1e-4 relative; the same steps logged."""
    (jdir, jt), (pdir, pt) = runs["jax"], runs["port"]
    np.testing.assert_allclose(pt.ob.numpy(), np.asarray(jt.ob), atol=1e-6, rtol=0)
    jm, pm = _metrics(jdir), _metrics(pdir)
    assert [(r["tag"], r.get("step")) for r in pm] == [(r["tag"], r.get("step")) for r in jm]
    # clips 0 and 2 of the train video (clip 1 has a frame without fixations)
    assert [r["step"] for r in pm if r["tag"] == "train/loss"] == [1, 2, 3, 4]
    epochs = [r for r in pm if r["tag"].endswith("mean_loss")]
    assert len(epochs) == 4
    for a, b in zip(jm, pm):
        assert abs(b["value"] - a["value"]) <= TOL_EPOCH_LOSS * abs(a["value"]), (a, b)
    assert pt.state.step == int(jt.state.step) == 4


def test_final_checkpoints_are_read_by_both_packages(runs):
    (jdir, _), (pdir, pt) = runs["jax"], runs["port"]
    files = {who: sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
             for who, d in (("jax", jdir), ("port", pdir))}
    for names in files.values():  # _best, _final and one per epoch, named by its val loss
        assert {"Tiny_best.ckpt", "Tiny_final.ckpt"} <= set(names) and len(names) == 4
        assert [f[:8] for f in names if f.startswith("Tiny_0")] == ["Tiny_00_", "Tiny_01_"]
    port_final = os.path.join(pdir, "Tiny_final.ckpt")
    back = jckpt.load_checkpoint(port_final)
    want = tckpt.load_checkpoint(port_final)
    assert set(back) == {"params", "batch_stats"}
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                jax.tree_util.tree_flatten_with_path(want)[0]):
        assert pa == pb and np.array_equal(np.asarray(a), b)
    # the port's model ends on the best weights, which _final holds
    final = from_jax_variables(want)
    assert all(torch.equal(final[k], v) for k, v in pt.model.state_dict().items())
    m = UAVSal(time_dims=T)
    m.load_state_dict(from_jax_variables(tckpt.load_checkpoint(
        os.path.join(jdir, "Tiny_final.ckpt"))), strict=True)


def test_jax_checkpoint_is_read_without_msgpack(tmp_path, monkeypatch, variables):
    """A file the JAX package wrote (with an optax state, a step and an
    epoch, as its epoch checkpoints hold), read by the port's codec on a
    machine with no msgpack."""
    import optax

    from iip_uavsal_saliency_tpu.parallel.steps import create_train_state
    from iip_uavsal_saliency_tpu.training.optim import make_optimizer

    state = create_train_state(variables, make_optimizer(1e-4, 5e-5))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, {"params": variables["params"],
                                 "batch_stats": variables["batch_stats"],
                                 "opt_state": state.opt_state, "step": state.step, "epoch": 3,
                                 "min_val_loss": 1.25, "num_patience": 0})
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    got = tckpt.load_checkpoint(path)
    assert got["epoch"] == 3 and got["min_val_loss"] == 1.25 and int(got["step"]) == 0
    want = jax.tree_util.tree_leaves({"params": variables["params"],
                                      "batch_stats": variables["batch_stats"]})
    have = jax.tree_util.tree_leaves({"params": got["params"],
                                      "batch_stats": got["batch_stats"]})
    assert len(have) == len(want) and all(np.array_equal(a, b) for a, b in zip(have, want))
    assert isinstance(state.opt_state[0], optax.EmptyState) or got["opt_state"]
    UAVSal(time_dims=T).load_state_dict(from_jax_variables(got), strict=True)


def _array_videos(seed):
    """In-memory videos as `Trainer(videos=...)` takes them."""
    rng = np.random.RandomState(seed)

    def video(name, n):
        maps = rng.randint(0, 255, (n, HO, WO, 1)).astype(np.uint8)
        fixs = (rng.rand(n, HO, WO, 1) < 0.1).astype(np.uint8)
        fixs[:, 3, 4] = 1
        return name, rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8), maps, fixs

    return {"train": [video("a", 15)], "val": [video("b", 10)]}


def test_resumed_run_equals_an_uninterrupted_one(tmp_path, variables):
    """Epoch checkpoints hold the optimizer state, the step and the early
    stop's bookkeeping: one epoch, then a resumed second, gives the files
    and the weights of two epochs in one run, bit for bit."""
    videos = _array_videos(1)
    ob = np.random.RandomState(2).rand(HO, WO, 20).astype(np.float32)
    cfg = dict(CONFIG, learning_rate=1e-3, method_name="R")

    def trainer(root, **kw):
        return Trainer(TrainConfig(**dict(cfg, **kw)), "", DATASET, str(tmp_path / root),
                       pre_variables=variables, device="cpu", ob_prior=ob, videos=videos)

    whole = trainer("whole")
    whole.train()
    trainer("split", epochs=1).train()
    resumed = trainer("split", resume=True)
    resumed.train()
    assert resumed.state.step == whole.state.step == 4
    files = sorted(f for f in os.listdir(tmp_path / "whole" / "R") if f.endswith(".ckpt"))
    assert files == sorted(f for f in os.listdir(tmp_path / "split" / "R") if f.endswith(".ckpt"))
    for f in files:
        a = tckpt.load_checkpoint(str(tmp_path / "whole" / "R" / f))
        b = tckpt.load_checkpoint(str(tmp_path / "split" / "R" / f))
        la, lb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in la] == [p for p, _ in lb], f
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(la, lb)), f
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


def test_cli_train_end_to_end(dataset, tmp_path):
    """`python -m iip_uavsal_saliency_tpu_torch.cli train` on the CPU, from a
    JSON config: one epoch, weights from seed 0, the final checkpoint in the
    JAX tree."""
    cfg = {"data_dir": os.path.dirname(dataset), "train_dataset": DATASET,
           "save_model_dir": str(tmp_path / "w"), "priors_cache_dir": str(tmp_path),
           "iosize": list(IOSIZE), "time_dims": T, "batch_size": 2, "epochs": 1,
           "method_name": "CLI", "shuffle_train": False}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    state = cli.cmd_train(cli.load_config(str(tmp_path / "cfg.json")), "cpu")
    assert state.step == 2
    final = jckpt.load_checkpoint(str(tmp_path / "w" / "CLI" / "CLI_final.ckpt"))
    UAVSal(time_dims=T).load_state_dict(from_jax_variables(final), strict=True)
    # the same through main(), warm-started from that checkpoint
    assert cli.main(["train", "--config", str(tmp_path / "cfg.json"), "--model-path",
                     str(tmp_path / "w" / "CLI" / "CLI_final.ckpt"), "--method_name", "CLI2",
                     "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "w" / "CLI2" / "CLI2_final.ckpt")


@pytest.mark.parametrize("flag,value,item", [
    ("videos_per_step", "2", "A.9b"), ("remat", "true", "A.9b"),
    ("model_name", "uavsal_lstm", "A.10"), ("dp_devices", "2", "A.11")])
def test_cli_train_refuses_what_the_port_does_not_have(flag, value, item, tmp_path):
    """The zoo (A.10), several videos per step and remat (A.9b), which the
    port now trains, pass through: the model is built and the run stops
    where the JAX trainer's stops without a dataset, at the missing train
    split. Data parallelism (A.11) is taken too, and refused as the JAX
    trainer refuses it where `videos_per_step` (1 here) does not split over
    the ranks, before any rank starts."""
    argv = ["train", f"--{flag}", value, "--device", "cpu",
            "--save_model_dir", str(tmp_path), "--data_dir", str(tmp_path / "none")]
    if item in ("A.9b", "A.10"):
        with pytest.raises(FileNotFoundError):
            cli.main(argv)
        return
    with pytest.raises(ValueError, match=r"videos_per_step=1 must be a multiple of the mesh "
                       r"'data' axis \(2\)"):
        cli.main(argv)


def test_trainer_needs_a_card_or_the_cpu_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(), "", DATASET, str(tmp_path))


def test_clips_of_cuts_to_time_dims_keeps_the_ragged_clip_and_skips_empty_ground_truth():
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (27, 4, 4, 3)).astype(np.uint8)
    maps = rng.randint(1, 255, (26, 2, 2, 1)).astype(np.uint8)
    fixs = np.ones((27, 2, 2, 1), np.uint8)
    maps[13] = 0  # an empty blurred map skips its clip as well
    clips = clips_of(frames, maps, fixs, clip_len=10, time_dims=5)
    assert [len(x) for x, _ in clips] == [10, 5]  # 25 frames: 10, (10 skipped), 5
    x, y = clips[1]
    assert np.array_equal(x, frames[20:25]) and y.shape == (5, 2, 2, 3)
    assert np.array_equal(y[..., 0], maps[20:25, ..., 0]) and np.all(y[..., 2] == 1)
