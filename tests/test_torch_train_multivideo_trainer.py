"""The port's `Trainer` with `videos_per_step=2` against the JAX package's
`Trainer(videos_per_step=2)` without a mesh, on the CPU: a synthetic
dataset in the reference layout (`tests/test_torch_train_trainer.py`'s
`write_dataset`) of three train videos of 25, 10 and 15 frames (listed in
that order) and one val video of 10, 32x64 input (the smallest the
flagship takes), T=5, batch_size=2 (clips of S=10), 2 epochs, every
parameter trained, no shuffle, the same starting variables, an empty
priors cache for each, lr 1e-7 (two f32 trajectories part after the first
Adam step at the default rate, see `tests/test_torch_train_step.py`).

Sorted by length, the groups are (10, 15) and (25, filler): the 15-frame
video's second clip is a ragged 5 right-padded to 10, the 10-frame video
runs out after one clip and repeats it masked, the 25-frame video's last
clip is ragged, and the last group is filled with a fully masked copy of
its video. The val phase runs in lock-step too (one group).

Each epoch's mean train and val losses are held within 1e-4 of the JAX
package's, each step's loss within `TOL_STEP_LOSS`: on a masked batch
(whose loss sums 5 frames) the JAX package's f32 step lies farther from
the exact answer than 1e-4. Measured: per step the packages' f32 losses
read up to 3.3e-4 apart, the epoch means up to 6.6e-5 (train) and 2.7e-5
(val); on the first batch the JAX package's f32 loss lies 1.75e-5 from the
port's f64 loss and the port's f32 5.3e-6 (at 64x128: 1.1e-4 and 1.05e-6,
with the JAX model in f64 2.6e-7 from the port's f64, its frames
normalized in f64 where the port's are in f32). The port's first loss is
held within `TOL_EXACT` of its own f64 run on the same batch."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from iip_uavsal_saliency_tpu.training import checkpoint as jckpt  # noqa: E402
from iip_uavsal_saliency_tpu.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from iip_uavsal_saliency_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from iip_uavsal_saliency_tpu_torch.data import video as tvideo  # noqa: E402
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training.trainer import (TrainConfig, Trainer,  # noqa: E402
                                                            clips_of)
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training.steps import _loss, _maybe_normalize  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss  # noqa: E402
from test_torch_train_step import T, bn_scale, few_threads, variables  # noqa: E402,F401
from test_torch_train_trainer import CONFIG, DATASET, write_dataset  # noqa: E402

VIDEOS = {"v_long": 25, "v_short": 10, "v_mid": 15, "v_val": 10}
SPLITS = {"train": ["v_long", "v_short", "v_mid"], "val": ["v_val"]}
BUCKETED = ["v_short.avi", "v_mid.avi", "v_long.avi"]
H, W, HO, WO = 32, 64, 4, 8
MULTI = dict(CONFIG, method_name="Multi", videos_per_step=2, iosize=(H, W, HO, WO))
TOL_EPOCH_LOSS = 1e-4  # relative: each epoch's mean train and val loss
TOL_STEP_LOSS = 1e-3   # relative: each train step's loss (module docstring)
TOL_EXACT = 1e-5       # relative: the port's first f32 loss from its f64 run
LR = MULTI["learning_rate"]
# the `_final` checkpoints: each parameter within 2 lr a step (an Adam step
# moves a coordinate by about lr, and one whose gradient sits at the noise
# level may step the other way in the other package) and its f32 rounding;
# each BatchNorm stat within the train step test's bound of `bn_scale` a step (each train
# step moves the stats by an EMA of f32 batch statistics, which part
# between the packages as in `tests/test_torch_train_step.py`)
TOL_BN_STEP = 1e-4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / DATASET)
    write_dataset(root, np.random.RandomState(3), VIDEOS, SPLITS)
    return root


def _metrics(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(dataset, variables, tmp_path_factory):
    """Both trainers over the dataset: {package: (model dir, trainer)};
    their checkpoints are removed after the module's tests."""
    base = tmp_path_factory.mktemp("runs")
    out = {}
    for who, make in (("jax", lambda c, d, **kw: JTrainer(JTrainConfig(**c), d, DATASET, **kw)),
                      ("port", lambda c, d, **kw: Trainer(TrainConfig(**c), d, DATASET,
                                                          device="cpu", **kw))):
        os.makedirs(base / f"{who}_priors")
        trainer = make(MULTI, dataset, save_model_dir=str(base / who), ext=".avi",
                       pre_variables=variables, priors_cache_dir=str(base / f"{who}_priors"))
        trainer.train()
        out[who] = (str(base / who / "Multi"), trainer)
    yield out
    shutil.rmtree(base, ignore_errors=True)


def test_two_video_trainer_matches_jax(runs, variables, monkeypatch):
    """The same steps logged (5 train steps an epoch: 2 for the first
    group, 3 for the second), the losses within the bounds of the module
    docstring, and the `_final` weights within the bounds above."""
    (jdir, jt), (pdir, pt) = runs["jax"], runs["port"]
    jm, pm = _metrics(jdir), _metrics(pdir)
    assert [(r["tag"], r.get("step")) for r in pm] == [(r["tag"], r.get("step")) for r in jm]
    assert [r["step"] for r in pm if r["tag"] == "train/loss"] == list(range(1, 11))
    assert pt.state.step == int(jt.state.step) == 10
    for a, b in zip(jm, pm):
        tol = TOL_STEP_LOSS if a["tag"] == "train/loss" else TOL_EPOCH_LOSS
        assert abs(b["value"] - a["value"]) <= tol * abs(a["value"]), (a, b)
    # the port's first train loss against its f64 run on the same batch
    x, y = next((x, y) for phase, x, y in _record_steps(pt, monkeypatch, "train"))
    model = UAVSal(time_dims=T)
    model.load_state_dict(from_jax_variables(variables))
    model = model.double().train()
    out, _ = model(_maybe_normalize(torch.from_numpy(x)).double(), pt.gauss.double(),
                   pt.ob.double(), model.init_state(H, W, 2, dtype=torch.float64))
    exact = float(_loss(_masked_loss(loss_fu), out, torch.from_numpy(y).double()))
    first = next(r["value"] for r in pm if r["tag"] == "train/loss")
    print(f"first train loss: port {abs(first - exact) / exact:.3g}, JAX package "
          f"{abs(jm[0]['value'] - exact) / exact:.3g} from the port's f64 run")
    assert abs(first - exact) <= TOL_EXACT * exact
    files = {who: sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
             for who, d in (("jax", jdir), ("port", pdir))}
    assert [f[:9] for f in files["port"]] == [f[:9] for f in files["jax"]]
    jf = from_jax_variables(jckpt.load_checkpoint(os.path.join(jdir, "Multi_final.ckpt")))
    pf = tckpt.load_checkpoint(os.path.join(pdir, "Multi_final.ckpt"))
    pf = from_jax_variables(pf)
    worst = {}
    for name, want in jf.items():
        a, b = pf[name].double().numpy(), want.double().numpy()
        if "running" in name:
            err = np.abs(a - b).max() / bn_scale(name, {k: v.numpy() for k, v in jf.items()})
            bound = TOL_BN_STEP * 10
        else:
            err = np.abs(a - b).max()
            bound = 2 * LR * 10 + 2 * np.spacing(np.float32(np.abs(b).max()))
        worst[name] = err / bound
        assert err <= bound, (name, err, bound)
    print("largest share of its bound:", max(worst.values()), max(worst, key=worst.get))


def _record_steps(trainer, monkeypatch, phase=None):
    """Replace the trainer's step by a recorder of (phase, x, y) on the
    host; with `phase`, run that phase's epoch."""
    seen = []

    def step(phase, x, y, rnn_state):
        seen.append((phase, x.numpy().copy(), y.numpy().copy()))
        return 0.0, rnn_state

    monkeypatch.setattr(trainer, "_step", step)
    monkeypatch.setattr(trainer.metrics, "scalar", lambda *args: None)
    if phase:
        trainer._run_epoch(phase)
    return seen


def test_length_bucketing_order_and_header_cache(dataset, tmp_path, monkeypatch):
    """The split is stably sorted by the header's frame count before
    grouping (the long video, first in the split's name order, goes to the
    last group, as `tests/test_pipeline.py` holds the JAX trainer to), each header probed
    once across epochs and phases; an unreadable header keeps list order."""
    trainer = Trainer(TrainConfig(**MULTI), dataset, DATASET, str(tmp_path), ext=".avi",
                      priors_cache_dir=str(tmp_path), device="cpu",
                      ob_prior=np.zeros((HO, WO, 20), np.float32))
    seen, probed = [], []
    orig, probe = trainer._video_clips, tvideo.probe_nframes

    def spy(vp, mp, fp, max_frames, **kw):
        seen.append(os.path.basename(vp))
        return orig(vp, mp, fp, max_frames, **kw)

    monkeypatch.setattr(trainer, "_video_clips", spy)
    monkeypatch.setattr(tvideo, "probe_nframes", lambda p: probed.append(p) or probe(p))
    _record_steps(trainer, monkeypatch)
    trainer._run_epoch("train")
    trainer._run_epoch("train")
    assert seen == BUCKETED * 2, seen
    assert len(probed) == 3 and len(set(probed)) == 3

    def unreadable(path):
        raise OSError("no header")

    monkeypatch.setattr(tvideo, "probe_nframes", unreadable)
    trainer._nframes_cache.clear()
    seen.clear()
    trainer._run_epoch("train")
    assert seen == [v + ".avi" for v in sorted(SPLITS["train"])], seen  # the split's order


def _arrays(dataset, names):
    """The split decoded and letterboxed as the file entry does, as
    `Trainer(videos=...)` takes it."""
    out = []
    for name in names:
        frames, n, _, _ = tvideo.preprocess_videos(os.path.join(dataset, "Videos", name + ".avi"),
                                                   H, W)
        maps = tvideo.preprocess_vidmaps(os.path.join(dataset, "maps", name + "_fixMaps.mat"),
                                         HO, WO)
        fixs = tvideo.preprocess_vidfixs(
            os.path.join(dataset, "fixations", "maps", name + "_fixPts.mat"), HO, WO)
        out.append((name, frames[:n], maps, fixs))
    return out


def test_array_entry_gives_the_file_entry_batches(dataset, tmp_path, monkeypatch):
    """`Trainer(videos=...)` buckets by the arrays' frame counts and gives
    the file entry's batches bit for bit. The batches themselves: the
    ragged clips padded with their last frame and masked there, the
    exhausted video's clip repeated fully masked, the filler video masked
    throughout, one zero state a group."""
    ob = np.zeros((HO, WO, 20), np.float32)
    kw = dict(priors_cache_dir=str(tmp_path), device="cpu", ob_prior=ob)
    by_file = Trainer(TrainConfig(**MULTI), dataset, DATASET, str(tmp_path / "f"), ext=".avi",
                      **kw)
    by_array = Trainer(TrainConfig(**MULTI), "", DATASET, str(tmp_path / "a"),
                       videos={p: _arrays(dataset, v) for p, v in SPLITS.items()}, **kw)
    runs = []
    for trainer in (by_file, by_array):
        seen = _record_steps(trainer, monkeypatch)
        trainer._run_epoch("train")
        trainer._run_epoch("val")
        runs.append(seen)
    assert len(runs[0]) == len(runs[1]) == 6
    for (pa, xa, ya), (pb, xb, yb) in zip(*runs):
        assert pa == pb and np.array_equal(xa, xb) and np.array_equal(ya, yb)
    masks = [y[:, :, 0, 0, 2] for _, _, y in runs[0]]  # (V, S) per step
    full, half = np.ones(10), np.r_[np.ones(5), np.zeros(5)]
    # group (v_short, v_mid): v_short's one clip, then repeated masked
    assert np.array_equal(masks[0], [full, full]) and np.array_equal(masks[1], [0 * full, half])
    assert np.array_equal(runs[0][1][1][0], runs[0][0][1][0])  # the repeat is its last clip
    x_mid = runs[0][1][1][1]
    assert all(np.array_equal(x_mid[t], x_mid[4]) for t in range(5, 10))  # padded with frame 4
    # group (v_long, filler): 10, 10, ragged 5; the filler masked throughout
    assert [m[0].tolist() for m in masks[2:5]] == [full.tolist(), full.tolist(), half.tolist()]
    assert all(not m[1].any() for m in masks[2:6])
    assert all(np.array_equal(x[0], x[1]) for _, x, _ in runs[0][2:5])


def test_clips_of_pads_the_ragged_clip_only_when_asked():
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (27, 4, 4, 3)).astype(np.uint8)
    maps = rng.randint(1, 255, (27, 2, 2, 1)).astype(np.uint8)
    fixs = np.ones((27, 2, 2, 1), np.uint8)
    plain = clips_of(frames, maps, fixs, clip_len=10, time_dims=5)
    padded = clips_of(frames, maps, fixs, clip_len=10, time_dims=5, pad_ragged=True)
    assert [len(x) for x, _ in plain] == [10, 10, 5] and [len(x) for x, _ in padded] == [10] * 3
    for (xa, ya), (xb, yb) in zip(plain[:2], padded[:2]):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    x, y = padded[2]
    assert np.array_equal(x[:5], plain[2][0]) and all(np.array_equal(f, x[4]) for f in x[5:])
    assert np.array_equal(y[:5], plain[2][1]) and np.array_equal(y[5:, ..., :2],
                                                                   np.repeat(y[4:5, ..., :2], 5, 0))
    assert np.all(y[:5, ..., 2] == 1) and np.all(y[5:, ..., 2] == 0)
    assert all(y.dtype == np.float32 for _, y in plain)
    torch.testing.assert_close(torch.from_numpy(plain[2][1]), torch.from_numpy(y[:5]))


def test_cli_train_lockstep_with_remat_then_resumed(dataset, tmp_path):
    """`cli train --videos_per_step 2 --remat true --device cpu` for one
    epoch, then `--resume true` for a second: 5 lock-step steps an epoch,
    the epoch checkpoints in optax's layout (the default freeze list:
    `multi_transform`) with Adam's count at the steps taken."""
    from iip_uavsal_saliency_tpu_torch import cli

    cfg = {"data_dir": os.path.dirname(dataset), "train_dataset": DATASET,
           "save_model_dir": str(tmp_path / "w"), "priors_cache_dir": str(tmp_path),
           "iosize": [H, W, HO, WO], "time_dims": T, "batch_size": 2, "epochs": 1,
           "method_name": "CLI", "shuffle_train": False}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    argv = ["train", "--config", str(tmp_path / "cfg.json"), "--videos_per_step", "2",
            "--remat", "true", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert cli.main(argv + ["--resume", "true", "--epochs", "2"]) == 0
    model_dir = tmp_path / "w" / "CLI"
    epochs = sorted(f for f in os.listdir(model_dir) if f.startswith("CLI_0"))
    assert [f[:6] for f in epochs] == ["CLI_00", "CLI_01"]
    for k, f in enumerate(epochs):
        ckpt = tckpt.load_checkpoint(str(model_dir / f))
        adam = ckpt["opt_state"]["inner_states"]["train"]["inner_state"]["1"]
        assert adam["count"].dtype == np.int32 and int(adam["count"]) == 5 * (k + 1)
        assert int(ckpt["step"]) == 5 * (k + 1) and ckpt["epoch"] == k
    assert os.path.exists(model_dir / "CLI_final.ckpt")
