"""`Trainer` data-parallel on the CPU: two gloo ranks against one process,
over four in-memory train videos of 10, 15, 20 and 25 frames and two val
videos of 10, `videos_per_step=2`, 32x64, T=5, batch_size=2 (clips of 10),
2 epochs, lr 1e-7, every parameter trained, seeded `init_model` weights.

Sorted by length the groups are (10, 15) and (20, 25): rank 0 holds the
shorter video of each, which runs out a clip early and repeats its last
one masked, and the 15- and 25-frame videos end in a ragged clip padded
with the mask at 0, so the ranks step with different counts of valid
frames. The two runs' logged steps, epoch means and `_final` checkpoint
are held at the bounds of `tests/test_torch_train_multivideo_trainer.py`
(they part by f32 rounding only); only rank 0 writes; and two ranks that
resume from rank 0's first epoch checkpoint reach the uninterrupted run's
bits."""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.parallel import spawn
from iip_uavsal_saliency_tpu_torch.training import checkpoint as tckpt
from _dp_runs import train_videos
from test_torch_train_step import bn_scale, few_threads  # noqa: F401

H, W, T = 32, 64, 5
HO, WO = H // 8, W // 8
TRAIN = {"a": 20, "b": 10, "c": 25, "d": 15}
VAL = {"e": 10, "f": 10}
LR = 1e-7
CONFIG = dict(method_name="DP", iosize=(H, W, HO, WO), time_dims=T, batch_size=2, epochs=2,
              learning_rate=LR, freeze=(), shuffle_train=False, videos_per_step=2)
STEPS = 10             # train steps of the two epochs: 2 + 3 a epoch
TOL_EPOCH_LOSS = 1e-4  # relative, each epoch's mean train and val loss
TOL_STEP_LOSS = 1e-3   # relative, each train step's loss
TOL_BN_STEP = 1e-4     # a running stat, of `bn_scale` a step
TIMEOUT_S = 600


def _videos(seed):
    rng = np.random.RandomState(seed)

    def video(name, n):
        maps = rng.randint(0, 255, (n, HO, WO, 1)).astype(np.uint8)
        fixs = (rng.rand(n, HO, WO, 1) < 0.1).astype(np.uint8)
        fixs[:, 2, 3] = 1
        return name, rng.randint(0, 256, (n, H, W, 3)).astype(np.uint8), maps, fixs

    return {"train": [video(k, n) for k, n in TRAIN.items()],
            "val": [video(k, n) for k, n in VAL.items()]}


def _metrics(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpts(model_dir):
    return sorted(f for f in os.listdir(model_dir) if f.endswith(".ckpt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks: the whole run into `dp`, then a resume into
    `resumed` from rank 0's first epoch checkpoint; and, while it runs, the
    one-process run into `one`."""
    base = tmp_path_factory.mktemp("dp_trainer")
    weights = to_jax_variables(
        init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(0)).state_dict())
    common = {"weights": weights, "videos": _videos(1),
              "ob": np.random.RandomState(2).rand(HO, WO, 20).astype(np.float32)}
    dp_dir = str(base / "dp" / "DP")
    whole = dict(common, config=CONFIG, save_model_dir=str(base / "dp"))
    resumed = dict(common, config=dict(CONFIG, resume=True),
                   save_model_dir=str(base / "resumed"),
                   resume_from=(dp_dir, ("DP_00_", "DP_best.ckpt")))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, train_videos, 2, "gloo", ([whole, resumed],),
                            timeout_s=TIMEOUT_S, deadline_s=TIMEOUT_S, threads=2)
        one = train_videos(None, [dict(common, config=CONFIG,
                                       save_model_dir=str(base / "one"))])[0]
        ranks = ranks.result()
    return {"base": base, "one": one, "ranks": ranks, "dp_dir": dp_dir,
            "one_dir": str(base / "one" / "DP"), "resumed_dir": str(base / "resumed" / "DP")}


def test_two_ranks_train_as_one_process(runs):
    one, (r0, r1) = runs["one"], [r[0] for r in runs["ranks"]]
    assert r0["step"] == r1["step"] == one["step"] == STEPS
    assert r0["digest"] == r1["digest"], "the replicas differ"
    dm, om = _metrics(runs["dp_dir"]), _metrics(runs["one_dir"])
    assert [(m["tag"], m.get("step")) for m in dm] == [(m["tag"], m.get("step")) for m in om]
    for a, b in zip(om, dm):
        tol = TOL_STEP_LOSS if a["tag"] == "train/loss" else TOL_EPOCH_LOSS
        assert abs(b["value"] - a["value"]) <= tol * abs(a["value"]), (a, b)
    assert [f[:6] for f in _ckpts(runs["dp_dir"])] == [f[:6] for f in _ckpts(runs["one_dir"])]
    want = from_jax_variables(tckpt.load_checkpoint(os.path.join(runs["one_dir"],
                                                                 "DP_final.ckpt")))
    got = from_jax_variables(tckpt.load_checkpoint(os.path.join(runs["dp_dir"],
                                                                "DP_final.ckpt")))
    stats = {k: v.double().numpy() for k, v in want.items()}
    for name, w in want.items():
        a, b = got[name].double().numpy(), w.double().numpy()
        if "running" in name:
            assert np.abs(a - b).max() <= TOL_BN_STEP * STEPS * bn_scale(name, stats), name
        else:
            ulp = np.spacing(np.float32(np.abs(b).max()))
            assert np.abs(a - b).max() <= 2 * LR * STEPS + 2 * ulp, name


def test_only_rank_zero_writes(runs):
    (r0, r1) = [r[0] for r in runs["ranks"]]
    assert r0["writes"] and not r1["writes"]
    # a second writer would have doubled the metrics file (it appends)
    assert len(_metrics(runs["dp_dir"])) == len(_metrics(runs["one_dir"]))


def test_ranks_resume_from_rank_zeros_checkpoint(runs):
    whole, resumed = runs["ranks"][0]
    assert resumed["step"] == whole["step"] == STEPS
    assert [r[1]["digest"] for r in runs["ranks"]] == [whole["digest"]] * 2
    assert _ckpts(runs["resumed_dir"]) == _ckpts(runs["dp_dir"])
