"""Epoch checkpoints that both packages resume, on the CPU: a synthetic
dataset in the reference layout (`tests/test_torch_train_trainer.py`'s
`write_dataset`), one train and one val video of 10 frames, 64x128 input,
T=5, batch_size=2 (one step an epoch), 2 epochs, lr 1e-7 (two f32 trajectories part after the first Adam step at
the default rate, `tests/test_torch_train_step.py`), the same starting
variables, no shuffle, an empty priors cache for each run. Each case is a
freeze setting and a weight decay, which change optax's state layout: no
freeze and a decay of 5e-5 here; no decay, the JAX default freeze list,
and both, in `tests/test_torch_train_resume_{no_decay,freeze,
freeze_no_decay}.py` (`CASE`), so that the four compile in four workers.

Per case the JAX trainer runs 2 epochs without a break. Its epoch-0
checkpoint, beside a `_best.ckpt` of the weights it holds (what a 1-epoch
run leaves: the first epoch is always the best so far), is resumed by the
port for the second epoch; the port's own 1-epoch run is resumed by the
JAX trainer. Both are held to the uninterrupted run: the epoch means
within 1e-4, the weights of `_final` and of the epoch-1 checkpoint within
2 lr a step (and their f32 rounding), the BatchNorm stats within twice
`tests/test_torch_train_step.py`'s bound a step (each package's f32
stats lie within it of the exact ones after a step), Adam's first
moments within twice that file's gradient bound and the second within four
times it (relative L2: each package's gradient lies within it of the
exact one, and the second moment averages squares, which double a
relative error), the step count exact.
The port's `opt_state` has the keys, in order, the shapes and the dtypes
of `flax.serialization.to_state_dict` of the JAX state, and the port's
own earlier layout still resumes, to the bit of the new layout."""

import json
import os
import shutil

import flax.serialization
import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from iip_uavsal_saliency_tpu.training.trainer import TrainConfig as JTrainConfig  # noqa: E402
from iip_uavsal_saliency_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer  # noqa: E402
from test_torch_train_step import TOL_BN, TOL_GRAD, bn_scale, few_threads, variables  # noqa: E402,F401
from test_torch_train_trainer import DATASET, write_dataset  # noqa: E402

LR = 1e-7
TOL_EPOCH_LOSS = 1e-4  # relative
STEPS = 2              # one train step an epoch
CONFIG = dict(method_name="Res", iosize=(64, 128, 8, 16), time_dims=5, batch_size=2, epochs=2,
              learning_rate=LR, shuffle_train=False)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / DATASET)
    write_dataset(root, np.random.RandomState(4), {"v_train": 10, "v_val": 10})
    return root


def _metrics(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _epoch_ckpt(model_dir, epoch):
    return os.path.join(model_dir, next(f for f in sorted(os.listdir(model_dir))
                                        if f.startswith(f"Res_{epoch:02d}_")))


def run_case(base, dataset, variables, freeze, decay):
    """The runs of one case: {name: (model dir, trainer)} for "jax" (2
    epochs), "port<-jax" (the port resuming the JAX epoch 0), "port" (the
    port's epoch 0), "jax<-port" (the JAX trainer resuming it),
    "port<-port" (the port resuming it) and "port<-legacy" (the port
    resuming it rewritten in the port's own optimizer layout)."""
    cfg = dict(CONFIG, freeze=freeze, weight_decay=decay)
    runs = {}

    def run(name, package, **kw):
        model_dir = os.path.join(base, name)
        os.makedirs(os.path.join(base, name + "_priors"), exist_ok=True)
        common = dict(ext=".avi", pre_variables=variables,
                      priors_cache_dir=os.path.join(base, name + "_priors"))
        if package == "jax":
            trainer = JTrainer(JTrainConfig(**dict(cfg, **kw)), dataset, DATASET, model_dir,
                               **common)
        else:
            trainer = Trainer(TrainConfig(**dict(cfg, **kw)), dataset, DATASET, model_dir,
                              device="cpu", **common)
        trainer.train()
        runs[name] = (os.path.join(model_dir, "Res"), trainer)

    def epoch0(src, name, opt_state=None):
        """A model dir holding `src`'s epoch-0 checkpoint file (rewritten
        with `opt_state` for its optimizer where given) and a `_best` of its
        weights."""
        dst = os.path.join(base, name, "Res")
        os.makedirs(dst)
        path = os.path.join(dst, os.path.basename(_epoch_ckpt(src, 0)))
        ckpt = tckpt.load_checkpoint(_epoch_ckpt(src, 0))
        if opt_state is None:
            shutil.copyfile(_epoch_ckpt(src, 0), path)
        else:
            tckpt.save_checkpoint(path, dict(ckpt, opt_state=opt_state))
        tckpt.save_checkpoint(os.path.join(dst, "Res_best.ckpt"),
                              {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]})

    run("jax", "jax")
    epoch0(runs["jax"][0], "port<-jax")
    run("port<-jax", "port", resume=True)
    run("port", "port", epochs=1)
    port_dir, port = runs["port"]
    epoch0(port_dir, "jax<-port")
    run("jax<-port", "jax", resume=True)
    epoch0(port_dir, "port<-port")
    run("port<-port", "port", resume=True)
    names = {p: n for n, p in port.model.named_parameters()}
    legacy = {names[p]: {k: v.numpy() for k, v in st.items()}
              for p, st in port.state.optimizer.state.items()}
    epoch0(port_dir, "port<-legacy", legacy)
    run("port<-legacy", "port", resume=True)
    return runs


CASE = ((), 5e-5)  # (freeze, weight decay) of the module's case


@pytest.fixture(scope="module")
def case(request, dataset, variables, tmp_path_factory):
    """(freeze, decay, runs) of the module's `CASE`; the runs' checkpoints
    (about 2 GB) are removed after its tests."""
    freeze, decay = request.module.CASE
    base = str(tmp_path_factory.mktemp("resume"))
    yield freeze, decay, run_case(base, dataset, variables, freeze, decay)
    shutil.rmtree(base, ignore_errors=True)


def _state(path):
    """{port name: f64 array} of a checkpoint's parameters and BN stats."""
    return {k: v.double().numpy() for k, v in from_jax_variables(
        tckpt.load_checkpoint(path)).items()}


def _adam(opt_state):
    tree = opt_state["inner_states"]["train"]["inner_state"] if "inner_states" in opt_state \
        else opt_state
    return tree["1"]


def _leaves(tree):
    return [np.asarray(a, np.float64).ravel() for a in jax.tree_util.tree_leaves(tree)]


def held_to_uninterrupted(runs, resumed):
    """The resumed run's second epoch against the JAX trainer's
    uninterrupted one (module docstring)."""
    want_dir, _ = runs["jax"]
    got_dir, trainer = runs[resumed]
    assert int(trainer.state.step) == STEPS
    want = [r for r in _metrics(want_dir) if r["tag"].endswith("mean_loss") and r["step"] == 1]
    got = [r for r in _metrics(got_dir) if r["tag"].endswith("mean_loss") and r["step"] == 1]
    assert [r["tag"] for r in got] == [r["tag"] for r in want] == ["train/mean_loss",
                                                                   "val/mean_loss"]
    for a, b in zip(want, got):
        assert abs(b["value"] - a["value"]) <= TOL_EPOCH_LOSS * abs(a["value"]), (resumed, a, b)
    for want_path, got_path in ((os.path.join(want_dir, "Res_final.ckpt"),
                                 os.path.join(got_dir, "Res_final.ckpt")),
                                (_epoch_ckpt(want_dir, 1), _epoch_ckpt(got_dir, 1))):
        a, b = _state(want_path), _state(got_path)
        for n, ref in a.items():
            if "running" in n:
                assert np.abs(b[n] - ref).max() <= 2 * STEPS * TOL_BN * bn_scale(n, a), (resumed, n)
            else:
                ulp = np.spacing(np.float32(np.abs(ref).max()))
                assert np.abs(b[n] - ref).max() <= 2 * LR * STEPS + 2 * ulp, (resumed, n)
    want_opt = _adam(tckpt.load_checkpoint(_epoch_ckpt(want_dir, 1))["opt_state"])
    got_opt = _adam(tckpt.load_checkpoint(_epoch_ckpt(got_dir, 1))["opt_state"])
    assert int(got_opt["count"]) == int(want_opt["count"]) == STEPS
    for key, tol in (("mu", 2 * TOL_GRAD), ("nu", 4 * TOL_GRAD)):
        a, b = np.concatenate(_leaves(want_opt[key])), np.concatenate(_leaves(got_opt[key]))
        assert np.linalg.norm(b - a) <= tol * np.linalg.norm(a), (resumed, key)


def test_port_resumes_a_jax_run(case):
    held_to_uninterrupted(case[2], "port<-jax")


def test_jax_resumes_a_port_run(case):
    held_to_uninterrupted(case[2], "jax<-port")


def _layout(tree):
    """The tree's structure: nested keys in order, leaves as (shape, dtype)."""
    if isinstance(tree, dict):
        return [(k, _layout(v)) for k, v in tree.items()]
    a = np.asarray(tree)
    return (a.shape, a.dtype.name)


def test_opt_state_has_the_jax_layout(case):
    """The port's epoch checkpoint against `to_state_dict` of the JAX
    trainer's state (which its own epoch checkpoint serializes): the same
    keys in the same order (frozen leaves as optax's empty `MaskedNode`),
    shapes (conv moments in HWIO) and dtypes (f32 moments, an int32
    count), and the same values up to the two packages' gradients."""
    freeze, _, runs = case
    jax_state = flax.serialization.to_state_dict(runs["jax"][1].state.opt_state)
    port = tckpt.load_checkpoint(_epoch_ckpt(runs["port<-jax"][0], 1))["opt_state"]
    assert _layout(port) == _layout(jax_state)
    assert ("inner_states" in port) == bool(freeze)
    count = _adam(port)["count"]
    assert count.dtype == np.int32 and count.shape == () and int(count) == STEPS
    for key, tol in (("mu", 2 * TOL_GRAD), ("nu", 4 * TOL_GRAD)):
        a = np.concatenate(_leaves(_adam(jax_state)[key]))
        b = np.concatenate(_leaves(_adam(port)[key]))
        assert np.linalg.norm(b - a) <= tol * np.linalg.norm(a), key
    # the JAX trainer reads it back into its own state
    restored = flax.serialization.from_state_dict(runs["jax"][1].state.opt_state, port)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(
        runs["jax"][1].state.opt_state)


def test_the_ports_own_earlier_layout_still_resumes(case):
    """An epoch checkpoint with the optimizer in the port's earlier layout
    ({parameter name: {step, exp_avg, exp_avg_sq}}) resumes to the bit of
    the same checkpoint in optax's layout."""
    runs = case[2]
    for name in ("Res_final.ckpt", "Res_best.ckpt"):
        a = tckpt.load_checkpoint(os.path.join(runs["port<-port"][0], name))
        b = tckpt.load_checkpoint(os.path.join(runs["port<-legacy"][0], name))
        assert all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    sa = runs["port<-port"][1].model.state_dict()
    for k, v in runs["port<-legacy"][1].model.state_dict().items():
        assert torch.equal(v, sa[k]), k
