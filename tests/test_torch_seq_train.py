"""The seq train step on gloo ranks, UAVSal with time_dims=4, one step
from the seeded variables of `tests/test_torch_train_step.py` with a
random carried state.

- f32 over `make_mesh(n_data=1, n_seq=2)` and `(1, 1, 4)` at 64x128, V=1,
  S=12 (six and three frames a rank: groups of four that straddle ranks):
  the ranks' step and the JAX package's `make_train_step` over the same
  mesh are each held to the port's one-process f64 step from the same
  point at the bounds of `tests/test_torch_train_step.py`
  (its docstring: an f32 run's drift through ~100 train-mode BatchNorms):
  the loss, the gradient (whole and per leaf), the BatchNorm running stats
  and the carried state; the two f32 runs' parameters after Adam within 2
  lr of each other.
- f64 against the port's one-process f64 step within `TOL_EXACT`: the
  loss, every gradient leaf (against the larger of its largest entry and
  1e-4 of the whole gradient's), the BatchNorm running stats (against
  `bn_scale`), the carried state and the parameters after Adam. At 32x64,
  S=12: n_seq=2 (six frames a rank: the second group of four lies across
  the two), n_seq=4 with `remat` (three frames a rank; the recompute runs
  the forward's exchanges and the TWA chain again inside the backward) and
  a 2x2 data x seq mesh with V=2. At 64x128, S=4: n_seq=4, a rank of one
  frame (its frame differences read both neighbours, and the one group
  spans every rank; at 32x64 that batch's BatchNorms are too
  ill-conditioned to hold 1e-10: 9.6e-10 there). The train-mode
  BatchNorms count each row once: the context's groups over the data axis
  (every seq rank holds them all), the rest over the whole mesh. This host
  reads 1.1e-11 on a gradient leaf. The rate is 1e-7, as
  `tests/test_torch_dp_train.py` says why. Every rank ends with the same
  parameters and the same state.

All the ranks' work is one spawn of 4 ranks (two idle on a mesh of two),
started first; this process runs the JAX steps and the one-process f64
steps while the ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.parallel.mesh import make_mesh as j_make_mesh
from iip_uavsal_saliency_tpu.parallel.steps import create_train_state as j_create
from iip_uavsal_saliency_tpu.parallel.steps import make_train_step as j_make_train_step
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu_torch.parallel import spawn
from _dp_runs import train_steps
from _seq_runs import assemble_state
from _spatial_runs import run_jobs
from test_torch_dp_train import _leaf_errors, normalized64
from test_torch_train_step import (LR, TOL_BN, TOL_GRAD, TOL_GRAD_LEAF, TOL_LOSS,  # noqa: F401
                                   TOL_STATE, WD, _adam, _err, _l2, _port_named, bn_scale,
                                   clip_data, few_threads, priors, variables)

T, S, H, W = 4, 12, 64, 128
F32_MESHES = {"1x1x2": (1, 1, 2), "1x1x4": (1, 1, 4)}  # the f32 runs, at S
SMALL = (32, 64)
EXACT_LR = 1e-7
TOL_EXACT = 1e-10
TIMEOUT_S = 600


def _batch(v=1, s=S, h=H, w=W):
    x, y = clip_data(31, h, w, s)
    x = np.concatenate([x] + [np.roll(x, 5 * i, axis=3) for i in range(1, v)], 0)
    y = np.concatenate([y] + [np.roll(y, i, axis=3) for i in range(1, v)], 0)
    state = np.random.RandomState(12).normal(0.0, 0.5, (v, h // 8, w // 8, 256))
    return x, y, state.astype(np.float32)


def _run(variables, mesh, dtype, v=1, s=S, remat=False, size=(H, W)):
    f64 = dtype == "float64"
    h, w = size
    x, y, state = _batch(v, s, h, w)
    g, o = priors(ho=h // 8, wo=w // 8)
    weights = {n: a.astype(np.float32)
               for n, a in _port_named(variables["params"], variables["batch_stats"]).items()}
    return {"mesh": mesh, "model": {"time_dims": T}, "weights": weights, "dtype": dtype,
            "lr": EXACT_LR if f64 else LR, "wd": WD, "rnn": state, "gauss": g, "ob": o,
            "clips": [(normalized64(x) if f64 else x, y)], "remat": remat}


def jax_mesh_step(variables, n_seq):
    """The JAX step over a 1x1x`n_seq` mesh: (loss, gradients by port name,
    state_dict after, TWA state after)."""
    mesh = j_make_mesh(n_data=1, n_seq=n_seq, devices=jax.devices()[:n_seq])
    model = JUAVSal(time_dims=T)
    tx = j_make_optimizer(LR, WD)
    step = j_make_train_step(model, tx, mesh=mesh, donate=False)
    state = j_create(variables, tx)
    x, y, rnn = _batch()
    g, o = priors()
    p0 = _port_named(state.params, state.batch_stats)
    state, loss, rnn = step(state, x, g, o, rnn, y)
    mu1 = _port_named(_adam(state.opt_state).mu, state.batch_stats, state.params)
    grads = {n: mu1[n] / 0.1 - WD * p0[n] for n in mu1 if "running" not in n}  # Adam's mu_0 = 0
    return (float(loss), grads, _port_named(state.params, state.batch_stats),
            np.asarray(rnn).astype(np.float64))


# name -> (mesh, V, S, remat, size) of the f64 runs; each is held to the
# one-process step of its (V, S, size)
EXACT = {"1x1x2": ((1, 1, 2), 1, S, False, SMALL),
         "1x1x4_remat": ((1, 1, 4), 1, S, True, SMALL),
         "2x1x2": ((2, 1, 2), 2, S, False, SMALL),
         "1x1x4_one_frame": ((1, 1, 4), 1, 4, False, (H, W))}


@pytest.fixture(scope="module")
def world(variables):
    exact = {name: _run(variables, mesh, "float64", v, s, remat, size)
             for name, (mesh, v, s, remat, size) in EXACT.items()}
    runs = [_run(variables, mesh, "float32") for mesh in F32_MESHES.values()]
    runs += list(exact.values())
    singles = sorted({(v, s, size) for _, v, s, _, size in EXACT.values()} | {(1, S, (H, W))})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, run_jobs, 4, "gloo", ([("train_steps", runs)],),
                            timeout_s=TIMEOUT_S, deadline_s=TIMEOUT_S, threads=1)
        jax_train = {name: jax_mesh_step(variables, mesh[2])
                     for name, mesh in F32_MESHES.items()}
        one = dict(zip(singles, train_steps(None, [
            _run(variables, None, "float64", v, s, size=size) for v, s, size in singles])))
        ranks = ranks.result()
    return {"ranks": [[r[0][i] for r in ranks if r[0][i]["coords"] is not None]
                      for i in range(len(runs))],
            "jax": jax_train, "one": one}


@pytest.mark.parametrize("job,mesh", enumerate(F32_MESHES))
def test_seq_f32_step_and_the_jax_mesh_step_hold_the_f64_step(world, job, mesh):
    ranks, one = world["ranks"][job], world["one"][(1, S, (H, W))]
    l64, g64, sd64, s64 = one["losses"][0], one["grads"][0], one["after"], one["rnn"][0]
    port = (ranks[0]["losses"][0], ranks[0]["grads"][0], ranks[0]["after"],
            assemble_state(ranks, "rnn", 0))
    for who, (loss, grads, sd, state) in (("jax", world["jax"][mesh]), ("port", port)):
        assert abs(loss - l64) / abs(l64) <= TOL_LOSS, who
        assert _l2(grads, g64) <= TOL_GRAD, who
        floor = 1e-4 * np.sqrt(sum((g ** 2).sum() for g in g64.values()))
        for n in g64:
            assert _l2(grads[n], g64[n], floor) <= TOL_GRAD_LEAF, (who, n)
        for n in sd64:
            if "running" in n:
                assert _err(sd[n], sd64[n], bn_scale(n, sd64)) <= TOL_BN, (who, n)
        assert _err(state, s64, 1.0) <= TOL_STATE, who
    jsd = world["jax"][mesh][2]
    for n in jsd:  # the parameters after Adam, the two f32 runs within 2 lr
        if "running" not in n:
            ulp = np.spacing(np.float32(np.abs(ranks[0]["after"][n]).max()))
            assert np.abs(jsd[n] - ranks[0]["after"][n]).max() <= 2 * LR + 2 * ulp, n
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)


@pytest.mark.parametrize("name", EXACT)
def test_seq_f64_step_equals_one_process(world, name):
    ranks = world["ranks"][len(F32_MESHES) + list(EXACT).index(name)]
    _, v, s, _, size = EXACT[name]
    one = world["one"][(v, s, size)]
    worst = {"loss": max(abs(r["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
                         for r in ranks)}
    for r in ranks:
        assert set(r["grads"][0]) == set(one["grads"][0])
        worst["grad"] = max(worst.get("grad", 0.0),
                            max(_leaf_errors(r["grads"][0], one["grads"][0]).values()))
    state = assemble_state(ranks, "rnn", 0)
    worst["state"] = np.abs(state - one["rnn"][0]).max() / np.abs(one["rnn"][0]).max()
    after = one["after"]
    for n, want in after.items():
        err = np.abs(ranks[0]["after"][n] - want).max()
        key = "bn" if "running" in n else "params"
        worst[key] = max(worst.get(key, 0.0), err / bn_scale(n, after) if key == "bn" else err)
    print(f"{name}: {len(ranks)} seq ranks against one process, f64: {worst}")
    assert all(val <= TOL_EXACT for val in worst.values()), worst
    assert len({r["digest"] for r in ranks}) == 1, "the replicas differ after the step"
