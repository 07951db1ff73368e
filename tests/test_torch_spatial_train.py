"""The spatial train step on gloo ranks, at 64x128, T=5, V=1, S=5, one
step from the seeded variables of `tests/test_torch_train_step.py` with a
random carried state.

- f32 over `make_mesh(n_data=1, n_spatial=2)`: the ranks' step and the JAX
  package's `make_train_step` over the same mesh are each held to the
  port's one-process f64 step from the same point at the bounds of
  `tests/test_torch_train_step.py` (its docstring: an f32 run's drift
  through ~100 train-mode BatchNorms): the loss, the gradient (whole and
  per leaf), the BatchNorm running stats and the carried state; the two
  f32 runs' parameters after Adam within 2 lr of each other.
- f64 over the same mesh and over `n_spatial=4` (c5's 2 rows and the
  context stream's H/32 map leave two ranks bands of no rows, whose
  BatchNorms count no pixels): against the port's one-process f64 step
  within `TOL_EXACT`: the loss, every gradient leaf (against the larger of
  its largest entry and 1e-4 of the whole gradient's), the BatchNorm
  running stats (against `bn_scale`), the carried state and the parameters
  after Adam. This host reads 7.6e-12 on a gradient leaf, 8.8e-13 on the
  state. The rate is 1e-7, as `tests/test_torch_dp_train.py` says why: at
  1e-4 Adam moves a coordinate whose exact gradient is 0 by its rounding
  noise over 1e-8, about 1e-9. Every rank ends with the same parameters.
  The 1x2 step again with `remat`, whose recompute runs the forward's
  exchanges and collectives again inside the backward, against the same
  one-process step.

All the ranks' work is one spawn of 4 ranks (two idle on the 1x2 mesh),
started first; this process runs the JAX step and the one-process f64 step
while the ranks run.
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
from _spatial_runs import assemble, run_jobs
from test_torch_dp_train import _leaf_errors, normalized64
from test_torch_train_step import (LR, TOL_BN, TOL_GRAD, TOL_GRAD_LEAF, TOL_LOSS,  # noqa: F401
                                   TOL_STATE, WD, _adam, _err, _l2, _port_named, bn_scale,
                                   clip_data, few_threads, priors, variables)

T, H, W = 5, 64, 128
EXACT_LR = 1e-7
TOL_EXACT = 1e-10
TIMEOUT_S = 600


def _batch():
    x, y = clip_data(21, s=T)
    state = np.random.RandomState(8).normal(0.0, 0.5, (1, H // 8, W // 8, 256))
    return x, y, state.astype(np.float32)


def _run(variables, mesh, dtype):
    x, y, state = _batch()
    g, o = priors()
    f64 = dtype == "float64"
    weights = {n: a.astype(np.float32)
               for n, a in _port_named(variables["params"], variables["batch_stats"]).items()}
    return {"mesh": mesh, "model": {"time_dims": T}, "weights": weights, "dtype": dtype,
            "lr": EXACT_LR if f64 else LR, "wd": WD, "rnn": state, "gauss": g, "ob": o,
            "clips": [(normalized64(x) if f64 else x, y)]}


def jax_mesh_step(variables):
    """The JAX step over a 1x2 mesh: (loss, gradients by port name, state_dict
    after, TWA state after)."""
    mesh = j_make_mesh(n_data=1, n_spatial=2, devices=jax.devices()[:2])
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


@pytest.fixture(scope="module")
def world(variables):
    runs = [_run(variables, (1, 2), "float32"), _run(variables, (1, 2), "float64"),
            _run(variables, (1, 4), "float64"),
            dict(_run(variables, (1, 2), "float64"), remat=True)]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, run_jobs, 4, "gloo", ([("train_steps", runs)],),
                            timeout_s=TIMEOUT_S, deadline_s=TIMEOUT_S, threads=1)
        jax_train = jax_mesh_step(variables)
        one, = train_steps(None, [_run(variables, None, "float64")])
        ranks = ranks.result()
    return {"ranks": [[r[0][i] for r in ranks if r[0][i]["coords"] is not None]
                      for i in range(len(runs))],
            "jax": jax_train, "one": one}


def test_spatial_f32_step_and_the_jax_mesh_step_hold_the_f64_step(world):
    ranks, one = world["ranks"][0], world["one"]
    l64, g64, sd64, s64 = one["losses"][0], one["grads"][0], one["after"], one["rnn"][0]
    port = (ranks[0]["losses"][0], ranks[0]["grads"][0], ranks[0]["after"],
            assemble(ranks, "rnn", 0, 1))
    for who, (loss, grads, sd, state) in (("jax", world["jax"]), ("port", port)):
        assert abs(loss - l64) / abs(l64) <= TOL_LOSS, who
        assert _l2(grads, g64) <= TOL_GRAD, who
        floor = 1e-4 * np.sqrt(sum((g ** 2).sum() for g in g64.values()))
        for n in g64:
            assert _l2(grads[n], g64[n], floor) <= TOL_GRAD_LEAF, (who, n)
        for n in sd64:
            if "running" in n:
                assert _err(sd[n], sd64[n], bn_scale(n, sd64)) <= TOL_BN, (who, n)
        assert _err(state, s64, 1.0) <= TOL_STATE, who
    jsd = world["jax"][2]
    for n in jsd:  # the parameters after Adam, the two f32 runs within 2 lr
        if "running" not in n:
            ulp = np.spacing(np.float32(np.abs(ranks[0]["after"][n]).max()))
            assert np.abs(jsd[n] - ranks[0]["after"][n]).max() <= 2 * LR + 2 * ulp, n
    assert len({r["digest"] for r in ranks}) == 1
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)


@pytest.mark.parametrize("run", [1, 2, 3], ids=["1x2", "1x4", "1x2_remat"])
def test_spatial_f64_step_equals_one_process(world, run):
    ranks, one = world["ranks"][run], world["one"]
    worst = {"loss": abs(ranks[0]["losses"][0] - one["losses"][0]) / abs(one["losses"][0])}
    for r in ranks:
        assert set(r["grads"][0]) == set(one["grads"][0])
        worst["grad"] = max(worst.get("grad", 0.0),
                            max(_leaf_errors(r["grads"][0], one["grads"][0]).values()))
    state = assemble(ranks, "rnn", 0, 1)
    worst["state"] = np.abs(state - one["rnn"][0]).max() / np.abs(one["rnn"][0]).max()
    after = one["after"]
    for n, want in after.items():
        err = np.abs(ranks[0]["after"][n] - want).max()
        key = "bn" if "running" in n else "params"
        worst[key] = max(worst.get(key, 0.0), err / bn_scale(n, after) if key == "bn" else err)
    print(f"{len(ranks)} spatial ranks against one process, f64: {worst}")
    assert all(v <= TOL_EXACT for v in worst.values()), worst
    assert len({r["digest"] for r in ranks}) == 1, "the replicas differ after the step"
