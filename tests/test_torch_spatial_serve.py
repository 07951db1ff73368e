"""The spatial serving and eval steps on gloo ranks against the JAX
package's steps over a `spatial` mesh, at 64x128, T=5, f32, two clips of
S=5 with the state carried, from the seeded variables of
`tests/test_torch_train_step.py`.

- (b) `make_infer_step(mesh=)` over `make_mesh(n_data=1, n_spatial=2)`
  against the JAX `make_infer_step` over the same mesh (uint8 frames): the
  ranks' bands of the saliency and of the state, put back together, within
  `TOL` of the largest value. Also at `n_spatial=4`, where c5 (2 rows) and
  the context stream's H/32 map leave two ranks a band of no rows, and on
  a 2x2 data x spatial mesh with V=2 (each data rank's two spatial ranks
  serve its video; the model sees the whole batch's V, as the JAX jit
  does). `TOL` is the JAX package's own distance between its spatial and
  its one-device steps (4.2e-7 on the saliency, 8.1e-6 on the state at this
  size) with room for the two packages' f32 sums: this host reads 2.9e-7 and
  1.1e-6.
- (c) The same step in f64 against the port's one-process step: within
  1e-10 (the band layers sum what the whole ones sum; this host reads 0).
- (e) `make_eval_step(mesh=)` against the JAX `make_eval_step` over the
  mesh: loss and state at (b)'s bound.

All the ranks' work is one spawn of 4 ranks (two idle while the 1x2 mesh
runs), started first; this process runs the JAX steps and the one-process
reference while the ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.parallel.mesh import make_mesh as j_make_mesh
from iip_uavsal_saliency_tpu.parallel.steps import make_eval_step as j_make_eval_step
from iip_uavsal_saliency_tpu.parallel.steps import make_infer_step as j_make_infer_step
from iip_uavsal_saliency_tpu_torch.parallel import spawn
from _spatial_runs import assemble, infer_clips, run_jobs
from test_torch_dp_train import normalized64
from test_torch_train_step import (_port_named, clip_data, few_threads,  # noqa: F401
                                   priors, variables)

T, CLIPS, H, W = 5, 2, 64, 128
TOL = 2e-5        # f32, relative to the largest value (module docstring)
TOL_EXACT = 1e-10  # f64, against one process
TIMEOUT_S = 600
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}


def _inputs(v):
    x = np.concatenate([clip_data(40 + k, s=T)[0] for k in range(CLIPS)], 1)
    x = np.concatenate([x] + [np.roll(x, 7 * i, axis=3) for i in range(1, v)], 0)
    state = np.random.RandomState(9).normal(0.0, 0.5, (v, H // 8, W // 8, 256))
    return x, state.astype(np.float32)


def _weights(variables):
    return {n: a.astype(np.float32)
            for n, a in _port_named(variables["params"], variables["batch_stats"]).items()}


def _run(variables, mesh, dtype="float32"):
    x, state = _inputs(mesh[0])
    g, o = priors()
    if dtype == "float64":
        x, state, g, o = normalized64(x), state.astype(np.float64), g.astype(np.float64), \
            o.astype(np.float64)
    return {"mesh": mesh, "model": {"time_dims": T}, "weights": _weights(variables),
            "dtype": dtype, "x": x, "state": state, "clips": CLIPS, "gauss": g, "ob": o}


def _eval_run(variables):
    x, state = _inputs(1)
    g, o = priors()
    ys = [clip_data(40 + k, s=T)[1] for k in range(CLIPS)]
    return {"mesh": MESHES["1x2"], "model": {"time_dims": T}, "weights": _weights(variables),
            "eval": True, "clips": [(x[:, k * T:(k + 1) * T], ys[k]) for k in range(CLIPS)],
            "rnn": state, "gauss": g, "ob": o}


def jax_runs(variables):
    """Per mesh, the JAX `make_infer_step` over it: (saliency, state) per
    clip; and over the 1x2 mesh its eval step's (loss, state) per clip."""
    model = JUAVSal(time_dims=T)
    g, o = priors()
    out = {}
    for name, (n_data, n_spatial) in MESHES.items():
        mesh = j_make_mesh(n_data=n_data, n_spatial=n_spatial,
                           devices=jax.devices()[:n_data * n_spatial])
        step = j_make_infer_step(model, mesh=mesh)
        x, state = _inputs(n_data)
        clips = []
        for k in range(CLIPS):
            sal, state = step(variables["params"], variables["batch_stats"],
                              x[:, k * T:(k + 1) * T], g, o, state)
            clips.append((np.asarray(sal, np.float64), np.asarray(state, np.float64)))
        out[name] = clips
    mesh = j_make_mesh(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    estep = j_make_eval_step(model, mesh=mesh)
    run = _eval_run(variables)
    state, evals = run["rnn"], []
    for x, y in run["clips"]:
        loss, state = estep(variables["params"], variables["batch_stats"], x, g, o, state, y)
        evals.append((float(loss), np.asarray(state, np.float64)))
    out["eval"] = evals
    return out


@pytest.fixture(scope="module")
def world(variables):
    jobs = [("infer_clips", _run(variables, MESHES["1x2"])),
            ("infer_clips", _run(variables, MESHES["1x2"], "float64")),
            ("train_steps", [_eval_run(variables)]),
            ("infer_clips", _run(variables, MESHES["1x4"])),
            ("infer_clips", _run(variables, MESHES["2x2"]))]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, run_jobs, 4, "gloo", (jobs,), timeout_s=TIMEOUT_S,
                            deadline_s=TIMEOUT_S, threads=1)
        jax_out = jax_runs(variables)
        one = infer_clips(None, _run(variables, MESHES["1x2"], "float64"))
        ranks = ranks.result()
    return {"ranks": ranks, "jax": jax_out, "one": one}


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("mesh,job", [("1x2", 0), ("1x4", 3), ("2x2", 4)])
def test_spatial_infer_step_matches_the_jax_mesh_step(world, mesh, job):
    got = [rank[job] for rank in world["ranks"]]
    for k, (jsal, jstate) in enumerate(world["jax"][mesh]):
        sal, state = assemble(got, "saliency", k, 2), assemble(got, "state", k, 1)
        errs = (_rel(sal, jsal), _rel(state, jstate))
        print(f"{mesh} clip {k}: saliency {errs[0]:.3g}, state {errs[1]:.3g} of the largest")
        assert max(errs) <= TOL, (mesh, k, errs)
    for r in got:  # no card here: the kernels' wrappers ran their plain versions
        if r["coords"] is not None:
            assert all(sum(n.values()) == 0 for n in r["launches"])


def test_spatial_infer_step_equals_one_process_in_f64(world):
    got = [rank[1] for rank in world["ranks"]]
    one = world["one"]
    for k in range(CLIPS):
        for key, axis in (("saliency", 2), ("state", 1)):
            assert _rel(assemble(got, key, k, axis), one[key][k]) <= TOL_EXACT, (key, k)


def test_spatial_eval_step_matches_the_jax_mesh_eval_step(world):
    got = [rank[2][0] for rank in world["ranks"] if rank[2][0]["coords"] is not None]
    for k, (jloss, jstate) in enumerate(world["jax"]["eval"]):
        assert all(g["losses"][k] == got[0]["losses"][k] for g in got)
        assert abs(got[0]["losses"][k] - jloss) / abs(jloss) <= TOL, k
        assert _rel(assemble(got, "rnn", k, 1), jstate) <= TOL, k
