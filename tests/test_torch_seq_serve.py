"""The seq serving and eval steps on gloo ranks against the JAX package's
steps over a `seq` mesh, at 64x128, f32, UAVSal with time_dims=4 over two
clips of S=12 with the state carried, from the seeded variables of
`tests/test_torch_train_step.py` (time_dims changes no weight).

- `make_infer_step(mesh=)` over `make_mesh(n_data=1, n_seq=2)` against the
  JAX `make_infer_step` over `make_mesh(1, 1, 2)` (uint8 frames): the
  ranks' runs of frames of the saliency put back together, and the state
  (which every rank returns, the same bits on each), within `TOL` of the
  largest value. Six frames a rank: the context's second group (frames 4
  to 7) lies across the two ranks. Also at n_seq=4 (three frames a rank,
  two of the three groups across ranks) and on a 2x2 data x seq mesh with
  V=2 (each data rank's two seq ranks serve its video; the model sees the
  whole batch's V, as the JAX jit does). `TOL` is the spatial tests' (the
  two packages' f32 sums).
- The same steps in f64, at 32x64, against the port's one-process step:
  within `TOL_EXACT` (the group sums that straddle ranks add in another
  order; this host reads 1.2e-14), at n_seq=2, at n_seq=4 over clips of
  S=4 (a rank of one frame) and on the 2x2 mesh.
- `make_eval_step(mesh=)` over `make_mesh(1, 1, 2)`, `(1, 1, 4)` and the
  2x2 mesh with V=2 against the JAX `make_eval_step` over the same mesh:
  loss and state at `TOL`.
- `parallel/seq.py`'s exchanges and the frame differences on each rank's
  run of frames, against the same op on the whole clips in f64, forward
  and every gradient (`tests/_seq_runs.py::seq_exchanges`), within
  `TOL_EXCHANGE` of the largest value: the frame differences
  (`models/stblock.py::temporal_differences`, one halo frame each side,
  the edge mirror at the clip's ends only), the context's group sums
  (`gather_groups`, t = 4 over S = 12: groups that straddle two ranks at
  n_seq 2 and 4; t = 3 and t = 2 too) and the TWA chain (`hand_state` with
  the plain scan: h0 handed on, its gradient handed back, the new state on
  every rank), at n_seq 2 and 4 and on a 2x2 data x seq mesh, with runs of
  1, 2, 3, 4 and 6 frames a rank (S = 4 at n_seq 4: a rank of one frame).
  The ops sum what the one process sums, in its order, but for groups
  that straddle ranks; this host reads 3.9e-16.

All the ranks' work is one spawn of 4 ranks (two idle while a mesh of two
runs), started first; this process runs the JAX steps and the one-process
references while the ranks run.
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
from _seq_runs import assemble_frames, assemble_state
from _spatial_runs import infer_clips, run_jobs
from test_torch_dp_train import normalized64
from test_torch_train_step import (_port_named, clip_data, few_threads,  # noqa: F401
                                   priors, variables)

T, CLIPS, S, H, W = 4, 2, 12, 64, 128
SMALL = (32, 64)   # the f64 runs
TOL = 2e-5         # f32, relative to the largest value (module docstring)
TOL_EXACT = 1e-10  # f64, against one process
TOL_EXCHANGE = 1e-12  # f64, relative to the largest value or gradient
TIMEOUT_S = 600
MESHES = {"1x1x2": (1, 1, 2), "1x1x4": (1, 1, 4), "2x1x2": (2, 1, 2)}


def _exchange_cases():
    cases = []
    for mesh, videos in (((1, 1, 2), 1), ((1, 1, 4), 1), ((2, 1, 2), 2), ((1, 1, 2), 2)):
        for frames in (4, 8, 12):
            if frames % mesh[2]:
                continue
            for op in ("differences", "groups", "hand_state"):
                cases.append({"mesh": mesh, "op": op, "videos": videos, "frames": frames,
                              "t": 4 if op == "groups" else 1})
    cases += [{"mesh": (1, 1, 4), "op": "groups", "videos": 1, "frames": 12, "t": 3},
              {"mesh": (1, 1, 4), "op": "groups", "videos": 2, "frames": 8, "t": 2}]
    for seed, case in enumerate(cases):
        case["seed"] = seed + 1
    return cases


CASES = _exchange_cases()


def _case_id(case):
    mesh = "x".join(map(str, case["mesh"]))
    return f"{case['op']}-{mesh}-V{case['videos']}-S{case['frames']}-t{case['t']}"


def _inputs(v, s=S, h=H, w=W):
    x = np.concatenate([clip_data(60 + k, h, w, s)[0] for k in range(CLIPS)], 1)
    x = np.concatenate([x] + [np.roll(x, 7 * i, axis=3) for i in range(1, v)], 0)
    state = np.random.RandomState(11).normal(0.0, 0.5, (v, h // 8, w // 8, 256))
    return x, state.astype(np.float32)


def _weights(variables):
    return {n: a.astype(np.float32)
            for n, a in _port_named(variables["params"], variables["batch_stats"]).items()}


def _run(variables, mesh, dtype="float32", s=S):
    if dtype == "float64":
        x, state = _inputs(mesh[0], s, *SMALL)
        g, o = priors(ho=SMALL[0] // 8, wo=SMALL[1] // 8)
        x, state, g, o = normalized64(x), state.astype(np.float64), g.astype(np.float64), \
            o.astype(np.float64)
    else:
        x, state = _inputs(mesh[0], s)
        g, o = priors()
    return {"mesh": mesh, "model": {"time_dims": T}, "weights": _weights(variables),
            "dtype": dtype, "x": x, "state": state, "clips": CLIPS, "gauss": g, "ob": o}


def _eval_run(variables, mesh):
    v = mesh[0]
    x, state = _inputs(v)
    g, o = priors()
    ys = [clip_data(60 + k, s=S)[1] for k in range(CLIPS)]
    ys = [np.concatenate([y] + [np.roll(y, i, axis=3) for i in range(1, v)], 0) for y in ys]
    return {"mesh": mesh, "model": {"time_dims": T}, "weights": _weights(variables),
            "eval": True, "clips": [(x[:, k * S:(k + 1) * S], ys[k]) for k in range(CLIPS)],
            "rnn": state, "gauss": g, "ob": o}


def jax_runs(variables):
    """Per mesh, the JAX `make_infer_step` over it: (saliency, state) per
    clip; and its eval step's (loss, state) per clip."""
    model = JUAVSal(time_dims=T)
    g, o = priors()
    out = {}
    for name, (n_data, _, n_seq) in MESHES.items():
        mesh = j_make_mesh(n_data=n_data, n_seq=n_seq, devices=jax.devices()[:n_data * n_seq])
        step = j_make_infer_step(model, mesh=mesh)
        x, state = _inputs(n_data)
        clips = []
        for k in range(CLIPS):
            sal, state = step(variables["params"], variables["batch_stats"],
                              x[:, k * S:(k + 1) * S], g, o, state)
            clips.append((np.asarray(sal, np.float64), np.asarray(state, np.float64)))
        estep = j_make_eval_step(model, mesh=mesh)
        run = _eval_run(variables, MESHES[name])
        state, evals = run["rnn"], []
        for x, y in run["clips"]:
            loss, state = estep(variables["params"], variables["batch_stats"], x, g, o, state, y)
            evals.append((float(loss), np.asarray(state, np.float64)))
        out[name] = clips
        out["eval", name] = evals
    return out


# (mesh, frames of a clip) of the f64 runs
EXACT = {"1x1x2": ((1, 1, 2), S), "1x1x4_one_frame": ((1, 1, 4), 4),
         "2x1x2": ((2, 1, 2), S)}


@pytest.fixture(scope="module")
def world(variables):
    exact = {name: _run(variables, mesh, "float64", s) for name, (mesh, s) in EXACT.items()}
    jobs = ([("infer_clips", _run(variables, mesh)) for mesh in MESHES.values()]
            + [("train_steps", [_eval_run(variables, mesh) for mesh in MESHES.values()])]
            + [("infer_clips", run) for run in exact.values()]
            + [("seq_exchanges", CASES)])
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, run_jobs, 4, "gloo", (jobs,), timeout_s=TIMEOUT_S,
                            deadline_s=TIMEOUT_S, threads=1)
        jax_out = jax_runs(variables)
        one = {name: infer_clips(None, dict(run, mesh=None)) for name, run in exact.items()}
        ranks = ranks.result()
    return {"ranks": ranks, "jax": jax_out, "one": one}


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("job,mesh", enumerate(MESHES))
def test_seq_infer_step_matches_the_jax_mesh_step(world, job, mesh):
    got = [rank[job] for rank in world["ranks"]]
    for k, (jsal, jstate) in enumerate(world["jax"][mesh]):
        sal, state = assemble_frames(got, "saliency", k), assemble_state(got, "state", k)
        errs = (_rel(sal, jsal), _rel(state, jstate))
        print(f"{mesh} clip {k}: saliency {errs[0]:.3g}, state {errs[1]:.3g} of the largest")
        assert max(errs) <= TOL, (mesh, k, errs)
    for r in got:  # no card here: the kernels' wrappers ran their plain versions
        if r["coords"] is not None:
            assert all(sum(n.values()) == 0 for n in r["launches"])


@pytest.mark.parametrize("name", EXACT)
def test_seq_infer_step_equals_one_process_in_f64(world, name):
    got = [rank[len(MESHES) + 1 + list(EXACT).index(name)] for rank in world["ranks"]]
    one = world["one"][name]
    for k in range(CLIPS):
        sal = _rel(assemble_frames(got, "saliency", k), one["saliency"][k])
        state = _rel(assemble_state(got, "state", k), one["state"][k])
        print(f"{name} clip {k}: saliency {sal:.3g}, state {state:.3g} of the largest")
        assert max(sal, state) <= TOL_EXACT, (name, k, sal, state)


@pytest.mark.parametrize("job,mesh", enumerate(MESHES))
def test_seq_eval_step_matches_the_jax_mesh_eval_step(world, job, mesh):
    got = [rank[len(MESHES)][job] for rank in world["ranks"]
           if rank[len(MESHES)][job]["coords"] is not None]
    for k, (jloss, jstate) in enumerate(world["jax"]["eval", mesh]):
        assert all(g["losses"][k] == got[0]["losses"][k] for g in got)
        err = abs(got[0]["losses"][k] - jloss) / abs(jloss)
        state = _rel(assemble_state(got, "rnn", k), jstate)
        print(f"{mesh} clip {k}: loss {err:.3g}, state {state:.3g} of the largest")
        assert max(err, state) <= TOL, (mesh, k, err, state)


@pytest.mark.parametrize("index", range(len(CASES)), ids=[_case_id(c) for c in CASES])
def test_seq_exchange_equals_the_whole_clip(world, index):
    results = [r[-1][index] for r in world["ranks"] if r[-1][index]["coords"] is not None]
    case = CASES[index]
    assert len(results) == case["mesh"][0] * case["mesh"][2]
    for r in results:
        scale = r["scale"]
        assert r["forward"] <= TOL_EXCHANGE * scale, (r["coords"], r["forward"], scale)
        assert r["backward"] <= TOL_EXCHANGE * scale, (r["coords"], r["backward"], scale)
