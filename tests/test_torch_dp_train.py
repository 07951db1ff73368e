"""Data-parallel training on the CPU: two gloo ranks holding one video each
against one process holding both (V=2), and against the JAX package's
steps over a two-device `data` mesh.

The batch is `tests/test_torch_train_multivideo.py`'s `lockstep_clip`: in
clip 0 video 1's last 5 frames are padding (mask 0), in clip 1 video 0 has
run out and repeats its clip masked, so the two ranks hold different
counts of valid frames and the masked loss's denominator must be the whole
batch's. The padded frames still feed the statistics of train-mode
BatchNorm, which the ranks reduce together.

- f64 (32x64, seeded `init_model` weights, the masked loss, 2 steps with
  the state carried, remat off and on, lr 1e-7): the loss, every gradient
  after the all-reduce, the BatchNorm running stats after, and the carried
  state equal the single-process V=2 steps within `TOL_EXACT` relative (a
  leaf's gradient against the larger of its largest entry and 1e-4 of the
  whole gradient's largest, a running stat against `bn_scale`), and the
  parameters lie within 2 lr a step. Every rank ends with the same bits.
  The rate is the trainer tests' 1e-7: at the default 1e-4, Adam moves a
  coordinate whose exact gradient is 0 (a BatchNorm bias before another
  BatchNorm) by about 1e-9, a size set by its rounding noise, which any two
  orders of summation part by 100%; the second step then starts from
  parameters 1e-9 apart and its gradients part by 5.5e-10, its state by
  6.8e-10 (measured, at 32x64).
  Remat takes the first step only: its recompute is the step's forward
  again, collectives and all.
- f32 (64x128, the JAX package's seeded variables): the ranks' f32 step on
  clip 0 and the JAX package's (`make_train_step(mesh=make_mesh(n_data=2))`)
  are each held to the port's single-process f64 step at the bounds of
  `tests/test_torch_train_step.py`; the eval step (`make_eval_step(mesh=
  ...)`, both clips) at the bounds of `tests/test_torch_train_multivideo.py`.
- bf16 mixed (32x64, clip 0): the ranks against one process at V=2 whose
  BatchNorms reduce the batch as the two ranks do (`ranks_arithmetic`, the
  same sums in the same order): the loss and gradient within `TOL_MIXED_*`,
  BN stats and state at `tests/test_torch_train_step.py`'s f32 bounds. Against the plain
  one-process step no bound would mean anything: in a random network one
  bf16 ulp of a BatchNorm output, which another order of the same f32 sums
  gives now and then, moves a bf16 step's gradients and state by O(1)
  (an H100 read 1.39 and 5.12 at 360x640, `chip_smoke.py` phase 7).

All the ranks' work is one spawn (`tests/_dp_runs.py::train_steps`),
started first; this process runs the JAX steps and the single-process
references while the ranks run."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.parallel.mesh import make_mesh
from iip_uavsal_saliency_tpu.parallel.steps import create_train_state as j_create
from iip_uavsal_saliency_tpu.parallel.steps import make_eval_step as j_make_eval_step
from iip_uavsal_saliency_tpu.parallel.steps import make_train_step as j_make_train_step
from iip_uavsal_saliency_tpu.training.losses import loss_fu as j_loss_fu
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu.training.trainer import _masked_loss as j_masked_loss
from iip_uavsal_saliency_tpu_torch.data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.parallel import cross_rank_batch_norm, spawn
from _dp_runs import ranks_arithmetic, train_steps
from test_torch_train_multivideo import (TOL_EVAL_LOSS, TOL_EVAL_STATE,  # noqa: F401
                                         lockstep_clip)
from test_torch_train_step import (LR, TOL_BN, TOL_GRAD, TOL_GRAD_LEAF, TOL_LOSS,  # noqa: F401
                                   TOL_STATE, WD, _adam, _err, _l2, _port_named, bn_scale,
                                   few_threads, priors, variables)

RANKS, T, CLIPS = 2, 5, 2
SMALL = (32, 64)   # the f64 runs
EXACT_LR = 1e-7    # their rate (module docstring)
TOL_EXACT = 1e-10  # relative, f64 ranks against one process (module docstring)
TIMEOUT_S = 600    # every collective, and the whole spawn
# bf16 mixed ranks against one process with their sums; this host read the
# loss 7.2e-8, the gradient 2.5e-3 (each rank rounds its share of a gradient
# to bf16 before the all-reduce), BN stats and state equal
TOL_MIXED_LOSS = 1e-5
TOL_MIXED_GRAD = 0.02


def small_clip(k):
    """`lockstep_clip` cut to 32x64 (its ground truth to 4x8)."""
    x, y = lockstep_clip(k)
    return x[:, :, :SMALL[0], :SMALL[1]], y[:, :, :SMALL[0] // 8, :SMALL[1] // 8]


def normalized64(x):
    return (x / 255.0 - IMAGENET_MEAN.astype(np.float64)) / IMAGENET_STD.astype(np.float64)


def exact_run(remat):
    """The f64 run at 32x64: masked V=2 clips from a carried state, both
    clips without remat, the first with it."""
    rng = np.random.RandomState(7)
    weights = init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(0)).state_dict()
    ho, wo = SMALL[0] // 8, SMALL[1] // 8
    clips = [(normalized64(x), y.astype(np.float64))
             for x, y in map(small_clip, range(1 if remat else CLIPS))]
    return {"model": {"time_dims": T}, "weights": {k: v.numpy() for k, v in weights.items()},
            "dtype": "float64", "loss": "masked", "remat": remat, "lr": EXACT_LR, "wd": WD,
            "clips": clips, "rnn": rng.normal(0.0, 0.5, (2, ho, wo, 256)),
            "gauss": rng.rand(ho, wo, 8), "ob": rng.rand(ho, wo, 20)}


def mixed_run():
    """The first f64 run's clip in bf16 mixed precision (f32 weights)."""
    run = exact_run(False)
    x, y = small_clip(0)
    return dict(run, dtype="float32", compute_dtype="bfloat16", lr=LR, clips=[(x, y)],
                weights={k: v.astype(np.float32) for k, v in run["weights"].items()},
                rnn=run["rnn"].astype(np.float32), gauss=run["gauss"].astype(np.float32),
                ob=run["ob"].astype(np.float32))


def jax_mesh_runs(variables):
    """The JAX package's train step over a 2-device `data` mesh on clip 0
    from `variables`: (loss, gradients by port name, state_dict after, TWA
    state after); and its eval step's (loss, state) per clip."""
    mesh = make_mesh(n_data=RANKS, devices=jax.devices()[:RANKS])
    model = JUAVSal(time_dims=T)
    tx = j_make_optimizer(LR, WD)
    step = j_make_train_step(model, tx, loss_fn=j_masked_loss(j_loss_fu), mesh=mesh,
                             donate=False)
    state = j_create(variables, tx)
    g, o = priors()
    x, y = lockstep_clip(0)
    p0 = _port_named(state.params, state.batch_stats)
    state, loss, rnn = step(state, x, g, o, np.asarray(model.init_state(64, 128, RANKS)), y)
    mu1 = _port_named(_adam(state.opt_state).mu, state.batch_stats, state.params)
    grads = {n: mu1[n] / 0.1 - WD * p0[n] for n in mu1 if "running" not in n}  # Adam's mu_0 = 0
    train = (float(loss), grads, _port_named(state.params, state.batch_stats),
             np.asarray(rnn).astype(np.float64))
    estep = j_make_eval_step(model, loss_fn=j_masked_loss(j_loss_fu), mesh=mesh)
    erun, ernn = [], np.asarray(model.init_state(64, 128, RANKS))
    for k in range(CLIPS):
        x, y = lockstep_clip(k)
        loss, ernn = estep(variables["params"], variables["batch_stats"], x, g, o, ernn, y)
        ernn = np.asarray(ernn)
        erun.append((float(loss), ernn.astype(np.float64)))
    return train, erun


def from_variables(variables, dtype):
    """A run of clip 0 from the JAX package's `variables` (Adam at its
    start, a zero state) in `dtype` (f64: its frames normalized in f64, as
    `tests/test_torch_train_step.py`'s f64 runs)."""
    x, y = lockstep_clip(0)
    g, o = priors()
    weights = {n: a.astype(np.float32)
               for n, a in _port_named(variables["params"], variables["batch_stats"]).items()}
    return {"model": {"time_dims": T}, "weights": weights, "dtype": dtype, "loss": "masked",
            "lr": LR, "wd": WD, "rnn": np.zeros((RANKS, 8, 16, 256), np.float32),
            "clips": [(normalized64(x) if dtype == "float64" else x, y)], "gauss": g, "ob": o}


@pytest.fixture(scope="module")
def world(variables):
    """One spawn of two ranks: the f64 exact runs (remat off, on), the f32
    step and eval steps from the JAX package's variables, and the bf16
    mixed step; while it runs, this process runs the JAX mesh steps (on a
    thread) and the single-process references."""
    exact = [exact_run(False), exact_run(True)]
    eval_run = dict(from_variables(variables, "float32"), eval=True,
                    clips=[lockstep_clip(k) for k in range(CLIPS)])
    mixed = mixed_run()
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn, train_steps, RANKS, "gloo",
                            (exact + [from_variables(variables, "float32"), eval_run, mixed],),
                            timeout_s=TIMEOUT_S, deadline_s=TIMEOUT_S, threads=2)
        jax_runs = pool.submit(jax_mesh_runs, variables)
        one = train_steps(None, exact + [from_variables(variables, "float64")])
        with ranks_arithmetic(RANKS):
            same_sums, = train_steps(None, [mixed])
        (jax_train, jax_eval), ranks = jax_runs.result(), ranks.result()
    return {"ranks": ranks, "one": one, "jax_train": jax_train, "jax_eval": jax_eval,
            "same_sums": same_sums}


def _leaf_errors(a, b):
    """Per leaf: max |a - b| over the larger of the leaf's largest |b| and
    1e-4 of the largest entry of all of b."""
    top = max(np.abs(v).max() for v in b.values())
    return {n: np.abs(a[n] - b[n]).max() / max(np.abs(b[n]).max(), 1e-4 * top) for n in b}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_ranks_take_the_single_process_step_in_f64(world, remat):
    r0, r1 = (ranks[int(remat)] for ranks in world["ranks"])
    one = world["one"][int(remat)]
    worst = {}
    for k in range(len(one["losses"])):
        for r in (r0, r1):  # each rank logs the whole batch's loss
            worst["loss"] = max(worst.get("loss", 0), abs(r["losses"][k] - one["losses"][k])
                                / abs(one["losses"][k]))
            assert set(r["grads"][k]) == set(one["grads"][k])
            worst["grad"] = max(worst.get("grad", 0),
                                max(_leaf_errors(r["grads"][k], one["grads"][k]).values()))
        state = np.concatenate([r0["rnn"][k], r1["rnn"][k]])  # rank r holds video r
        worst["state"] = max(worst.get("state", 0),
                             np.abs(state - one["rnn"][k]).max() / np.abs(one["rnn"][k]).max())
    after = one["after"]
    for n, want in after.items():
        err = np.abs(r0["after"][n] - want).max()
        if "running" in n:
            worst["bn"] = max(worst.get("bn", 0), err / bn_scale(n, after))
        else:
            assert err <= 2 * EXACT_LR * len(one["losses"]), n
    print(f"remat={remat}: f64, two ranks against one process: {worst}")
    assert all(v <= TOL_EXACT for v in worst.values()), worst
    assert r0["digest"] == r1["digest"], "the replicas differ after the steps"
    # the step's gradient is every rank's: the ranks hold the same sums
    for k in range(len(one["losses"])):
        assert all(np.array_equal(r0["grads"][k][n], r1["grads"][k][n]) for n in r0["grads"][k])


def test_ranks_and_jax_mesh_step_hold_the_f64_step_in_f32(world):
    """Each package's f32 against the port's single-process f64 on clip 0
    from the JAX package's variables, at the bounds of
    `tests/test_torch_train_step.py`."""
    r0, r1 = (r[2] for r in world["ranks"])
    ref = world["one"][2]
    l64, g64, sd64, s64 = (ref["losses"][0], ref["grads"][0], ref["after"], ref["rnn"][0])
    jl, jg, jsd, js = world["jax_train"]
    port = (r0["losses"][0], r0["grads"][0], r0["after"],
            np.concatenate([r0["rnn"][0], r1["rnn"][0]]))
    for who, (loss, grads, sd, state) in (("jax", (jl, jg, jsd, js)), ("port", port)):
        assert abs(loss - l64) / abs(l64) <= TOL_LOSS, who
        assert _l2(grads, g64) <= TOL_GRAD, who
        floor = 1e-4 * np.sqrt(sum((g ** 2).sum() for g in g64.values()))
        for n in g64:
            assert _l2(grads[n], g64[n], floor) <= TOL_GRAD_LEAF, (who, n)
        for n in sd64:
            if "running" in n:
                assert _err(sd[n], sd64[n], bn_scale(n, sd64)) <= TOL_BN, (who, n)
        assert _err(state, s64, 1.0) <= TOL_STATE, who
    for n in jsd:  # the parameters after Adam, the two f32 runs within 2 lr
        if "running" not in n:
            ulp = np.spacing(np.float32(np.abs(r0["after"][n]).max()))
            assert np.abs(jsd[n] - r0["after"][n]).max() <= 2 * LR + 2 * ulp, n
    assert r0["digest"] == r1["digest"]


def test_ranks_eval_step_matches_the_jax_mesh_eval_step(world):
    r0, r1 = (r[3] for r in world["ranks"])
    for k, (jl, js) in enumerate(world["jax_eval"]):
        assert r0["losses"][k] == r1["losses"][k]
        assert abs(r0["losses"][k] - jl) / abs(jl) <= TOL_EVAL_LOSS, k
        state = np.concatenate([r0["rnn"][k], r1["rnn"][k]])
        assert _err(state, js, 1.0) <= TOL_EVAL_STATE, k


def test_bf16_ranks_take_the_step_of_one_process_with_their_sums(world):
    """bf16 mixed: the ranks against one process at V=2 whose BatchNorms
    reduce the batch as the two ranks do (`ranks_arithmetic`)."""
    r0, r1 = (r[-1] for r in world["ranks"])
    one = world["same_sums"]
    state = np.concatenate([r0["rnn"][0], r1["rnn"][0]])
    loss = abs(r0["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    grad = _l2(r0["grads"][0], one["grads"][0])
    bn = max(_err(r0["after"][n], one["after"][n], bn_scale(n, one["after"]))
             for n in one["after"] if "running" in n)
    err = _err(state, one["rnn"][0], 1.0)
    print(f"bf16 mixed, two ranks against one process with their sums: loss {loss:.3g}, "
          f"gradient {grad:.3g}, BN stats {bn:.3g}, state {err:.3g}")
    assert loss <= TOL_MIXED_LOSS and grad <= TOL_MIXED_GRAD, (loss, grad)
    assert bn <= TOL_BN and err <= TOL_STATE, (bn, err)
    assert r0["digest"] == r1["digest"]


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_cross_rank_batch_norm_in_parts_equals_batch_norm(parts):
    """`cross_rank_batch_norm` without a group, the batch reduced whole or
    as 2 or 3 parts (Chan's combination), against `F.batch_norm` in train
    mode in f64: output, the gradients of x, scale and bias, and the
    running stats after, on a batch whose mean lies far above its spread."""
    rng = np.random.RandomState(3)
    x0 = torch.tensor(rng.rand(6, 7, 5, 4) * 0.3 + 4.0, dtype=torch.float64)
    w0, b0 = torch.tensor(rng.rand(7) + 0.5), torch.tensor(rng.randn(7) * 0.1)
    dy = torch.tensor(rng.randn(6, 7, 5, 4))
    out = {}
    for how in ("parts", "torch"):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        stats = (torch.zeros(7, dtype=torch.float64), torch.ones(7, dtype=torch.float64))
        if how == "parts":
            y = cross_rank_batch_norm(x, w, b, *stats, 0.1, 1e-5, None, parts)
        else:
            y = torch.nn.functional.batch_norm(x, *stats, w, b, True, 0.1, 1e-5)
        y.backward(dy)
        out[how] = (y, x.grad, w.grad, b.grad, *stats)
    for name, a, ref in zip(("y", "dx", "dw", "db", "mean", "var"), out["parts"],
                            out["torch"]):
        assert (a - ref).abs().max().item() <= 1e-12 * max(ref.abs().max().item(), 1.0), name
