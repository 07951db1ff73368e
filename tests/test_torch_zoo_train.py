"""The ablation zoo's train step against the JAX package's on the CPU at
64x128, T=5, batch_size=2 (S=10 frames per clip), f32, one step from the
same start for each of the 8 other `MODEL_ZOO` names, every parameter
trained: the JAX package's `make_train_step` over its adapter, the port's
`make_train_step` over its `ZooModelAdapter`. This file runs the four
whose ST blocks have a temporal-difference branch or none
(`STEP_NAMES`); `tests/test_torch_zoo_train_3d_priors.py` runs the 3-D
blocks and the prior-fed models with the same test.

The comparison is `tests/test_torch_train_step.py`'s, with its bounds (PR
7's): a train-mode forward through some 50 to 100 BatchNorms carries every
f32 rounding before a BatchNorm forward at full size, so both f32 steps are
held to the port's f64 step from the same start (the loss, the gradient as
a whole and per leaf, the BatchNorm running stats, the carried state), and
to each other where that is well conditioned: the parameters after Adam
within 2 lr. The models run with one ST block each (the JAX step compiles
in about 15 s per name)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models.adapters import build_adapted_model as j_build_adapted
from iip_uavsal_saliency_tpu.parallel.steps import create_train_state as j_create
from iip_uavsal_saliency_tpu.parallel.steps import make_train_step as j_make_train_step
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu_torch.data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, table_of
from iip_uavsal_saliency_tpu_torch.models.uavsal import MODEL_ZOO
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step
from test_torch_train_step import (LR, TOL_BN, TOL_GRAD, TOL_GRAD_LEAF, TOL_LOSS, TOL_STATE,
                                   WD, _adam, _err, _f64, _l2, bn_scale, clip_data,
                                   few_threads, priors, randomized)  # noqa: F401

H, W, T, S = 64, 128, 5, 10
HO, WO = H // 8, W // 8
NAMES = [name for name in MODEL_ZOO if name != "uavsal"]
STEP_NAMES = ["uavsal_spconv", "uavsal_teconv", "uavsal_stblocks", "uavsal_stblocks_type"]
CONFIG = dict(time_dims=T, num_stblock=1, bias_type=(1, 1, 1), st_type="s2t")


def start(name):
    """(the JAX adapter, seeded variables of its tree, the state to start
    from: ConvLSTM's h and c seeded, else the dummy zeros)."""
    jm = j_build_adapted(name, filter_kwargs=True, **CONFIG)
    g, o = priors()
    x, _ = clip_data(0)
    state = np.asarray(jm.init_state(H, W, 1))
    if name == "uavsal_lstm":
        state = np.random.RandomState(9).normal(0, 0.5, state.shape).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(x.shape), g, o,
                            jnp.asarray(state))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    return jm, randomized(zeros, np.random.RandomState(len(name))), state


def jax_step(jm, variables, state, table):
    """The JAX package's step: (loss, gradients by port name, {port name:
    param or BN stat} after, state after), all f64. The gradient is read
    off Adam's first moment (with the decay the optimizer adds to it)."""
    tx = j_make_optimizer(LR, WD)
    step = j_make_train_step(jm, tx, donate=False)
    x, y = clip_data(0)
    g, o = priors()
    new, loss, rnn = step(j_create(variables, tx), x, g, o, state, y)

    def named(params, stats):
        sd = from_jax_variables({"params": params, "batch_stats": stats}, table)
        return {k: v.double().numpy() for k, v in sd.items()}

    mu = named(_adam(new.opt_state).mu, variables["batch_stats"])
    p0 = named(variables["params"], variables["batch_stats"])
    grads = {n: mu[n] / 0.1 - WD * p0[n] for n in mu if "running" not in n}
    return (float(loss), grads, named(new.params, new.batch_stats),
            np.asarray(rnn, np.float64))


def port_step(name, variables, state, dtype):
    """The port's step in `dtype` from the same start: (loss, gradients,
    state_dict after, state after), all f64. The f64 run gets its frames
    normalized in f64."""
    model = build_adapted_model(name, filter_kwargs=True, **CONFIG)
    model.load_state_dict(from_jax_variables(variables, table_of(model)), strict=True)
    model.to(dtype)
    step = make_train_step(create_train_state(model, make_optimizer(model, LR, WD)))
    x, y = clip_data(0)
    x = torch.from_numpy(x)
    if dtype == torch.float64:
        mean, std = (torch.from_numpy(a).double() for a in (IMAGENET_MEAN, IMAGENET_STD))
        x = (x.double() / 255.0 - mean) / std
    g, o = (torch.from_numpy(a).to(dtype) for a in priors())
    loss, new = step(x, g, o, torch.tensor(state, dtype=dtype), torch.from_numpy(y).to(dtype))
    assert not new.requires_grad
    grads = {n: _f64(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    return (float(loss), grads, {n: _f64(t) for n, t in model.state_dict().items()}, _f64(new))


def train_step_matches_jax(name):
    """One step of each package and the port's f64 step from the same
    start: the loss, the gradient (whole and per leaf, a leaf whose exact
    gradient is 0 read against 1e-4 of the whole), every running stat, the
    state; the parameters after Adam of the two f32 steps within 2 lr."""
    jm, variables, state = start(name)
    table = table_of(build_adapted_model(name, filter_kwargs=True, **CONFIG))
    jl, jg, jsd, js = jax_step(jm, variables, state, table)
    l32, g32, sd32, s32 = port_step(name, variables, state, torch.float32)
    l64, g64, sd64, s64 = port_step(name, variables, state, torch.float64)
    for who, (loss, grads, sd, st) in {"jax": (jl, jg, jsd, js),
                                       "port": (l32, g32, sd32, s32)}.items():
        assert abs(loss - l64) / abs(l64) <= TOL_LOSS, (who, loss, l64)
        assert set(grads) == set(g64) == {n for n in sd64 if "running" not in n}
        assert _l2(grads, g64) <= TOL_GRAD, who
        floor = 1e-4 * np.sqrt(sum((g ** 2).sum() for g in g64.values()))
        for n in g64:
            assert _l2(grads[n], g64[n], floor) <= TOL_GRAD_LEAF, (who, n)
        for n in sd64:
            if "running" in n:
                assert _err(sd[n], sd64[n], bn_scale(n, sd64)) <= TOL_BN, (who, n)
        assert _err(st, s64, 1.0) <= TOL_STATE, who
    moved = 0
    before = from_jax_variables(variables, table)
    for n in sd64:
        if "running" not in n:
            ulp = np.spacing(np.float32(np.abs(sd32[n]).max()))
            assert np.abs(jsd[n] - sd32[n]).max() <= 2 * LR + 2 * ulp, n
            moved += not np.array_equal(sd32[n], before[n].numpy())
    assert moved == len(g64)  # every parameter trained
    if name == "uavsal_lstm":
        assert np.abs(s64).max() > 0.1 and not np.allclose(s64, state)
    else:
        assert not s64.any()  # the dummy state passes through


@pytest.mark.parametrize("name", STEP_NAMES)
def test_zoo_train_step_matches_jax(name):
    train_step_matches_jax(name)
