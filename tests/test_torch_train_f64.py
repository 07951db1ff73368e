"""The port's train step against the JAX package's, both in f64, where the
two can be held far tighter than in f32 (`tests/test_torch_train_step.py`
explains why f32 runs through ~100 train-mode BatchNorms part by percents).

The JAX side runs under `jax_enable_x64` and is the JAX package's own
model, loss and optimizer composed as `parallel/steps.py::make_train_step`
composes them (`model.apply(train=True, mutable=["batch_stats"])`,
`loss_fu` over the flattened frames, `make_optimizer`, `apply_updates`),
without that step's cast of the model's output to f32 before the loss
(`parallel/steps.py:214`), which would limit any f64 comparison to f32's
precision. The port runs its own `make_train_step` on an f64 model.

XLA's CPU backend runs this model in f64 far more slowly than in f32, so
the test takes one step at the smallest input the flagship takes (32x64,
T=5, batch_size 1: S=5 frames) from a carried nonzero TWA state, and is
marked slow: `pytest -m slow tests/test_torch_train_f64.py` (a few minutes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.models import init_variables
from iip_uavsal_saliency_tpu.training.losses import loss_fu as j_loss_fu
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu_torch.data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from iip_uavsal_saliency_tpu_torch.models.convert import TABLE
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step
from test_torch_train_step import LR, WD, bn_scale, clip_data, few_threads, randomized  # noqa: F401

H, W, T = 32, 64, 5
S, HO, WO = T, H // 8, W // 8
# bounds, about ten times what this test read: loss 2.0e-13 relative; each
# gradient leaf's largest error 8.7e-9 of its largest entry (a leaf whose
# exact gradient is 0, a BatchNorm bias before another BatchNorm, read
# against 1e-6 of the largest entry of all); BN running stats 5.2e-12 of
# `bn_scale`; the state 1.6e-11 absolute; the parameters after Adam 1.1e-7
# absolute, 1e-3 of lr: Adam's first step scales a gradient entry near 0 by
# lr / eps = 1e4, so a 1e-11 difference there moves its parameter by 1e-7
TOL_LOSS = 1e-11
TOL_GRAD_LEAF = 1e-7
TOL_BN = 1e-10
TOL_STATE = 1e-9
TOL_PARAM = 1e-6


def _to_port(params, batch_stats):
    """A JAX `{params, batch_stats}` tree -> {port name: f64 array}: the
    weight bridge's table without `from_jax_variables`' cast to f32."""
    variables, out = {"params": params, "batch_stats": batch_stats}, {}
    for path, key, is_kernel in TABLE:
        leaf = variables
        for p in path:
            leaf = leaf[p]
        a = np.asarray(leaf, np.float64)
        out[key] = a.transpose(3, 2, 0, 1) if is_kernel else a
    return out


def _inputs():
    """f64 frames (1, S, H, W, 3) normalized on the host, ground truth,
    priors and a nonzero carried state."""
    x, y = clip_data(0, H, W, S)
    x = (x / 255.0 - IMAGENET_MEAN.astype(np.float64)) / IMAGENET_STD.astype(np.float64)
    rng = np.random.RandomState(5)
    g, o = rng.rand(HO, WO, 8), rng.rand(HO, WO, 20)
    rnn = rng.normal(0.0, 0.5, (1, HO, WO, 256))
    return x, y.astype(np.float64), g, o, rnn


def run_jax(variables, inputs):
    """One f64 step of the JAX package's model, loss and optimizer:
    (loss, {port name: gradient}, {port name: param or BN stat} after,
    state after)."""
    model = JUAVSal(time_dims=T)
    tx = j_make_optimizer(LR, WD)
    x, y, g, o, rnn = inputs

    @jax.jit
    def step(params, batch_stats, opt_state):
        def compute_loss(p):
            (out, new_rnn), mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, g, o, rnn, train=True,
                mutable=["batch_stats"])
            loss = j_loss_fu(out.reshape(S, HO, WO, 1), y.reshape(S, HO, WO, 2))
            return loss, (mutated["batch_stats"], new_rnn)

        (loss, (new_bs, new_rnn)), grads = jax.value_and_grad(compute_loss, has_aux=True)(
            params)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates), new_bs, new_rnn

    params, stats = variables["params"], variables["batch_stats"]
    loss, grads, new_params, new_bs, new_rnn = step(params, stats, tx.init(params))
    grads = {n: g for n, g in _to_port(grads, stats).items() if "running" not in n}
    return float(loss), grads, _to_port(new_params, new_bs), np.asarray(new_rnn)


def run_port(variables, inputs):
    """The port's `make_train_step` on an f64 model from the same start."""
    model = UAVSal(time_dims=T).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _to_port(variables["params"], variables["batch_stats"]).items()},
                          strict=True)
    step = make_train_step(create_train_state(model, make_optimizer(model, LR, WD)))
    x, y, g, o, rnn = (torch.from_numpy(a) for a in inputs)
    loss, new_rnn = step(x, g, o, rnn, y)
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return (float(loss), grads, {n: t.numpy().copy() for n, t in model.state_dict().items()},
            new_rnn.numpy())


@pytest.mark.slow
def test_train_step_matches_jax_in_f64(few_threads):  # noqa: F811
    model = JUAVSal(time_dims=T)
    init = init_variables(model, jax.random.PRNGKey(0), jnp.zeros((1, S, H, W, 3), jnp.float32),
                          jnp.zeros((HO, WO, 8)), jnp.zeros((HO, WO, 20)),
                          model.init_state(H, W, 1))
    variables = randomized(jax.tree_util.tree_map(np.asarray, unfreeze(init)),
                           np.random.RandomState(0))
    inputs = _inputs()
    with jax.enable_x64(True):
        jl, jg, jsd, js = run_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                                         variables), inputs)
    pl_, pg, psd, ps = run_port(variables, inputs)
    worst = {"loss": abs(pl_ - jl) / abs(jl)}
    assert set(pg) == set(jg), set(pg) ^ set(jg)
    floor = 1e-6 * max(np.abs(g).max() for g in jg.values())
    worst["gradient leaf"] = max(np.abs(pg[n] - jg[n]).max() / max(np.abs(jg[n]).max(), floor)
                                 for n in jg)
    running = [n for n in jsd if "running" in n]
    worst["bn"] = max(np.abs(psd[n] - jsd[n]).max() / bn_scale(n, jsd) for n in running)
    worst["param"] = max(np.abs(psd[n] - jsd[n]).max() for n in jsd if n not in running)
    worst["state"] = np.abs(ps - js).max()
    print(f"f64, the port against the JAX package: {worst}")
    for kind, bound in (("loss", TOL_LOSS), ("gradient leaf", TOL_GRAD_LEAF), ("bn", TOL_BN),
                        ("param", TOL_PARAM), ("state", TOL_STATE)):
        assert worst[kind] <= bound, f"f64 {kind}: {worst[kind]:.3g} > {bound:.3g}"
