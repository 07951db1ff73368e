"""The port's train step against the JAX package's `make_train_step` at
64x128, T=5, batch_size=2 (S=10 frames per clip), in f32, over 3 clips with
the TWA state carried, every parameter trained
(`tests/test_torch_train_freeze.py` runs the same with the default freeze
mask).

Each clip starts both packages from the same point: the JAX package runs its
own 3 steps, and before each clip the port is loaded with the JAX state
(parameters, BatchNorm stats, Adam moments and count) and carried TWA state.
Two f32 trajectories cannot be compared over several Adam steps: the first
step moves every coordinate by +-lr, the sign of a gradient at the noise
level differs between any two f32 runs, and the random network amplifies
those lr-sized differences far above any tolerance within one more clip.

Nor can one step be held to 1e-5 (loss, relative; BN stats; state) or each
gradient leaf to 1e-4 of its largest entry: a train-mode BatchNorm divides
by the batch std, so every f32 rounding before it is carried forward at
full size, and over the flagship's ~100 BatchNorms an f32 run drifts from
the exact answer by more than that. Measured here against the port run in
f64 from the same point, over the 3 clips and both freeze settings: the JAX
package's f32 loss up to 2.9e-5 relative (the port's 1.3e-5), its gradient
up to 4.0% relative L2 over the whole model (the port's 2.3%; the JAX
package measured the reference's torch f32 against f64 at 1-5%,
`tests/test_reference_parity.py`, "Precision design"), per leaf up to 6.4%
(the port's 4.5%), BN stats 4.0e-5 of `bn_scale` (2.1e-5), the carried
state 1.2e-3 (4.8e-4; values up to 4.5). So both f32 runs are held to the
f64 run within the bounds below, a few times above those readings and far
below what a semantic difference moves (momentum, the n/(n-1) factor, the
context tile, the freeze mask, the decay's place, a gradient that is
missing or of the wrong sign); that the port's gradient is the derivative
of its loss is held in f64 by a central difference, and the two packages'
steps are held to each other in f64, far tighter, by the slow
`tests/test_torch_train_f64.py`.
The two f32 runs are held to each other directly where that is well
conditioned: the parameters after Adam (within 2 lr: a step moves a
coordinate by about lr, and a coordinate whose gradient sits at the noise
level may step the other way; plus the rounding of the f32 values they land
on), and the frozen parameters (unmoved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits
from flax.core import unfreeze

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.parallel.steps import create_train_state as j_create
from iip_uavsal_saliency_tpu.parallel.steps import make_train_step as j_make_train_step
from iip_uavsal_saliency_tpu.training.optim import make_frozen_mask as j_frozen_mask
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu_torch.data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
from iip_uavsal_saliency_tpu_torch.training.optim import make_frozen_mask, make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

H, W, T, BATCH = 64, 128, 5, 2
S, HO, WO = T * BATCH, H // 8, W // 8
CLIPS = 3
LR, WD = 1e-4, 5e-5  # the JAX TrainConfig's defaults
FREEZE = ("trunk/sfnet", "trunk/st_layer")  # the JAX TrainConfig's default
# each f32 run against the f64 run from the same point (module docstring)
TOL_LOSS = 1e-4        # relative
TOL_GRAD = 0.1         # whole gradient, relative L2
TOL_GRAD_LEAF = 0.25   # each leaf, relative L2 (`check_against_jax`)
# BN running stats, relative to `bn_scale`; a missing n/(n-1) factor moves a
# running var by 0.1/n, 1e-4 at n = 1000 samples per channel
TOL_BN = 1e-4
TOL_STATE = 5e-3       # absolute
TOL_DERIVATIVE = 1e-3  # f64 gradient against a central difference, relative


def randomized(tree, rng):
    """Seeded values for a JAX variables tree: kernels with std
    1/sqrt(fan_in), BatchNorm scale in [0.5, 1.5], bias and running mean
    N(0, 0.1), running var in [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomized(v, rng)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
        else:
            fan_in = np.prod(np.shape(v)[:-1])
            out[k] = rng.normal(0.0, 1.0 / np.sqrt(fan_in), np.shape(v)).astype(np.float32)
    return out


def clip_data(seed, h=H, w=W, s=S):
    """uint8 frames (1, s, h, w, 3) and ground truth (1, s, h/8, w/8, 2):
    a blurred map in [0, 1] and binary fixation points, one at least per
    frame."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (1, s, h, w, 3)).astype(np.uint8)
    ymap = rng.rand(1, s, h // 8, w // 8, 1).astype(np.float32)
    ypts = (rng.rand(1, s, h // 8, w // 8, 1) < 0.05).astype(np.float32)
    ypts[:, :, 3, 4] = 1.0
    return x, np.concatenate([ymap, ypts], -1)


def priors(seed=5, ho=HO, wo=WO):
    rng = np.random.RandomState(seed)
    return rng.rand(ho, wo, 8).astype(np.float32), rng.rand(ho, wo, 20).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for torch, and two for numpy's BLAS, while this
    module runs: the suite runs several workers on one host, and a default
    of one thread per core in each of them oversubscribes it (a worker's
    run grows from a minute to tens of minutes; idle BLAS threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2, user_api="blas"):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    """The JAX package's variables tree of the flagship at 64x128 with
    seeded values: `randomized` reads the tree's shapes only, so
    `jax.eval_shape` of the init gives it without compiling the init (18 s
    on the CPU)."""
    model = JUAVSal(time_dims=T)
    g, o = priors()
    x = jnp.zeros((1, S, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, g, o,
                            model.init_state(H, W, 1))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), unfreeze(shapes))
    return randomized(zeros, np.random.RandomState(0))


def _port_named(params, batch_stats, like=None):
    """A JAX tree (params-shaped, with MaskedNode leaves for frozen ones,
    filled with zeros shaped as in `like`, and the batch stats) -> {port
    name: f64 array}, the port's layout."""
    if like is not None:
        params = jax.tree_util.tree_map(
            lambda a, b: np.zeros(np.shape(b)) if isinstance(a, optax.MaskedNode) else a,
            params, like, is_leaf=lambda a: isinstance(a, optax.MaskedNode))
    sd = from_jax_variables({"params": params, "batch_stats": batch_stats})
    return {k: v.double().numpy() for k, v in sd.items()}


def _adam(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


def run_jax(variables, freeze, clip=clip_data, loss_fn=None, remat=False, clips=CLIPS):
    """The JAX package's steps over `clips` clips (`clip(k)` gives clip k,
    `loss_fn` is the JAX loss, its `loss_fu` by default). Per clip: (the
    state it started from as (params, batch_stats, Adam state, TWA state),
    loss, gradients by port name, {port name: param or BN stat} after the
    step, TWA state after)."""
    model = JUAVSal(time_dims=T)
    mask = j_frozen_mask(variables["params"], freeze) if freeze else None
    tx = j_make_optimizer(LR, WD, trainable_mask=mask)
    kw = {} if loss_fn is None else {"loss_fn": loss_fn}
    step = j_make_train_step(model, tx, donate=False, remat=remat, **kw)
    state = j_create(variables, tx)
    g, o = priors()
    rnn = np.asarray(model.init_state(H, W, clip(0)[0].shape[0]))
    stats, out = variables["batch_stats"], []
    for k in range(clips):
        start = (state.params, state.batch_stats, _adam(state.opt_state), rnn)
        x, y = clip(k)
        state, loss, rnn = step(state, x, g, o, rnn, y)
        rnn = np.asarray(rnn)
        # optax's add_decayed_weights -> scale_by_adam:
        # g_k + wd * p_{k-1} = (mu_k - b1 * mu_{k-1}) / (1 - b1)
        mu0, mu1 = (_port_named(a.mu, stats, state.params)
                    for a in (start[2], _adam(state.opt_state)))
        p0 = _port_named(start[0], stats)
        grads = {n: (mu1[n] - 0.9 * mu0[n]) / 0.1 - WD * p0[n] for n in mu1 if "running" not in n}
        out.append((start, float(loss), grads, _port_named(state.params, state.batch_stats),
                    rnn.astype(np.float64)))
    return out


def _f64(t):
    """A copy in f64 (an f64 tensor's `.numpy()` would share its memory)."""
    return t.detach().numpy().astype(np.float64)


def port_model(params, batch_stats, dtype):
    model = UAVSal(time_dims=T)
    model.load_state_dict(from_jax_variables({"params": params, "batch_stats": batch_stats}),
                          strict=True)
    return model.to(dtype)


def port_step(start, k, freeze, dtype, clip=clip_data, loss_fn=loss_fu, remat=False):
    """One port step in `dtype` on the CPU from a JAX starting point (see
    `run_jax`) on clip k (`clip(k)`), with `loss_fn`: (loss, gradients,
    state_dict after, TWA state after). The f64 run gets its frames
    normalized in f64."""
    params, batch_stats, adam, rnn = start
    model = port_model(params, batch_stats, dtype)
    mask = make_frozen_mask(model, freeze) if freeze else None
    optimizer = make_optimizer(model, LR, WD, trainable_mask=mask)
    if int(adam.count):
        mu, nu = (_port_named(a, batch_stats, params) for a in (adam.mu, adam.nu))
        for n, p in model.named_parameters():
            if p.requires_grad:
                optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                      "exp_avg": torch.from_numpy(mu[n]).to(dtype),
                                      "exp_avg_sq": torch.from_numpy(nu[n]).to(dtype)}
    state = create_train_state(model, optimizer)
    step = make_train_step(state, loss_fn, remat=remat)
    x, y = clip(k)
    x = torch.from_numpy(x)
    if dtype == torch.float64:
        mean, std = (torch.from_numpy(a).double() for a in (IMAGENET_MEAN, IMAGENET_STD))
        x = (x.double() / 255.0 - mean) / std
    g, o = (torch.from_numpy(a).to(dtype) for a in priors())
    loss, new_rnn = step(x, g, o, torch.tensor(rnn, dtype=dtype), torch.from_numpy(y).to(dtype))
    assert new_rnn.grad_fn is None and not new_rnn.requires_grad and state.step == 1
    grads = {n: _f64(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    return (float(loss), grads, {n: _f64(t) for n, t in model.state_dict().items()},
            _f64(new_rnn))


def _err(a, b, scale=None):
    top = np.abs(b).max() if scale is None else scale
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(top, 1e-30)


def bn_scale(name, sd):
    """The scale an error of a running stat is read against: the largest
    variance for a variance, and for a mean the largest mean plus the
    largest std of its channels, since a batch mean's rounding grows with
    the spread of what it sums as much as with the mean itself (a
    one-channel BatchNorm's mean may lie near 0)."""
    if name.endswith("running_var"):
        return np.abs(sd[name]).max()
    return np.abs(sd[name]).max() + np.sqrt(sd[name[:-len("mean")] + "var"].max())


def _l2(a, ref, floor=0.0):
    """Relative L2 error of a (dict of) array(s) against `ref`, the norm of
    `ref` floored at `floor`."""
    if isinstance(ref, dict):
        return np.sqrt(sum(((a[n] - ref[n]) ** 2).sum() for n in ref)
                       / sum((ref[n] ** 2).sum() for n in ref))
    return np.sqrt(((a - ref) ** 2).sum()) / max(np.sqrt((ref ** 2).sum()), floor)


def check_against_jax(jax_runs, freeze, trainable, **step_kw):
    """The comparison of the module docstring, clip by clip (`step_kw`:
    the clips, loss and remat of `port_step`, as `run_jax` ran them).
    Returns, per kind, the largest error of each package as a share of its
    bound."""
    worst = {}

    def held(kind, name, errs, bound):
        for who, err in zip(("jax", "port"), errs):
            assert err <= bound, f"{kind} {name}: {who} f32 {err:.3g} > {bound:.3g} from f64"
            worst[kind, who] = max(worst.get((kind, who), 0.0), err / bound)

    for k, (start, jl, jg, jsd, js) in enumerate(jax_runs):
        before = from_jax_variables({"params": start[0], "batch_stats": start[1]})
        l32, g32, sd32, s32 = port_step(start, k, freeze, torch.float32, **step_kw)
        l64, g64, sd64, s64 = port_step(start, k, freeze, torch.float64, **step_kw)
        held("loss", k, [abs(v - l64) / abs(l64) for v in (jl, l32)], TOL_LOSS)
        assert set(g32) == set(g64) == {n for n, t in trainable.items() if t}
        held("gradient", k, [_l2(g, g64) for g in (jg, g32)], TOL_GRAD)
        # a leaf whose exact gradient is 0 (a BatchNorm bias before another
        # BatchNorm) is read against 1e-4 of the whole gradient
        floor = 1e-4 * np.sqrt(sum((g ** 2).sum() for g in g64.values()))
        for n in g64:
            held("gradient leaf", n, [_l2(g[n], g64[n], floor) for g in (jg, g32)],
                 TOL_GRAD_LEAF)
        for n in sd64:
            if "running" in n:
                scale = bn_scale(n, sd64)
                held("bn", n, [_err(sd[n], sd64[n], scale) for sd in (jsd, sd32)], TOL_BN)
            elif trainable[n]:
                # 2 lr, and the rounding of the f32 values the step lands on
                ulp = np.spacing(np.float32(np.abs(sd32[n]).max()))
                assert np.abs(jsd[n] - sd32[n]).max() <= 2 * LR + 2 * ulp, f"{n} after clip {k}"
            else:
                frozen = np.asarray(before[n], np.float64)
                assert np.array_equal(sd32[n], frozen) and np.array_equal(jsd[n], frozen), n
        held("state", k, [_err(s, s64, 1.0) for s in (js, s32)], TOL_STATE)
    return worst


def train_step_matches_jax(variables, freeze):
    trainable = make_frozen_mask(UAVSal(time_dims=T), freeze)
    assert all(trainable[n] != bool(freeze) for n in trainable
               if n.startswith(("sfnet.", "st_layer.")))
    worst = check_against_jax(run_jax(variables, freeze), freeze, trainable)
    print(f"freeze={freeze}: largest error as a share of its bound {worst}")
    assert {kind for kind, _ in worst} == {"loss", "gradient", "gradient leaf", "bn", "state"}


def test_train_step_matches_jax(variables):
    """Every parameter trained (`freeze=()`); the default freeze mask is in
    `test_torch_train_freeze.py`, so that the two compile in two workers."""
    train_step_matches_jax(variables, ())


def test_port_gradient_is_the_derivative_of_its_loss(variables):
    """In f64: the gradient the port's train step takes (autograd through
    train-mode BatchNorm, MultiPriors' train form, the TWA scan and the
    head) against a central difference of its loss along a random
    direction in the parameters after the trunk. ReLU6 makes the loss
    piecewise smooth, so the difference converges only as fast as eps
    (measured 4.6e-2, 3.9e-3, 8e-4 and 1.5e-4 at eps 1e-4 to 1e-7);
    through the trunk's ~50 BatchNorms as well it does not settle at all."""
    model = port_model(variables["params"], variables["batch_stats"], torch.float64)
    model.train()
    x, y = clip_data(0)
    mean, std = (torch.from_numpy(a).double() for a in (IMAGENET_MEAN, IMAGENET_STD))
    x = (torch.from_numpy(x).double() / 255.0 - mean) / std
    g, o = (torch.from_numpy(a).double() for a in priors())
    rnn = torch.from_numpy(np.random.RandomState(3).normal(0, 0.5, (1, HO, WO, 256)))
    y = torch.from_numpy(y).double()

    def loss():
        out, _ = model(x, g, o, rnn)
        return loss_fu(out.reshape(S, HO, WO, 1), y.reshape(S, HO, WO, 2))

    after_trunk = ("gauss_cb_layer", "ob_cb_layer", "cxt_cb_prior", "fucb_layer",
                   "fucbst_layer", "rnn", "conv_out_st")
    params = [p for n, p in model.named_parameters() if n.startswith(after_trunk)]
    grads = torch.autograd.grad(loss(), params)
    rng = np.random.RandomState(4)
    direction = [torch.from_numpy(rng.normal(0, 1, p.shape)) * p.detach().abs().mean()
                 for p in params]
    eps = 1e-7
    with torch.no_grad():
        values = []
        for sign in (1, -1):
            for p, d in zip(params, direction):
                p.add_(sign * eps * d)
            values.append(loss().item())
            for p, d in zip(params, direction):
                p.sub_(sign * eps * d)
    numeric = (values[0] - values[1]) / (2 * eps)
    analytic = sum((gr * d).sum().item() for gr, d in zip(grads, direction))
    assert abs(numeric - analytic) <= TOL_DERIVATIVE * abs(analytic), (numeric, analytic)
