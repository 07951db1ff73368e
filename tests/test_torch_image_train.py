"""The image stage's train step against the JAX package on the CPU at
64x64: one step (`make_image_train_step`: train-mode forward, loss,
backward, Adam with no frozen part) from one seeded tree. The port's f32
step and the JAX package's (the step its `train_salicon` jits) are each held
to the port's f64 step with `tests/test_torch_train_step.py`'s bounds, and
the parameters after Adam to each other within 2 lr: a train-mode f32 step
is not reproducible to 1e-5 through the network's BatchNorms (that file's
docstring), so neither f32 run is held to the other directly.
"""


import jax
import numpy as np
import optax
import torch

from iip_uavsal_saliency_tpu.models import SRFNetImage as JSRFNetImage
from iip_uavsal_saliency_tpu.training.losses import loss_fu as j_loss_fu
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu_torch.data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, table_of
from iip_uavsal_saliency_tpu_torch.models.srfnet_image import SRFNetImage
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state,
                                                         make_image_train_step)
from test_torch_images import image_tree
from test_torch_train_step import (TOL_BN, TOL_GRAD, TOL_GRAD_LEAF, TOL_LOSS, _l2, bn_scale,
                                   few_threads)  # noqa: F401

LR, WD = 1e-4, 5e-5  # ImageTrainConfig's defaults
B = 2


def batch(seed=3):
    """uint8 images (B, 64, 64, 3) and targets (B, 8, 8, 2): a map in [0, 1]
    and binary fixations, one at least per image."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8)
    ymap = rng.rand(B, 8, 8, 1).astype(np.float32)
    ypts = (rng.rand(B, 8, 8, 1) < 0.1).astype(np.float32)
    ypts[:, 3, 4] = 1.0
    return x, np.concatenate([ymap, ypts], -1)


def run_jax_step(tree):
    """The JAX package's image train step (as `train_salicon` jits it): (loss,
    {port name: gradient}, {port name: parameter or BN stat after})."""
    model = JSRFNetImage()
    tx = j_make_optimizer(LR, WD)
    x, y = batch()
    xf = (x.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD

    @jax.jit
    def step(params, stats, opt_state):
        def loss_fn(p):
            pred, mut = model.apply({"params": p, "batch_stats": stats}, xf, train=True,
                                    mutable=["batch_stats"])
            return j_loss_fu(pred, y), mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates), new_stats

    loss, grads, params, stats = step(tree["params"], tree["batch_stats"],
                                      tx.init(tree["params"]))
    table = table_of(SRFNetImage())
    np_tree = jax.tree_util.tree_map(np.asarray, {"params": grads,
                                                  "batch_stats": tree["batch_stats"]})
    g = {k: v.double().numpy() for k, v in from_jax_variables(np_tree, table).items()
         if "running" not in k}
    after = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats}), table)
    return float(loss), g, {k: v.double().numpy() for k, v in after.items()}


def run_port_step(tree, dtype):
    model = SRFNetImage()
    model.load_state_dict(from_jax_variables(tree, table_of(model)), strict=True)
    model = model.to(dtype)
    state = create_train_state(model, make_optimizer(model, LR, WD))
    step = make_image_train_step(state)
    x, y = batch()
    x = torch.from_numpy(x)
    if dtype == torch.float64:
        mean, std = (torch.from_numpy(a).double() for a in (IMAGENET_MEAN, IMAGENET_STD))
        x = (x.double() / 255.0 - mean) / std
    loss = step(x, torch.from_numpy(y).to(dtype))
    assert state.step == 1 and loss.grad_fn is None
    grads = {n: p.grad.detach().numpy().astype(np.float64) for n, p in model.named_parameters()}
    after = {n: t.detach().numpy().astype(np.float64) for n, t in model.state_dict().items()}
    return float(loss), grads, after


def test_image_train_step_matches_jax():
    """Both f32 steps against the port's f64 step from the same point:
    loss, the whole gradient and each leaf, the BatchNorm stats; the two f32
    steps' parameters after Adam within 2 lr (and their rounding)."""
    tree = image_tree(seed=4)
    jl, jg, jsd = run_jax_step(tree)
    l32, g32, sd32 = run_port_step(tree, torch.float32)
    l64, g64, sd64 = run_port_step(tree, torch.float64)
    worst = {}

    def held(kind, name, errs, bound):
        for who, err in zip(("jax", "port"), errs):
            assert err <= bound, f"{kind} {name}: {who} f32 {err:.3g} > {bound:.3g} from f64"
            worst[kind, who] = max(worst.get((kind, who), 0.0), err / bound)

    held("loss", "", [abs(v - l64) / abs(l64) for v in (jl, l32)], TOL_LOSS)
    assert set(jg) == set(g32) == set(g64)
    held("gradient", "", [_l2(g, g64) for g in (jg, g32)], TOL_GRAD)
    floor = 1e-4 * np.sqrt(sum((g ** 2).sum() for g in g64.values()))
    for n in g64:
        held("gradient leaf", n, [_l2(g[n], g64[n], floor) for g in (jg, g32)], TOL_GRAD_LEAF)
    before = from_jax_variables(tree, table_of(SRFNetImage()))
    for n in sd64:
        if "running" in n:
            scale = bn_scale(n, sd64)
            held("bn", n, [np.abs(sd[n] - sd64[n]).max() / scale for sd in (jsd, sd32)], TOL_BN)
        else:
            ulp = np.spacing(np.float32(np.abs(sd32[n]).max()))
            assert np.abs(jsd[n] - sd32[n]).max() <= 2 * LR + 2 * ulp, n
            assert not np.array_equal(sd32[n], before[n].double().numpy()), f"{n} did not move"
    print(f"largest error as a share of its bound {worst}")
