"""The training slice's building blocks against the JAX package, on the CPU:
the losses and their per-frame and masked forms, train-mode BatchNorm, the
train-mode UAVSal forward (MultiPriors' train form, batch statistics over
all V*S frames), `init_model`, the optimizer and the freeze mask, and the
fused dwBlock's refusal of train mode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.models import init_variables
from iip_uavsal_saliency_tpu.ops.layers import TorchBatchNorm
from iip_uavsal_saliency_tpu.training import losses as jlosses
from iip_uavsal_saliency_tpu.training.optim import make_frozen_mask as j_frozen_mask
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu.training.trainer import _masked_loss as j_masked_loss
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.ops import layers as tl
from iip_uavsal_saliency_tpu_torch.training import losses as tlosses
from iip_uavsal_saliency_tpu_torch.training import optim as toptim
from iip_uavsal_saliency_tpu_torch.training.optim import (jax_param_paths, make_frozen_mask,
                                                          make_optimizer)
from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss
from test_torch_train_step import (FREEZE, H, HO, S, T, TOL_BN, TOL_STATE, W, WO, bn_scale,
                                   clip_data, few_threads, priors, variables)  # noqa: F401

# the losses, of the largest value: the port's f32 against its f64 run, and
# against the JAX package's f32, which lies up to 1.13e-6 from f64 itself
# (per-frame KL over 8x16 maps)
TOL_LOSS = 1e-6
TOL_LOSS_JAX = 2e-6


def _gaze(seed, n=S, ho=HO, wo=WO):
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0.01, 1.0, (n, ho, wo, 1)).astype(np.float32)
    ymap = rng.rand(n, ho, wo, 1).astype(np.float32)
    ypts = (rng.rand(n, ho, wo, 1) < 0.1).astype(np.float32)
    ypts[:, 2, 3] = 1.0
    return pred, np.concatenate([ymap, ypts], -1)


@pytest.mark.parametrize("name", ["metric_kl", "metric_cc", "metric_nss", "metric_sim",
                                  "per_frame_fu", "per_frame_kl", "per_frame_ml", "loss_fu",
                                  "loss_kl", "loss_ml"])
def test_losses_match_jax(name):
    pred, true = _gaze(0)
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(true)), np.float64)
    fn = getattr(tlosses, name)
    got = fn(torch.from_numpy(pred), torch.from_numpy(true)).double().numpy()
    exact = fn(torch.from_numpy(pred).double(), torch.from_numpy(true).double()).numpy()
    assert got.shape == want.shape
    top = np.abs(exact).max()
    assert np.abs(got - exact).max() <= TOL_LOSS * top
    assert np.abs(got - want).max() <= TOL_LOSS_JAX * top


def test_loss_fu_dy_and_the_tables_match_jax():
    pred, true = _gaze(1)
    pred5, true5 = pred.reshape(2, S // 2, HO, WO, 1), true.reshape(2, S // 2, HO, WO, 2)
    want = float(jlosses.loss_fu_dy(jnp.asarray(pred5), jnp.asarray(true5)))
    got = float(tlosses.loss_fu_dy(torch.from_numpy(pred5), torch.from_numpy(true5)))
    assert abs(got - want) <= TOL_LOSS_JAX * abs(want)
    assert set(tlosses.LOSSES) == set(jlosses.LOSSES)
    for key, fn in tlosses.LOSSES.items():
        assert fn.__name__ == jlosses.LOSSES[key].__name__
        assert tlosses.PER_FRAME[fn].__name__ == jlosses.PER_FRAME[jlosses.LOSSES[key]].__name__
    assert tlosses.EPS == jlosses.EPS


@pytest.mark.parametrize("key", ["fu", "kl", "ml"])
def test_masked_loss_matches_jax(key):
    """Half a clip of valid frames and the rest masked out, as a padded
    clip gives it; and a full clip equals the plain loss."""
    pred, true = _gaze(2)
    mask = np.zeros(true.shape[:3] + (1,), np.float32)
    mask[:6] = 1.0
    tm = np.concatenate([true, mask], -1)
    want = float(j_masked_loss(jlosses.LOSSES[key])(jnp.asarray(pred), jnp.asarray(tm)))
    got = float(_masked_loss(tlosses.LOSSES[key])(torch.from_numpy(pred), torch.from_numpy(tm)))
    assert abs(got - want) <= TOL_LOSS_JAX * abs(want)
    full = np.concatenate([true, np.ones_like(mask)], -1)
    plain = float(tlosses.LOSSES[key](torch.from_numpy(pred), torch.from_numpy(true)))
    masked = float(_masked_loss(tlosses.LOSSES[key])(torch.from_numpy(pred),
                                                     torch.from_numpy(full)))
    assert abs(masked - plain) <= TOL_LOSS * abs(plain)


@pytest.mark.parametrize("n,h,w", [(10, 8, 16), (2, 2, 4), (1, 45, 80)])
def test_train_batchnorm_matches_torch_batchnorm(n, h, w):
    """Output, and running stats after two updates, within 1e-6 of
    TorchBatchNorm (of the largest value) on activations of order 1 (the 16-sample case is
    cxt_cb_prior.1's at 64x128: the n/(n-1) factor is 16/15 there)."""
    rng = np.random.RandomState(n)
    c = 24
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    bn = tl.BatchNorm(c)
    bn.load_state_dict(from_jax_variables(variables, [
        (("params", "scale"), "weight", False), (("params", "bias"), "bias", False),
        (("batch_stats", "mean"), "running_mean", False),
        (("batch_stats", "var"), "running_var", False)]))
    bn.train()
    for step in range(2):
        x = rng.normal(0.3, 1.0, (n, h, w, c)).astype(np.float32)
        want, mutated = TorchBatchNorm().apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        with torch.no_grad():
            got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        for key, name in (("mean", "running_mean"), ("var", "running_var")):
            ref = np.asarray(variables["batch_stats"][key])
            err = np.abs(getattr(bn, name).numpy() - ref).max()
            assert err <= 1e-6 * np.abs(ref).max(), f"{name} after step {step}: {err}"
    bn.eval()  # eval mode reads the running stats, and moves nothing
    before = bn.running_var.clone()
    with torch.no_grad():
        bn(torch.randn(2, c, 3, 3))
    assert torch.equal(bn.running_var, before)


def test_train_batchnorm_keeps_f32_stats_under_bf16():
    """A bf16 activation with bf16 parameter copies (a mixed-precision
    step): the output stays bf16, the running stats f32, and they move as
    the f32 batch statistics of the bf16 values say."""
    bn = tl.BatchNorm(8).train()
    x = (torch.randn(4, 8, 5, 5) * 2 + 1).to(torch.bfloat16)
    cast = {"weight": bn.weight.to(torch.bfloat16), "bias": bn.bias.to(torch.bfloat16)}
    y = torch.func.functional_call(bn, cast, (x,))
    assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    xf = x.float()
    n = xf.numel() // 8
    want_var = 0.9 + 0.1 * xf.var(dim=(0, 2, 3), unbiased=False) * n / (n - 1)
    torch.testing.assert_close(bn.running_mean, 0.1 * xf.mean(dim=(0, 2, 3)), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_var, want_var, rtol=1e-6, atol=1e-6)


def test_train_forward_matches_jax(variables):
    """`UAVSal` in train mode against `model.apply(train=True,
    mutable=["batch_stats"])` on the same variables, V=1, S=10, with a
    carried state. As in `tests/test_torch_train_step.py`, a train-mode
    forward through ~100 BatchNorms is held to the port run in f64, both
    the JAX package's f32 result and the port's: the saliency within 1e-3
    (the JAX package's f32 measured 2.5e-4 from f64), the state within
    `TOL_STATE`, every running stat within `TOL_BN`."""
    model = JUAVSal(time_dims=T)
    x, _ = clip_data(7)
    x = ((x / 255.0 - np.asarray([0.485, 0.456, 0.406])) / np.asarray([0.229, 0.224, 0.225]))
    g, o = priors()
    s0 = np.random.RandomState(8).normal(0, 0.5, (1, HO, WO, 256)).astype(np.float32)
    (jout, jstate), mutated = jax.jit(
        lambda v, *a: model.apply(v, *a, train=True, mutable=["batch_stats"]))(
        variables, x.astype(np.float32), g, o, s0)
    ports = {}
    for dtype in (torch.float32, torch.float64):
        m = UAVSal(time_dims=T)
        m.load_state_dict(from_jax_variables(variables), strict=True)
        m.to(dtype).train()
        with torch.no_grad():
            out, st = m(*(torch.from_numpy(np.asarray(a)).to(dtype) for a in (x, g, o, s0)))
        assert out.shape == (1, S, HO, WO, 1) and st.shape == (1, HO, WO, 256)
        sd = {k: v.double().numpy().copy() for k, v in m.state_dict().items()}
        ports[dtype] = (out.double().numpy(), st.double().numpy(), sd)
    out64, st64, sd64 = ports[torch.float64]
    jsd = {k: v.double().numpy() for k, v in from_jax_variables(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]}).items()}
    for who, (out, st, sd) in {"jax": (np.asarray(jout, np.float64), np.asarray(jstate), jsd),
                               "port": ports[torch.float32]}.items():
        assert np.abs(out - out64).max() <= 1e-3, who
        assert np.abs(st - st64).max() <= TOL_STATE, who
        for k in sd64:
            if "running" in k:
                scale = bn_scale(k, sd64)
                assert np.abs(sd[k] - sd64[k]).max() <= TOL_BN * scale, (who, k)
    # the stats moved: train mode, and the ones of MultiPriors' S-row streams
    base = from_jax_variables(variables)
    assert not np.allclose(sd64["gauss_cb_layer.0.conv.0.1.running_var"],
                           base["gauss_cb_layer.0.conv.0.1.running_var"].numpy())


def test_multipriors_train_form_runs_the_streams_on_every_frame():
    """The prior streams and `fucb` see S rows in train mode (the n/(n-1)
    factor depends on it) and one or G rows in eval mode."""
    m = UAVSal(time_dims=T)
    rows = {}
    hooks = [getattr(m, name)[0].register_forward_pre_hook(
        lambda mod, inp, name=name: rows.__setitem__(name, inp[0].shape[0]))
        for name in ("gauss_cb_layer", "ob_cb_layer", "cxt_cb_prior", "fucb_layer")]
    x = torch.randn(1, S, H, W, 3)
    g, o = (torch.from_numpy(a) for a in priors())
    for train, want in ((True, {"gauss_cb_layer": S, "ob_cb_layer": S, "cxt_cb_prior": S // T,
                                "fucb_layer": S}),
                        (False, {"gauss_cb_layer": 1, "ob_cb_layer": 1,
                                 "cxt_cb_prior": S // T, "fucb_layer": S // T})):
        m.train(train)
        with torch.no_grad():
            m(x, g, o, m.init_state(H, W))
        assert rows == want, (train, rows)
    for h in hooks:
        h.remove()


def test_fused_dwblock_refuses_train_mode():
    """The kernel folds BatchNorm from the running stats, so a block in
    train mode never takes it (the JAX block's `_fused_path` refuses
    `train`); in eval mode the same block does."""
    block = tl.DWBlock(64, 64, 3, use_kernel=True)
    shape = (20, 64, 45, 80)
    assert block.training and not block.takes_kernel(shape, torch.bfloat16)
    assert block.eval().takes_kernel(shape, torch.bfloat16)
    model = UAVSal(fused_dwblock=True)
    blocks = [m for m in model.modules() if isinstance(m, tl.DWBlock)]
    assert not any(b.takes_kernel((20, 256, 45, 80), torch.float32) for b in blocks)
    model.eval()
    assert model.fust_layer[0].takes_kernel((20, 256, 45, 80), torch.float32)


def test_init_uavsal_matches_the_jax_init_per_layer(variables):
    """Each conv kernel's std within 10% of the JAX init's for the same
    layer (kaiming normal, fan_in or fan_out as the JAX module passes it;
    the wrong one moves a non-square kernel's std by sqrt(Co/Ci) or more), or
    within 4 sampling errors where a kernel is too small for 10%;
    BatchNorm at ones and zeros. The values differ: the random streams do."""
    jm = JUAVSal(time_dims=T)
    g, o = priors()
    fresh = init_variables(jm, jax.random.PRNGKey(1), jnp.zeros((1, S, H, W, 3)), g, o,
                           jm.init_state(H, W, 1))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, dict(fresh)))
    model = init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    worst = 0.0
    for k, w in want.items():
        if w.dim() == 4:
            ratio = got[k].std().item() / w.std().item()
            worst = max(worst, abs(ratio - 1))
            # the std of n normal draws is itself off by about 1/sqrt(2n): on
            # the smallest kernels (384 values) two draws part by 5% at 1 sigma
            allowed = max(0.1, 4 * np.sqrt(1.0 / w.numel()))
            assert abs(ratio - 1) <= allowed, (k, ratio, allowed)
        else:
            assert torch.equal(got[k], w), k
    assert worst > 0  # drawn, not copied
    again = init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(got.values(), again.state_dict().values()))


def test_frozen_mask_matches_jax(variables, monkeypatch):
    jmask = j_frozen_mask(variables["params"], FREEZE)
    paths = jax_param_paths()
    flat = {"/".join(str(k.key) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    got = make_frozen_mask(UAVSal(time_dims=T), FREEZE)
    assert {paths[n]: t for n, t in got.items()} == flat
    assert sum(got.values()) == 91  # the prior streams, the TWA gate and the head
    warned = []
    monkeypatch.setattr(toptim.log, "warning", lambda msg, *args: warned.append(msg % args))
    make_frozen_mask(UAVSal(time_dims=T), ("sfnet",))  # the port's name, not the JAX path
    assert len(warned) == 1 and "'sfnet' matches no parameter" in warned[0]


@pytest.mark.parametrize("freeze", [(), FREEZE], ids=["all", "default_freeze"])
def test_optimizer_matches_optax(variables, freeze):
    """Fed the same gradients, with weight decay and the mask, over 3 steps:
    the parameters within 1e-7 (or two f32 ulps), frozen ones unmoved."""
    lr, wd = 1e-3, 5e-5
    params = variables["params"]
    mask = j_frozen_mask(params, freeze) if freeze else None
    tx = j_make_optimizer(lr, wd, trainable_mask=mask)
    opt_state = tx.init(params)
    model = UAVSal(time_dims=T)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    optimizer = make_optimizer(model, lr, wd,
                               trainable_mask=make_frozen_mask(model, freeze) if freeze else None)
    rng = np.random.RandomState(9)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(0, 1e-2, np.shape(p)).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        tgrads = from_jax_variables({"params": grads, "batch_stats": variables["batch_stats"]})
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone() if p.requires_grad else None
        optimizer.step()
    want = from_jax_variables({"params": params, "batch_stats": variables["batch_stats"]})
    start = from_jax_variables(variables)
    frozen = 0
    for n, p in model.named_parameters():
        # 1e-7, or two f32 ulps of the value where that is more (1.19e-7 each
        # above 1: the two round the update's terms in other orders)
        tol = max(1e-7, 2 * float(np.spacing(np.float32(want[n].abs().max()))))
        err = (p.detach() - want[n]).abs().max().item()
        assert err <= tol, (n, err, tol)
        if not p.requires_grad:
            frozen += 1
            assert torch.equal(p.detach(), start[n]), n
    assert (frozen > 0) == bool(freeze)


def test_jax_tree_round_trip_of_a_trained_model():
    """`to_jax_variables` of a model after train-mode forwards is what
    `from_jax_variables` reads back (the `_final.ckpt` tree)."""
    m = init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(3)).train()
    with torch.no_grad():
        m(torch.randn(1, S, H, W, 3), *(torch.from_numpy(a) for a in priors()),
          m.init_state(H, W))
    sd = m.state_dict()
    back = from_jax_variables(to_jax_variables(sd))
    assert all(torch.equal(sd[k], back[k]) for k in sd)


def test_trainer_refuses_folded_variables(variables, tmp_path):
    """Variables folded for serving (`fold_batchnorm`) carry its signature;
    training on them would count the BN scale twice, so the trainer
    refuses them as the JAX trainer does."""
    from iip_uavsal_saliency_tpu_torch.ops.fold import fold_batchnorm, looks_folded
    from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer

    folded = fold_batchnorm(variables)
    assert looks_folded(from_jax_variables(folded))
    assert not looks_folded(from_jax_variables(variables))
    with pytest.raises(ValueError, match="fold_batchnorm"):
        Trainer(TrainConfig(iosize=(H, W, HO, WO)), "", "UAV2", str(tmp_path),
                pre_variables=folded, device="cpu", ob_prior=np.zeros((HO, WO, 20), np.float32))


def test_training_after_serving_in_one_process():
    """A serving step (under `inference_mode`) and then a train step at the
    same size: what the serving step cached (the resize matrices) must not
    be an inference tensor that autograd refuses to save."""
    from iip_uavsal_saliency_tpu_torch.serving.steps import build_infer_fn
    from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

    model = init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(4))
    g, o = (torch.from_numpy(a) for a in priors())
    x, y = clip_data(9)
    x = torch.from_numpy(x)
    model.eval()
    build_infer_fn(model)(x, g, o, model.init_state(H, W))
    step = make_train_step(create_train_state(model, make_optimizer(model)))
    loss, _ = step(x, g, o, model.init_state(H, W), torch.from_numpy(y))
    assert torch.isfinite(loss)
