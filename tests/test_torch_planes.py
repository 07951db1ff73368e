"""`planes=` against the JAX package on the CPU at 64x128, T=5, S=10, f32:
at `planes=128` (SRF-Net's `last_channel == 128` branch: laterals of 32,
32, 64 and 128 channels, the ST blocks' temporal width 128 / 4, the prior
fusion's `planes // 4`, the TWA state of 128 channels) the eval forward
and state of `UAVSal`, `UAVSalMP` (MultiPriors), `UAVSalTeConv` (the
temporal branch alone), `UAVSalLSTM` and `SRFNetImage` within 2e-5; the
weight bridge both ways; one train step of `UAVSal(planes=128)` at the
bounds of `tests/test_torch_train_step.py`; and `SRFNetImage(planes=512)`,
whose SRF-Net keeps the default laterals under a 512-channel `conv_last`.

The JAX variable trees come from `jax.eval_shape` of `init` filled with
seeded values, as in `tests/test_torch_zoo_models.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as step_test
from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.models.adapters import build_adapted_model as j_build_adapted
from iip_uavsal_saliency_tpu.models.srfnet_image import SRFNetImage as JSRFNetImage
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.models.convert import (from_jax_variables, table_of,
                                                          to_jax_variables)
from iip_uavsal_saliency_tpu_torch.models.srfnet_image import SRFNetImage
from _dp_runs import train_steps
from test_torch_train_step import (LR, TOL_BN, TOL_GRAD, TOL_GRAD_LEAF, TOL_LOSS,  # noqa: F401
                                   TOL_STATE, WD, _adam, _err, _l2, _port_named, bn_scale,
                                   clip_data, few_threads, priors, randomized)

H, W, T, S = 64, 128, 5, 10
HO, WO = H // 8, W // 8
PLANES = 128
ATOL = 2e-5
MODELS = ("uavsal", "uavsal_mp", "uavsal_teconv", "uavsal_lstm")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def data(seed, name, v=1):
    """Normalized frames, the priors and the carried state of the model's
    kind (TWA's, ConvLSTM's h and c, or the dummy (V, 8, 8, 1) zeros)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(v, S, H, W, 3).astype(np.float32)
    g = rng.rand(HO, WO, 8).astype(np.float32)
    o = rng.rand(HO, WO, 20).astype(np.float32)
    if name == "uavsal":
        state = rng.normal(0, 0.5, (v, HO, WO, PLANES)).astype(np.float32)
    elif name == "uavsal_lstm":
        state = rng.normal(0, 0.5, (v, 2, HO, WO, PLANES)).astype(np.float32)
    else:
        state = np.zeros((v, 8, 8, 1), np.float32)
    return x, g, o, state


@functools.lru_cache(maxsize=None)
def jax_model(name):
    """(the JAX adapter at planes=128, its seeded variable tree)."""
    jm = j_build_adapted(name, filter_kwargs=True, time_dims=T, planes=PLANES)
    x, g, o, state = data(0, name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), g, o,
                            jnp.asarray(state))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    return jm, randomized(zeros, np.random.RandomState(sum(map(ord, name))))


def jax_apply(jm, variables, *args):
    """`jm.apply` compiled whole (eager, the flagship's first call takes 22 s
    on the CPU, compiled 4 s)."""
    return jax.jit(jm.apply)(variables, *(jnp.asarray(a) for a in args))


def port_model(name, variables):
    m = build_adapted_model(name, filter_kwargs=True, time_dims=T, planes=PLANES)
    m.load_state_dict(from_jax_variables(variables, table_of(m)), strict=True)
    return m.eval()


@pytest.mark.parametrize("name", MODELS)
def test_planes_128_model_matches_jax(name):
    jm, variables = jax_model(name)
    m = port_model(name, variables)
    assert getattr(m, "planes") == PLANES
    x, g, o, state = data(1, name)
    want, wstate = jax_apply(jm, variables, x, g, o, state)
    with torch.no_grad():
        got, gstate = m(*(torch.from_numpy(a) for a in (x, g, o, state)))
    assert got.shape == (1, S, HO, WO, 1) and gstate.shape == state.shape
    assert float(np.std(np.asarray(want))) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gstate.numpy(), np.asarray(wstate), atol=ATOL, rtol=0)
    if name in ("uavsal", "uavsal_lstm"):
        assert not np.allclose(gstate.numpy(), state)


@pytest.mark.parametrize("name", MODELS)
def test_planes_128_bridge_both_ways(name):
    """JAX tree -> state_dict -> JAX tree, leaf for leaf, under the model's
    own keys and shapes."""
    _, variables = jax_model(name)
    m = build_adapted_model(name, filter_kwargs=True, time_dims=T, planes=PLANES)
    table = table_of(m)
    sd = from_jax_variables(variables, table)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}
    back = dict(_leaves(to_jax_variables(sd, table)))
    want = dict(_leaves(variables))
    assert sorted(back) == sorted(want)
    for path, a in want.items():
        assert np.array_equal(back[path], a), path


@pytest.mark.parametrize("planes", [128, 512])
def test_srfnet_image_matches_jax(planes):
    """128: the narrow laterals; 512: the default laterals under a
    512-channel `conv_last` (the JAX SRFNet's `last_channel`)."""
    jm = JSRFNetImage(planes=planes)
    x = np.random.RandomState(2).randn(2, H, W, 3).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = randomized(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                  dict(shapes)), np.random.RandomState(planes))
    m = SRFNetImage(planes=planes)
    m.load_state_dict(from_jax_variables(variables, table_of(m)), strict=True)
    lateral = m.sfnet.conv_lv3[0].out_channels
    assert lateral == (32 if planes == 128 else 64)
    assert m.sfnet.conv_last[0].out_channels == planes
    want = jax_apply(jm, variables, x)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    assert got.shape == (2, HO, WO, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_planes_128_train_step_matches_jax(monkeypatch):
    """One f32 train step of UAVSal(planes=128), every parameter trained:
    the JAX package's and the port's each held to the port's f64 step
    from the same start at `tests/test_torch_train_step.py`'s bounds (at
    64x128, where those were measured: at 32x64 the JAX package's f32
    running variances lie 1.3e-4 from the f64 step's, above `TOL_BN`)."""
    monkeypatch.setattr(step_test, "JUAVSal", functools.partial(JUAVSal, planes=PLANES))
    jm = JUAVSal(time_dims=T, planes=PLANES)
    g, o = priors()
    x0 = np.zeros((1, S, H, W, 3), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0, g, o, jm.init_state(H, W, 1))
    variables = randomized(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                                  dict(shapes)), np.random.RandomState(0))
    (start, jl, jg, jsd, js), = step_test.run_jax(variables, (), clips=1)
    params, stats, _, rnn = start
    weights = {n: a.astype(np.float32) for n, a in _port_named(params, stats).items()}
    x, y = clip_data(0)
    mean, std = (a.astype(np.float64) for a in (step_test.IMAGENET_MEAN, step_test.IMAGENET_STD))
    run = {"model": {"time_dims": T, "planes": PLANES}, "weights": weights, "lr": LR, "wd": WD,
           "rnn": np.asarray(rnn), "gauss": g, "ob": o, "loss": "plain"}
    r32, r64 = train_steps(None, [dict(run, dtype="float32", clips=[(x, y)]),
                                  dict(run, dtype="float64",
                                       clips=[((x / 255.0 - mean) / std, y)])])
    l64, g64, sd64, s64 = r64["losses"][0], r64["grads"][0], r64["after"], r64["rnn"][0]
    assert s64.shape == (1, HO, WO, PLANES)
    port = (r32["losses"][0], r32["grads"][0], r32["after"], r32["rnn"][0])
    for who, (loss, grads, sd, state) in (("jax", (jl, jg, jsd, js)), ("port", port)):
        assert abs(loss - l64) / abs(l64) <= TOL_LOSS, who
        assert _l2(grads, g64) <= TOL_GRAD, who
        floor = 1e-4 * np.sqrt(sum((v ** 2).sum() for v in g64.values()))
        for n in g64:
            assert _l2(grads[n], g64[n], floor) <= TOL_GRAD_LEAF, (who, n)
        for n in sd64:
            if "running" in n:
                assert _err(sd[n], sd64[n], bn_scale(n, sd64)) <= TOL_BN, (who, n)
        assert _err(state, s64, 1.0) <= TOL_STATE, who
