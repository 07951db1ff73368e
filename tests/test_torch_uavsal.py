"""The port's full UAVSal against the JAX package at 64x128, T=5, in f32.

One file, so the JAX model compiles in one worker. The JAX variables of
`uavsal_small` get seeded values (kernels with std 1/sqrt(fan_in), random
BatchNorm statistics), so the maps have structure to compare: with the
fresh init the sigmoid saturates and any port would pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models.backbone import MobileNetV2Pyramid as JPyramid
from iip_uavsal_saliency_tpu.models.convert import export_uavsal_state_dict
from iip_uavsal_saliency_tpu.models.srfnet import SRFNet as JSRFNet
from iip_uavsal_saliency_tpu.ops.fold import fold_batchnorm
from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.ops.layers import DWBlock
from test_torch_train_step import few_threads  # noqa: F401

SMALL_H, SMALL_W, SMALL_T = 64, 128, 5
# f32: XLA and torch order the conv sums differently. The JAX package held
# ~2e-5 against the reference's own torch model; this port is observed at
# <= 1.8e-7 on the saliency (std ~0.02) and <= 2.3e-6 on the state (values
# up to ~2.5) over both clips, V=1 and V=2, folded or not.
ATOL_FEATURES = 2e-5
ATOL_SALIENCY = 1e-6
ATOL_STATE = 1e-5


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
        else:
            fan_in = np.prod(np.shape(v)[:-1])
            out[k] = rng.normal(0.0, 1.0 / np.sqrt(fan_in), np.shape(v)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair(uavsal_small):
    """(jax model, seeded numpy variables, jitted jax apply)."""
    model, variables, _ = uavsal_small
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.RandomState(0))
    return model, variables, jax.jit(model.apply)


def _port(variables, fused_dwblock=False):
    m = UAVSal(time_dims=SMALL_T, fused_dwblock=fused_dwblock).eval()
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m


def _frames(v, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(v, SMALL_T, SMALL_H, SMALL_W, 3).astype(np.float32),
            rng.rand(SMALL_H // 8, SMALL_W // 8, 8).astype(np.float32),
            rng.rand(SMALL_H // 8, SMALL_W // 8, 20).astype(np.float32))


def test_bridge_matches_export_and_loads_strict(pair):
    _, variables, _ = pair
    want = export_uavsal_state_dict(variables)
    got = from_jax_variables(variables)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    UAVSal(time_dims=SMALL_T).load_state_dict(got, strict=True)
    UAVSal(time_dims=SMALL_T, fused_dwblock=True).load_state_dict(got, strict=True)
    back = to_jax_variables(got)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(variables)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_pyramid_and_srfnet_match_jax(pair):
    _, variables, _ = pair
    x, _, _ = _frames(1, 1)
    x = x[0]
    sub = lambda tree, *path: {k: _get(tree[k], path) for k in ("params", "batch_stats")}  # noqa: E731
    want_stages = JPyramid().apply(sub(variables, "trunk", "sfnet", "features"), jnp.asarray(x))
    want_srf = JSRFNet().apply(sub(variables, "trunk", "sfnet"), jnp.asarray(x))
    m = _port(variables)
    with torch.no_grad():
        frames = torch.from_numpy(x).permute(0, 3, 1, 2)
        stages = m.sfnet.features(frames)
        srf = m.sfnet(frames)
    assert len(stages) == 5
    for got, want in zip(stages, want_stages):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=ATOL_FEATURES, rtol=0)
    np.testing.assert_allclose(srf.permute(0, 2, 3, 1).numpy(), np.asarray(want_srf),
                               atol=ATOL_FEATURES, rtol=0)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("v", [1, 2])
def test_uavsal_two_clips_match_jax(pair, v, folded):
    jmodel, variables, japply = pair
    if folded:
        variables = jax.tree_util.tree_map(np.asarray, fold_batchnorm(variables))
    m = _port(variables)
    jstate = jmodel.init_state(SMALL_H, SMALL_W, v)
    tstate = m.init_state(SMALL_H, SMALL_W, v)
    assert tuple(tstate.shape) == tuple(jstate.shape)
    for clip in range(2):
        x, g, o = _frames(v, 10 * v + clip)
        want, jstate = japply(variables, jnp.asarray(x), jnp.asarray(g), jnp.asarray(o), jstate)
        with torch.no_grad():
            got, tstate = m(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(o), tstate)
        assert float(np.std(np.asarray(want))) > 1e-3  # maps with structure
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_SALIENCY, rtol=0)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), atol=ATOL_STATE, rtol=0)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("v", [1, 2])
def test_uavsal_fused_dwblock_two_clips_match_jax(pair, v, folded):
    """The slice as a whole: `UAVSal(fused_dwblock=True)`, every admitted
    block through `fused_dwblock` (its plain version on the CPU), against
    the JAX `UAVSal`, f32, saliency and carried state within 2e-5."""
    jmodel, variables, japply = pair
    if folded:
        variables = jax.tree_util.tree_map(np.asarray, fold_batchnorm(variables))
    m = _port(variables, fused_dwblock=True)
    fused = []
    for name, block in m.named_modules():
        if isinstance(block, DWBlock):
            block.register_forward_pre_hook(
                lambda b, inp, name=name: fused.append(name)
                if b.takes_kernel(inp[0].shape, inp[0].dtype) else None)
    jstate = jmodel.init_state(SMALL_H, SMALL_W, v)
    tstate = m.init_state(SMALL_H, SMALL_W, v)
    for clip in range(2):
        x, g, o = _frames(v, 10 * v + clip)
        want, jstate = japply(variables, jnp.asarray(x), jnp.asarray(g), jnp.asarray(o), jstate)
        with torch.no_grad():
            got, tstate = m(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(o), tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), atol=2e-5, rtol=0)
    assert len(fused) == 2 * 22  # blocks through the fused path, per clip
    assert {"st_layer.0.stconv_sp.spconv", "st_layer.1.stconv_sp.spconv", "fust_layer.0",
            "fucbst_layer.0"} <= set(fused)
