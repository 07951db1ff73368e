"""The port's UAVSal at the JAX package's other configurations, on the CPU
at 64x128, T=5, in f32: the ResNet-18, ResNet-50 and VGG16 backbones with
the weight bridge per configuration, and `cli modelsize` against the JAX
package's report. `tests/test_torch_uavsal_knobs.py` (`num_stblock`, the
space-to-depth stem, the fold) and `tests/test_torch_uavsal_priors.py`
(the 8 `bias_type`s) use the helpers here.

Each configuration's JAX variable tree comes from `jax.eval_shape` of the
JAX `UAVSal` (no initializer runs) filled with seeded values
(`test_torch_train_step.randomized`). `to_jax_variables(from_jax_variables
(v, table), table)` must give that tree back leaf for leaf, which holds the
configuration's bridge table to the JAX module's tree exactly. The JAX
model runs un-jitted (`model.apply`), so no XLA compile of a deep graph
lands here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.ops.stats import model_size_report as j_model_size_report
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.models.convert import (from_jax_variables, table_for,
                                                          table_of, to_jax_variables)
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from test_torch_train_step import few_threads, randomized  # noqa: F401

H, W, T = 64, 128, 5
HO, WO = H // 8, W // 8
# f32 against the JAX model (XLA and torch sum conv products in other
# orders): the flagship holds 1e-6 on the saliency and 1e-5 on the state
# (tests/test_torch_uavsal.py). The ResNet trunks grow their activations
# with depth on these seeded weights, and the state (values up to ~4 here)
# carries that on: ResNet-50 measured 4.8e-7 on the saliency and 6.7e-6 on
# the state, so both bounds are doubled to 2e-6 and 2e-5.
ATOL_SALIENCY = 2e-6
ATOL_STATE = 2e-5


def config_id(cfg):
    cnn_type, num_stblock, bias_type, s2d = cfg
    return f"{cnn_type}-st{num_stblock}-b{''.join(map(str, bias_type))}" + ("-s2d" if s2d else "")


@functools.lru_cache(maxsize=None)
def jax_config(cnn_type="mobilenet_v2", num_stblock=2, bias_type=(1, 1, 1), s2d_stem=False):
    """(JAX UAVSal, its seeded variable tree) of one configuration."""
    jm = JUAVSal(cnn_type=cnn_type, time_dims=T, num_stblock=num_stblock, bias_type=bias_type,
                 s2d_stem=s2d_stem)
    g = jnp.zeros((HO, WO, 8)) if bias_type[0] else None
    o = jnp.zeros((HO, WO, 20)) if bias_type[1] else None
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, T, H, W, 3)), g, o,
                            jm.init_state(H, W, 1))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    return jm, randomized(zeros, np.random.RandomState(sum(map(ord, cnn_type)) + num_stblock))


def port_model(cfg, variables, train=False):
    cnn_type, num_stblock, bias_type, s2d = cfg
    m = UAVSal(time_dims=T, cnn_type=cnn_type, num_stblock=num_stblock, bias_type=bias_type,
               s2d_stem=s2d)
    m.load_state_dict(from_jax_variables(variables, table_of(m)), strict=True)
    return m.train(train)


def clip(seed, bias_type, v=1, s=T):
    """Normalized frames, the priors that `bias_type` switches on (else
    None) and a carried state, seeded."""
    rng = np.random.RandomState(seed)
    x = rng.randn(v, s, H, W, 3).astype(np.float32)
    g = rng.rand(HO, WO, 8).astype(np.float32)
    o = rng.rand(HO, WO, 20).astype(np.float32)
    state = rng.normal(0, 0.5, (v, HO, WO, 256)).astype(np.float32)
    return x, g if bias_type[0] else None, o if bias_type[1] else None, state


def as_jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def as_torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def assert_round_trip(cfg, variables):
    """The configuration's table maps the JAX tree to the port's state_dict
    and back, leaf for leaf, and loads strict."""
    cnn_type, num_stblock, bias_type, _ = cfg
    table = table_for(cnn_type, num_stblock, bias_type)
    back = to_jax_variables(from_jax_variables(variables, table), table)
    flat_v = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_v]
    for (path, a), (_, b) in zip(flat_v, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert table_of(port_model(cfg, variables)) == table


def run_both(cfg, variables, jm, data, m=None):
    """One clip through the JAX model and the port: ((saliency, state) of
    each), as numpy."""
    want, wstate = jm.apply(variables, *as_jax(*data))
    m = m or port_model(cfg, variables)
    with torch.no_grad():
        got, gstate = m(*as_torch(*data))
    return (np.asarray(want), np.asarray(wstate)), (got.numpy(), gstate.numpy())


def assert_close(want, got):
    (ws, wst), (gs, gst) = want, got
    assert gs.shape == ws.shape and gst.shape == wst.shape
    assert float(np.std(ws)) > 1e-3  # maps with structure
    np.testing.assert_allclose(gs, ws, atol=ATOL_SALIENCY, rtol=0)
    np.testing.assert_allclose(gst, wst, atol=ATOL_STATE, rtol=0)


BACKBONES = [("resnet18", 1, (1, 0, 1), False), ("resnet50", 2, (1, 1, 1), False),
             ("vgg16", 2, (1, 1, 1), False)]


@pytest.mark.parametrize("cfg", BACKBONES, ids=config_id)
def test_uavsal_backbones_match_jax(cfg):
    """The whole model in eval form: two clips with the state carried (the
    second from the first's output state) for ResNet-18 with one STBlock
    and the ob stream off (the `cli` tests' configuration), one clip from
    a seeded state for ResNet-50 and VGG16."""
    jm, variables = jax_config(*cfg)
    assert_round_trip(cfg, variables)
    m = port_model(cfg, variables)
    x, g, o, state = clip(1, cfg[2])
    for k in range(2 if cfg[0] == "resnet18" else 1):
        want, got = run_both(cfg, variables, jm, (x, g, o, state), m)
        assert_close(want, got)
        x, state = clip(2 + k, cfg[2])[0], want[1]


@pytest.mark.parametrize("cnn_type", ["mobilenet_v2", "resnet50"])
def test_cli_modelsize_matches_jax(cnn_type, capsys):
    """`cli modelsize` prints the JAX package's report (JAX `ops/stats.py::
    model_size_report` over the JAX model's variable tree, which it reads
    for shapes and dtypes only) for the flagship and for ResNet-50."""
    _, variables = jax_config(cnn_type, 2, (1, 1, 1), False)
    want = j_model_size_report(variables)
    assert cli.main(["modelsize", "--cnn_type", cnn_type]) == 0
    assert capsys.readouterr().out.strip() == want
    assert "trunk" in want and "Total" in want
