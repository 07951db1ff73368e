"""The ablation zoo's models against the JAX package on the CPU at 64x128,
T=5, S=10, f32: each of the 8 other `MODEL_ZOO` names (and
`uavsal_stblocks_type` at each `st_type`) in eval form through the adapter
at V=1 and V=2 (as the JAX package's `tests/test_models.py` runs the zoo and
its adapter), the weight bridge both ways and through the JAX package's
`convert_zoo_state_dict`, `init_model` against the JAX initializers (their
moments: the random streams differ), and the adapter's own contract.

Each model's JAX variable tree comes from `jax.eval_shape` of the JAX
adapter's `init` (no initializer runs) filled with seeded values, and the
JAX model runs un-jitted, as `tests/test_torch_uavsal_configs.py` does.
Within 2e-5, the port's f32 parity target against the JAX package
(ROADMAP); the maps are of order 0.5 and lie about 1e-6 apart."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import init_variables
from iip_uavsal_saliency_tpu.models import recurrent as jrec
from iip_uavsal_saliency_tpu.models.adapters import build_adapted_model as j_build_adapted
from iip_uavsal_saliency_tpu.models.convert import convert_zoo_state_dict
from iip_uavsal_saliency_tpu.ops import initializers as jinit
from iip_uavsal_saliency_tpu_torch.models import recurrent as trec
from iip_uavsal_saliency_tpu_torch.models.adapters import ZooModelAdapter, build_adapted_model
from iip_uavsal_saliency_tpu_torch.models.convert import (from_jax_variables, table_for,
                                                          table_of, to_jax_variables)
from iip_uavsal_saliency_tpu_torch.models.uavsal import MODEL_ZOO, UAVSalLSTM, UAVSalMP, init_model
from iip_uavsal_saliency_tpu_torch.ops import initializers as tinit
from test_torch_train_step import few_threads, randomized  # noqa: F401

H, W, T, S = 64, 128, 5, 10
HO, WO = H // 8, W // 8
ATOL = 2e-5
# every name but the flagship's, and the orderings of uavsal_stblocks_type
CASES = [(name, "st") for name in MODEL_ZOO if name != "uavsal"] + [
    ("uavsal_stblocks_type", st) for st in ("s2t", "t2s", "s_s2t")]


def case_id(case):
    name, st_type = case
    return name + ("" if st_type == "st" else f"-{st_type}")


def config(name, st_type):
    """The keywords every model is built with, as the CLI passes them; each
    class keeps those it has (`filter_kwargs`)."""
    return dict(time_dims=T, num_stblock=2, bias_type=(1, 1, 1), st_type=st_type)


def data(seed, name, v):
    """Normalized frames (V, S, H, W, 3), the priors and the carried state
    of the model's kind (ConvLSTM's h and c; the dummy (V, 8, 8, 1) zeros of
    a model without a state)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(v, S, H, W, 3).astype(np.float32)
    g = rng.rand(HO, WO, 8).astype(np.float32)
    o = rng.rand(HO, WO, 20).astype(np.float32)
    if name == "uavsal_lstm":
        state = rng.normal(0, 0.5, (v, 2, HO, WO, 256)).astype(np.float32)
    else:
        state = np.zeros((v, 8, 8, 1), np.float32)
    return x, g, o, state


@functools.lru_cache(maxsize=None)
def jax_zoo(name, st_type):
    """(the JAX adapter, its seeded variable tree)."""
    jm = j_build_adapted(name, filter_kwargs=True, **config(name, st_type))
    x, g, o, state = data(0, name, 1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), g, o,
                            jnp.asarray(state))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    return jm, randomized(zeros, np.random.RandomState(sum(map(ord, name + st_type))))


def port_zoo(name, st_type, variables):
    m = build_adapted_model(name, filter_kwargs=True, **config(name, st_type))
    m.load_state_dict(from_jax_variables(variables, table_of(m)), strict=True)
    return m.eval()


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_zoo_model_matches_jax(case, v):
    """One clip through the JAX adapter and the port's, both in eval form:
    the saliency (V, S, H/8, W/8, 1), and the state (ConvLSTM's, or the
    dummy passed through). At V=2 both bound the temporal differences and
    UAVSalMP's context tile per video."""
    name, st_type = case
    jm, variables = jax_zoo(name, st_type)
    m = port_zoo(name, st_type, variables)
    x, g, o, state = data(v, name, v)
    want, wstate = jm.apply(variables, *(jnp.asarray(a) for a in (x, g, o, state)))
    with torch.no_grad():
        got, gstate = m(*(torch.from_numpy(a) for a in (x, g, o, state)))
    assert got.shape == (v, S, HO, WO, 1) and gstate.shape == state.shape
    assert float(np.std(np.asarray(want))) > 1e-3  # maps with structure
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gstate.numpy(), np.asarray(wstate), atol=ATOL, rtol=0)
    if name != "uavsal_lstm":
        assert not gstate.any()  # the dummy state passes through


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_zoo_bridge_round_trips_through_jax_converter(case):
    """JAX tree -> `from_jax_variables` -> the JAX package's
    `convert_zoo_state_dict` gives the same tree, leaf for leaf (the
    port's table is that converter's inverse, under the reference's keys);
    `to_jax_variables` gives it back too; the keys are the model's own."""
    name, st_type = case
    _, variables = jax_zoo(name, st_type)
    table = table_for(model_name=name)
    sd = from_jax_variables(variables, table)
    assert list(sd) == [key for _, key, _ in table]
    assert set(sd) == set(port_zoo(name, st_type, variables).state_dict())
    flat_v = jax.tree_util.tree_flatten_with_path(variables)[0]
    for back in (convert_zoo_state_dict(name, {k: t.numpy() for k, t in sd.items()},
                                        num_stblock=2, bias_type=(1, 1, 1), st_type=st_type),
                 to_jax_variables(sd, table)):
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_b] == [p for p, _ in flat_v]
        for (path, a), (_, b) in zip(flat_v, flat_b):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))


def _moments_match(want, got):
    """Each conv kernel's std within 10% of the JAX init's for the same
    layer (or 4 sampling errors where a kernel is too small for that) and
    its mean within 4 sampling errors of 0 (xavier-uniform and kaiming-
    normal draws alike); BatchNorm at ones and zeros."""
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dim() >= 4:
            ratio = got[k].std().item() / w.std().item()
            allowed = max(0.1, 4 * np.sqrt(1.0 / w.numel()))
            assert abs(ratio - 1) <= allowed, (k, ratio, allowed)
            assert abs(got[k].mean().item()) <= 4 * w.std().item() / np.sqrt(w.numel()), k
        else:
            assert torch.equal(got[k], w), k


@pytest.mark.parametrize("name", ["uavsal_lstm", "uavsal_stc2_3d"])
def test_init_model_matches_the_jax_init_per_layer(name):
    """`init_model` on a whole zoo model against the JAX package's
    `init_variables` of the same model: ConvLSTM's gate xavier-uniform
    (a kaiming draw is sqrt(2) to 2 times wider there), the 3-D convs
    kaiming fan_out over 27 taps, the rest as the flagship's."""
    jm = j_build_adapted(name, filter_kwargs=True, **config(name, "st"))
    x, g, o, state = data(0, name, 1)
    fresh = init_variables(jm, jax.random.PRNGKey(1), jnp.asarray(x[:, :T]), g, o,
                           jnp.asarray(state))
    m = build_adapted_model(name, filter_kwargs=True, **config(name, "st"))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, dict(fresh)), table_of(m))
    got = init_model(m, torch.Generator().manual_seed(0)).state_dict()
    _moments_match(want, got)
    again = init_model(build_adapted_model(name, filter_kwargs=True, **config(name, "st")),
                       torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a, b) for a, b in zip(got.values(), again.values()))


@pytest.mark.parametrize("cell", ["ConvSimGRU", "ConvTWADW"])
def test_init_model_matches_the_jax_init_of_the_cells(cell):
    """The two recurrences no zoo name reaches: ConvSimGRU's gate kaiming
    fan_out, ConvTWADW's gate block kaiming fan_out with its BatchNorms at
    ones and zeros."""
    jm = getattr(jrec, cell)(hidden_dim=64)
    fresh = jm.init(jax.random.PRNGKey(2), jnp.zeros((2, 6, 7, 64)), jm.init_state(6, 7))
    tm = getattr(trec, cell)(64)
    if cell == "ConvTWADW":
        from iip_uavsal_saliency_tpu_torch.models import convert
        rows = convert._dwblock(("cell", "rnn_conv"), "cell_list.0.rnn_conv")
    else:
        rows = [(("params", "kernel"), "cell_list.0.rnn_conv.weight", True)]
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, dict(fresh)), rows)
    _moments_match(want, init_model(tm, torch.Generator().manual_seed(1)).state_dict())


# (name, keywords): each initializer of the JAX registry at one kernel shape
INITS = [("kaiming_normal", {"mode": "fan_out"}), ("kaiming_uniform", {}),
         ("xavier_uniform", {}), ("xavier_normal", {"gain": 2.0}),
         ("normal", {"mean": 0.5, "std": 0.2}), ("uniform", {"low": -1.0, "high": 3.0}),
         ("orthogonal", {}), ("ones", {}), ("zeros", {}), ("constant", {"value": 0.25})]


@pytest.mark.parametrize("init,kwargs", INITS, ids=[n for n, _ in INITS])
@pytest.mark.parametrize("shape", [(64, 32, 3, 3), (48, 16, 3, 3, 3)], ids=["2d", "3d"])
def test_initializers_match_jax(init, kwargs, shape):
    """`make_conv_init(name, **kw)` on an OIHW (OIDHW) kernel against the
    JAX package's on the same kernel in HWIO (DHWIO): mean and std within
    4 sampling errors (the fans are read off the same tensor), the constant
    ones exactly, orthogonal's flattened (taps * I, O) matrix orthonormal
    by columns. A generator's seed gives the same draw twice."""
    hwio = tuple(shape[2:]) + (shape[1], shape[0])
    want = np.asarray(jinit.make_conv_init(init, **kwargs)(jax.random.PRNGKey(3), hwio))
    fn = tinit.make_conv_init(init, **kwargs)
    got = fn(torch.empty(shape), torch.Generator().manual_seed(4))
    assert torch.equal(got, fn(torch.empty(shape), torch.Generator().manual_seed(4)))
    got_hwio = got.permute(*range(2, len(shape)), 1, 0).numpy()
    if init in ("ones", "zeros", "constant"):
        np.testing.assert_array_equal(got_hwio, want)
        return
    n = want.size
    sigma = want.std()
    assert abs(got_hwio.mean() - want.mean()) <= 4 * sigma * np.sqrt(2.0 / n), init
    assert abs(got_hwio.std() / sigma - 1) <= 4 * np.sqrt(1.0 / n) + 1e-3, init
    if init == "orthogonal":
        flat = got_hwio.reshape(-1, shape[0]).astype(np.float64)
        np.testing.assert_allclose(flat.T @ flat, np.eye(shape[0]), atol=1e-5)


def test_adapter_contract():
    """UAVSal and UAVSalLSTM come unwrapped (theirs is the stateful
    interface); the adapter's state_dict is the model's, under the
    reference's keys; `train()`/`eval()` reach the model's own flag
    (MultiPriors reads it); `init_state` takes the port's runner's and
    trainer's keywords; an unknown name raises KeyError; `filter_kwargs`
    drops what a class lacks, and without it the class refuses it."""
    lstm = build_adapted_model("uavsal_lstm", filter_kwargs=True, time_dims=T, st_type="s2t")
    assert type(lstm) is UAVSalLSTM
    state = lstm.init_state(H, W, 3, dtype=torch.bfloat16, device="cpu")
    assert state.shape == (3, 2, HO, WO, 256) and state.dtype == torch.bfloat16
    with pytest.raises(TypeError):
        ZooModelAdapter(lstm)
    m = build_adapted_model("uavsal_mp", filter_kwargs=True, time_dims=T, st_type="s2t")
    assert isinstance(m, ZooModelAdapter) and isinstance(m.model, UAVSalMP)
    assert list(m.state_dict()) == list(m.model.state_dict())
    assert m.model_name == "uavsal_mp" and m.bias_type == (1, 1, 1) and m.st_type is None
    m.eval()
    assert not m.model.training and not m.fucb_layer.training
    m.train()
    assert m.model.training
    state = m.init_state(H, W, 3, dtype=torch.bfloat16, device="cpu")
    assert state.shape == (3, 8, 8, 1) and state.dtype == torch.bfloat16
    spconv = build_adapted_model("uavsal_spconv", filter_kwargs=True, time_dims=T,
                                 bias_type=(1, 0, 1))
    assert spconv.init_state(H, W, 2).shape == (2, 8, 8, 1) and spconv.bias_type is None
    assert build_adapted_model("uavsal", time_dims=T).model_name == "uavsal"
    with pytest.raises(KeyError):
        build_adapted_model("uavsal_srf", filter_kwargs=True)
    with pytest.raises(TypeError):
        build_adapted_model("uavsal_spconv", time_dims=T)
