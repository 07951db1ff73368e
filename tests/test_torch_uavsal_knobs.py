"""The port's UAVSal at the JAX package's other knobs, on the CPU at
64x128, T=5, in f32: `num_stblock` 1 and 3, the space-to-depth stem, and
the BatchNorm fold of the new backbones, each against the JAX model run
un-jitted on the same seeded tree (helpers and bounds:
`tests/test_torch_uavsal_configs.py`)."""

import jax
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.ops import fold as jfold
from iip_uavsal_saliency_tpu_torch.models.convert import (from_jax_variables, table_for,
                                                          table_of, to_jax_variables)
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.ops import fold as tfold
from iip_uavsal_saliency_tpu_torch.ops.layers import BatchNorm
from test_torch_train_step import few_threads  # noqa: F401
from test_torch_uavsal_configs import (ATOL_SALIENCY, ATOL_STATE, as_jax, as_torch,
                                       assert_close, assert_round_trip, clip, config_id,
                                       jax_config, port_model, run_both)


@pytest.mark.parametrize("num_stblock", [1, 3])
def test_num_stblock_matches_jax(num_stblock):
    cfg = ("mobilenet_v2", num_stblock, (1, 1, 1), False)
    jm, variables = jax_config(*cfg)
    assert_round_trip(cfg, variables)
    m = port_model(cfg, variables)
    assert len(m.st_layer) == num_stblock
    assert_close(*run_both(cfg, variables, jm, clip(4, cfg[2]), m))


@pytest.mark.parametrize("other", [("mobilenet_v2", 2, (1, 1, 1)), ("mobilenet_v2", 3, (1, 0, 1)),
                                   ("resnet18", 3, (1, 1, 1))],
                         ids=["flagship", "priors", "backbone"])
def test_bridge_refuses_another_configurations_table(other):
    """A 3-STBlock tree or state_dict read through another configuration's
    table (the flagship's is the default) raises, where it would drop
    `st_layer_2` or a prior stream, or miss the backbone's keys."""
    cfg = ("mobilenet_v2", 3, (1, 1, 1), False)
    _, variables = jax_config(*cfg)
    sd = UAVSal(time_dims=5, num_stblock=3).state_dict()
    with pytest.raises(ValueError, match="not the table's configuration"):
        from_jax_variables(variables, table_for(*other))
    with pytest.raises(ValueError, match="not the table's configuration"):
        to_jax_variables(sd, table_for(*other))
    if other == ("mobilenet_v2", 2, (1, 1, 1)):
        with pytest.raises(ValueError, match="st_layer_2"):
            from_jax_variables(variables)
        with pytest.raises(ValueError, match="st_layer.2"):
            to_jax_variables(sd)


def test_s2d_stem_uavsal_matches_jax_and_the_plain_stem():
    """`UAVSal(s2d_stem=True)` takes the plain model's tree and table, and
    matches the JAX model with `s2d_stem=True` and the plain port model."""
    cfg = ("mobilenet_v2", 2, (1, 1, 1), True)
    jm, variables = jax_config(*cfg)
    assert table_for() == table_of(port_model(cfg, variables))
    assert_round_trip(cfg, variables)
    data = clip(5, cfg[2])
    want, got = run_both(cfg, variables, jm, data)
    assert_close(want, got)
    plain = port_model(("mobilenet_v2", 2, (1, 1, 1), False), variables)
    with torch.no_grad():
        base, base_state = plain(*as_torch(*data))
    np.testing.assert_allclose(got[0], base.numpy(), atol=ATOL_SALIENCY, rtol=0)
    np.testing.assert_allclose(got[1], base_state.numpy(), atol=ATOL_STATE, rtol=0)


@pytest.mark.parametrize("cfg", [("resnet18", 1, (1, 0, 1), False), ("vgg16", 2, (1, 1, 1), False),
                                 ("mobilenet_v2", 2, (1, 1, 1), True)], ids=config_id)
def test_fold_matches_jax(cfg):
    """`fold_conv_bn` folds the pairs the JAX `fold_batchnorm` folds (every
    BatchNorm of ResNet-18 and MobileNetV2, the S2D stem's among them;
    VGG16's biased convs have none and stay as they are): the folded port
    model against the JAX model on the JAX-folded tree within the eval
    bounds, and the port's own numpy `fold_batchnorm` equal to the JAX one
    leaf for leaf."""
    jm, variables = jax_config(*cfg)
    jfolded = jax.tree_util.tree_map(np.asarray, jfold.fold_batchnorm(variables))
    tfolded = tfold.fold_batchnorm(variables)
    flat_j = jax.tree_util.tree_flatten_with_path(jfolded)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tfolded)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    m = port_model(cfg, variables)
    n_bn = sum(isinstance(mod, BatchNorm) for mod in m.modules())
    tfold.fold_conv_bn(m)
    assert not any(isinstance(mod, BatchNorm) for mod in m.modules())
    if cfg[0] == "vgg16":
        assert all(m.sfnet.features.features[i].weight.equal(
            torch.from_numpy(np.ascontiguousarray(
                variables["params"]["trunk"]["sfnet"]["features"][f"conv{s}_{b}"]["kernel"]
                .transpose(3, 2, 0, 1))))
            for s, b, i in ((1, 1, 0), (5, 3, 28)))
    data = clip(6, cfg[2])
    want, wstate = jm.apply(jfolded, *as_jax(*data))
    with torch.no_grad():
        got, gstate = m(*as_torch(*data))
    assert n_bn > 0
    assert_close((np.asarray(want), np.asarray(wstate)), (got.numpy(), gstate.numpy()))
