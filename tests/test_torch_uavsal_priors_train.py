"""The port's MultiPriors at all 8 `bias_type`s in the whole UAVSal, train
form (`model.apply(train=True, mutable=["batch_stats"])` in the JAX
package), on the CPU at 64x128, V=1, S=10, f32, MobileNetV2 with one
STBlock; the eval form and the helpers are in
`tests/test_torch_uavsal_priors.py`."""

import jax
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch.models.convert import from_jax_variables, table_of
from test_torch_train_step import TOL_BN, TOL_STATE, bn_scale, few_threads  # noqa: F401
from test_torch_uavsal_configs import T, as_jax, as_torch, clip, jax_config, port_model
from test_torch_uavsal_priors import BIAS_TYPES, STREAMS, S, bt_id, cfg_of, rows_seen

# a forward through ~60 train-mode BatchNorms is held to the port's f64
# run, both the JAX package's f32 result and the port's, as
# tests/test_torch_train_layers.py::test_train_forward_matches_jax does:
# the saliency within 1e-3 (the JAX package's f32 lay 1.3e-4 to 3.6e-4 from
# the port's f32 here), the state within TOL_STATE, each running stat
# within TOL_BN of its scale
TOL_TRAIN_SALIENCY = 1e-3


@pytest.mark.parametrize("bias_type", BIAS_TYPES, ids=bt_id)
def test_bias_type_train_form_matches_jax(bias_type):
    """`model.apply(train=True, mutable=["batch_stats"])` against the port
    in train mode: the saliency, the carried state and every running stat,
    with the streams and `fucb` on all S rows."""
    cfg = cfg_of(bias_type)
    jm, variables = jax_config(*cfg)
    data = clip(8, bias_type, s=S)
    (jout, jstate), mutated = jm.apply(variables, *as_jax(*data), train=True,
                                       mutable=["batch_stats"])
    table = table_of(port_model(cfg, variables))
    ports = {}
    for dtype in (torch.float32, torch.float64):
        m = port_model(cfg, variables, train=True).to(dtype)
        rows = rows_seen(m)
        with torch.no_grad():
            out, st = m(*(None if t is None else t.to(dtype) for t in as_torch(*data)))
        # the prior streams and `fucb` on all S rows; the context stream's
        # convs on the G = S / time_dims group sums, tiled to S after
        assert rows == ({name: S for name, on in zip(STREAMS[:2], bias_type) if on}
                        | ({"cxt_cb_prior": S // T} if bias_type[2] else {})
                        | ({"fucb_layer": S} if any(bias_type) else {}))
        sd = {k: v.double().numpy().copy() for k, v in m.state_dict().items()}
        ports[dtype] = (out.double().numpy(), st.double().numpy(), sd)
    out64, st64, sd64 = ports[torch.float64]
    jsd = {k: v.double().numpy() for k, v in from_jax_variables(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]}, table).items()}
    for who, (out, st, sd) in {"jax": (np.asarray(jout, np.float64), np.asarray(jstate), jsd),
                               "port": ports[torch.float32]}.items():
        assert np.abs(out - out64).max() <= TOL_TRAIN_SALIENCY, who
        assert np.abs(st - st64).max() <= TOL_STATE, who
        for k in sd64:
            if "running" in k:
                assert np.abs(sd[k] - sd64[k]).max() <= TOL_BN * bn_scale(k, sd64), (who, k)
    assert float(np.std(out64)) > 1e-3
    moved = from_jax_variables(variables, table)
    assert not np.allclose(sd64["fust_layer.0.conv.0.1.running_var"],
                           moved["fust_layer.0.conv.0.1.running_var"].numpy())
    assert jax.tree_util.tree_structure(mutated["batch_stats"]) == \
        jax.tree_util.tree_structure(variables["batch_stats"])
