"""The weight bridge: the JAX package's variable tree -> this port's state_dict.

`from_jax_variables(variables)` takes `{"params", "batch_stats"}` as nested
numpy arrays (a `.ckpt` read by `training/checkpoint.py`, or JAX variables
passed through `np.asarray`) and returns a state_dict under the
reference's key names, the same keys and values, in the same order, that
the JAX package's `models/convert.py::export_uavsal_state_dict` produces.
It loads into `models.uavsal.UAVSal` with `load_state_dict(strict=True)`.
`to_jax_variables` reads the same table the other way.

This module keeps its own copy of that name map, `TABLE`:

  trunk/sfnet/features/features_{i}  -> sfnet.features.features.{i}
  trunk/sfnet/<lateral, aspp, last>  -> sfnet.<same>
  trunk/st_layer_{i}/*               -> st_layer.{i}.*
  trunk/fust_layer                   -> fust_layer.0
  mp/{gauss,ob}_cb_layer_{j}         -> {gauss,ob}_cb_layer.{j}
  mp/cxt_cb_prior_{j}                -> cxt_cb_prior.{j}
  mp/{fucb,fucbst}_layer             -> {fucb,fucbst}_layer.0
  rnn/kernel                         -> rnn.cell_list.0.rnn_conv.weight
  conv_out_st                        -> conv_out_st

Conv kernels go from HWIO to OIHW; BN scale/bias -> weight/bias and
mean/var -> running_mean/running_var.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .uavsal import NUM_STBLOCK

StateDict = Dict[str, torch.Tensor]
# (path in the JAX tree, starting at "params" or "batch_stats"; state_dict
# key; whether the leaf is a conv kernel, HWIO in JAX and OIHW here)
Row = Tuple[Tuple[str, ...], str, bool]


def _bn(path, key) -> List[Row]:
    return [(("params",) + path + ("scale",), key + ".weight", False),
            (("params",) + path + ("bias",), key + ".bias", False),
            (("batch_stats",) + path + ("mean",), key + ".running_mean", False),
            (("batch_stats",) + path + ("var",), key + ".running_var", False)]


def _conv_bn(path, conv_key, bn_key) -> List[Row]:
    """Rows of one `ConvBNAct` (`{conv: {kernel}, bn}`)."""
    return [(("params",) + path + ("conv", "kernel"), conv_key + ".weight", True)] + _bn(
        path + ("bn",), bn_key)


def _dwblock(path, prefix, expand=True) -> List[Row]:
    """Rows of one `DWBlock`; `expand` is False for expand_ratio 1."""
    rows = _conv_bn(path + ("expand",), f"{prefix}.conv.0.0", f"{prefix}.conv.0.1") if expand else []
    dw, proj, proj_bn = [f"{prefix}.conv.{i + expand}" for i in range(3)]
    rows += _conv_bn(path + ("dw",), dw + ".0", dw + ".1")
    rows.append((("params",) + path + ("project", "kernel"), proj + ".weight", True))
    return rows + _bn(path + ("project_bn",), proj_bn)


def _table() -> List[Row]:
    rows: List[Row] = []

    def conv_bn(*args):
        rows.extend(_conv_bn(*args))

    def dwblock(*args):
        rows.extend(_dwblock(*args))

    sf = ("trunk", "sfnet")
    conv_bn(sf + ("features", "features_0"),
            "sfnet.features.features.0.0", "sfnet.features.features.0.1")
    for i in range(1, 18):  # features.1 has expand_ratio 1
        dwblock(sf + ("features", f"features_{i}"), f"sfnet.features.features.{i}", i != 1)
    for name in ("conv_lv3", "conv_lv4", "lv5_aspp1", "conv_lv5", "conv_last"):
        conv_bn(sf + (name,), f"sfnet.{name}.0", f"sfnet.{name}.1")
    for name in ("lv5_aspp2", "lv5_aspp3", "lv5_aspp4"):
        dwblock(sf + (name,), f"sfnet.{name}")

    for i in range(NUM_STBLOCK):
        path, pre = ("trunk", f"st_layer_{i}"), f"st_layer.{i}"
        dwblock(path + ("stconv_sp", "spconv"), f"{pre}.stconv_sp.spconv")
        te, te_key = path + ("stconv_te",), f"{pre}.stconv_te"
        conv_bn(te + ("reduce_conv",), f"{te_key}.reduce_conv.0", f"{te_key}.reduce_conv.1")
        dwblock(te + ("sub_conv",), f"{te_key}.sub_conv")
        conv_bn(te + ("last_conv",), f"{te_key}.last_conv.0", f"{te_key}.last_conv.1")
        conv_bn(path + ("stconv_last",), f"{pre}.stconv_last.0", f"{pre}.stconv_last.1")
    dwblock(("trunk", "fust_layer"), "fust_layer.0")

    for name in ("gauss_cb_layer", "ob_cb_layer", "cxt_cb_prior"):
        for j in range(2):
            dwblock(("mp", f"{name}_{j}"), f"{name}.{j}")
    dwblock(("mp", "fucb_layer"), "fucb_layer.0")
    dwblock(("mp", "fucbst_layer"), "fucbst_layer.0")

    rows.append((("params", "rnn", "kernel"), "rnn.cell_list.0.rnn_conv.weight", True))
    dwblock(("conv_out_st",), "conv_out_st")
    return rows


TABLE: List[Row] = _table()


def from_jax_variables(variables: Mapping[str, Any], table: List[Row] = TABLE) -> StateDict:
    """JAX UAVSal variables -> this port's UAVSal state_dict (f32 tensors).
    `table` picks the rows; the default is the whole model."""
    out: StateDict = OrderedDict()
    for path, key, is_kernel in table:
        leaf = variables
        for p in path:
            leaf = leaf[p]
        a = np.asarray(leaf)
        out[key] = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if is_kernel else a,
                                             np.float32, order="C"))
    return out


def to_jax_variables(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference-named state_dict -> JAX `{"params", "batch_stats"}` tree of
    f32 numpy arrays; `from_jax_variables` inverts it."""
    tree: Dict[str, Any] = {}
    for path, key, is_kernel in TABLE:
        v = state_dict[key]
        a = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a.transpose(2, 3, 1, 0) if is_kernel else a
    return tree
