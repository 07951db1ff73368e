"""The weight bridge: the JAX package's variable tree -> this port's state_dict.

`from_jax_variables(variables, table)` takes `{"params", "batch_stats"}` as
nested numpy arrays (a `.ckpt` read by `training/checkpoint.py`, or JAX
variables passed through `np.asarray`) and returns a state_dict under the
reference's key names. For the flagship these are the same keys and values,
in the same order, that the JAX package's
`models/convert.py::export_uavsal_state_dict` produces. It loads into the
`models.uavsal.UAVSal` of the same configuration with
`load_state_dict(strict=True)`. `to_jax_variables` reads the same table the
other way.

This module keeps its own copy of that name map, built per configuration
by `table_for(cnn_type, num_stblock, bias_type)` (`table_of(model)` for a
model, `TABLE` for the flagship):

  trunk/sfnet/features/features_{i}  -> sfnet.features.features.{i}  (MobileNetV2)
  trunk/sfnet/features/stem          -> sfnet.features.conv1, .bn1   (ResNet)
  .../features/layer{L}_{b}/conv{k}  -> sfnet.features.layer{L}.{b}.conv{k}, .bn{k}
  .../features/layer{L}_{b}/downsample -> ...layer{L}.{b}.downsample.{0,1}
  trunk/sfnet/features/conv{s}_{b}   -> sfnet.features.features.{idx} (VGG16,
                                        torchvision's indices; a bias, no BN)
  trunk/sfnet/<lateral, aspp, last>  -> sfnet.<same>
  trunk/st_layer_{i}/*               -> st_layer.{i}.*
  trunk/fust_layer                   -> fust_layer.0
  mp/{gauss,ob}_cb_layer_{j}         -> {gauss,ob}_cb_layer.{j}   (stream on)
  mp/cxt_cb_prior_{j}                -> cxt_cb_prior.{j}          (stream on)
  mp/{fucb,fucbst}_layer             -> {fucb,fucbst}_layer.0     (any stream on)
  rnn/kernel                         -> rnn.cell_list.0.rnn_conv.weight
  conv_out_st                        -> conv_out_st

Conv kernels go from HWIO to OIHW; BN scale/bias -> weight/bias and
mean/var -> running_mean/running_var. `s2d_stem` changes no key.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.layers import ConvBNAct, DWBlock
from .backbone import BasicBlock, Bottleneck, ResNetPyramid, build_backbone
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


def _backbone(cnn_type: str) -> List[Row]:
    """Rows of the pyramid under trunk/sfnet/features <-> sfnet.features,
    read off the module that `models/backbone.py::build_backbone` builds
    (on the meta device: no memory, no draws), so that the layout is
    written down once."""
    with torch.device("meta"):
        net = build_backbone(cnn_type)
    path, pre = ("trunk", "sfnet", "features"), "sfnet.features"
    rows: List[Row] = []
    if isinstance(net, ResNetPyramid):
        for conv, bn in net.conv_bn_pairs:
            rows += _conv_bn(path + ("stem",), f"{pre}.{conv}", f"{pre}.{bn}")
        for name, block in net.named_modules():
            if not isinstance(block, (BasicBlock, Bottleneck)):
                continue
            layer, b = name.split(".")
            bpath, bkey = path + (f"{layer}_{b}",), f"{pre}.{name}"
            for conv, bn in block.conv_bn_pairs:
                rows += _conv_bn(bpath + (conv,), f"{bkey}.{conv}", f"{bkey}.{bn}")
            if block.downsample is not None:
                rows += _conv_bn(bpath + ("downsample",), f"{bkey}.downsample.0",
                                 f"{bkey}.downsample.1")
        return rows
    stage, conv = 1, 1
    for i, layer in enumerate(net.features):
        key = f"{pre}.features.{i}"
        if isinstance(layer, DWBlock):
            rows += _dwblock(path + (f"features_{i}",), key, len(layer.conv) == 4)
        elif isinstance(layer, ConvBNAct):
            rows += _conv_bn(path + (f"features_{i}",), key + ".0", key + ".1")
        elif isinstance(layer, nn.Conv2d):  # VGG16: a bias, no BatchNorm
            cpath = ("params",) + path + (f"conv{stage}_{conv}",)
            rows += [(cpath + ("kernel",), key + ".weight", True),
                     (cpath + ("bias",), key + ".bias", False)]
            conv += 1
        elif isinstance(layer, nn.MaxPool2d):
            stage, conv = stage + 1, 1
    return rows


@functools.lru_cache(maxsize=None)
def _table(cnn_type: str, num_stblock: int, bias_type: Tuple[int, int, int]) -> Tuple[Row, ...]:
    rows: List[Row] = _backbone(cnn_type)

    def conv_bn(*args):
        rows.extend(_conv_bn(*args))

    def dwblock(*args):
        rows.extend(_dwblock(*args))

    sf = ("trunk", "sfnet")
    for name in ("conv_lv3", "conv_lv4", "lv5_aspp1", "conv_lv5", "conv_last"):
        conv_bn(sf + (name,), f"sfnet.{name}.0", f"sfnet.{name}.1")
    for name in ("lv5_aspp2", "lv5_aspp3", "lv5_aspp4"):
        dwblock(sf + (name,), f"sfnet.{name}")

    for i in range(num_stblock):
        path, pre = ("trunk", f"st_layer_{i}"), f"st_layer.{i}"
        dwblock(path + ("stconv_sp", "spconv"), f"{pre}.stconv_sp.spconv")
        te, te_key = path + ("stconv_te",), f"{pre}.stconv_te"
        conv_bn(te + ("reduce_conv",), f"{te_key}.reduce_conv.0", f"{te_key}.reduce_conv.1")
        dwblock(te + ("sub_conv",), f"{te_key}.sub_conv")
        conv_bn(te + ("last_conv",), f"{te_key}.last_conv.0", f"{te_key}.last_conv.1")
        conv_bn(path + ("stconv_last",), f"{pre}.stconv_last.0", f"{pre}.stconv_last.1")
    dwblock(("trunk", "fust_layer"), "fust_layer.0")

    for name, on in zip(("gauss_cb_layer", "ob_cb_layer", "cxt_cb_prior"), bias_type):
        for j in range(2 if on else 0):
            dwblock(("mp", f"{name}_{j}"), f"{name}.{j}")
    if any(bias_type):
        dwblock(("mp", "fucb_layer"), "fucb_layer.0")
        dwblock(("mp", "fucbst_layer"), "fucbst_layer.0")

    rows.append((("params", "rnn", "kernel"), "rnn.cell_list.0.rnn_conv.weight", True))
    dwblock(("conv_out_st",), "conv_out_st")
    return tuple(rows)


def table_for(cnn_type: str = "mobilenet_v2", num_stblock: int = NUM_STBLOCK,
              bias_type: Sequence[int] = (1, 1, 1)) -> List[Row]:
    """The rows of the UAVSal of this configuration, in the order of the
    JAX package's `export_uavsal_state_dict` (backbone, neck, STBlocks,
    fuse block, prior streams, fusion, TWA gate, head)."""
    return list(_table(cnn_type.lower(), int(num_stblock),
                       tuple(int(bool(b)) for b in bias_type)))


def table_of(model) -> List[Row]:
    """The rows of `model`'s own configuration (a `models.uavsal.UAVSal`)."""
    return table_for(model.cnn_type, model.num_stblock, model.bias_type)


TABLE: List[Row] = table_for()


def _leaf_paths(tree: Any, prefix: Tuple[str, ...]) -> Iterator[Tuple[str, ...]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def _check_same(what: str, have, table_has) -> None:
    """Raise unless the leaves found and the table's rows are one set: a
    table of another configuration would otherwise drop or miss a part."""
    extra, missing = sorted(set(have) - set(table_has)), sorted(set(table_has) - set(have))
    if extra or missing:
        raise ValueError(f"{what} is not the table's configuration: {len(extra)} entries "
                         f"beyond the table (first {extra[:3]}), {len(missing)} missing "
                         f"(first {missing[:3]})")


def from_jax_variables(variables: Mapping[str, Any], table: List[Row] = TABLE) -> StateDict:
    """JAX UAVSal variables -> this port's UAVSal state_dict (f32 tensors).
    `table` is the model's own (`table_of`; the flagship's by default) or
    the rows of a part; the leaves under its collections ("params",
    "batch_stats") must be its rows exactly. Other top-level entries (a
    checkpoint's optimizer state, its step) are not read."""
    collections = {path[0] for path, _, _ in table}
    _check_same("the JAX variable tree",
                [p for c in collections for p in _leaf_paths(variables.get(c, {}), (c,))],
                [path for path, _, _ in table])
    out: StateDict = OrderedDict()
    for path, key, is_kernel in table:
        leaf = variables
        for p in path:
            leaf = leaf[p]
        a = np.asarray(leaf)
        out[key] = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if is_kernel else a,
                                             np.float32, order="C"))
    return out


def to_jax_variables(state_dict: Mapping[str, Any], table: List[Row] = TABLE) -> Dict[str, Any]:
    """Reference-named state_dict -> JAX `{"params", "batch_stats"}` tree of
    f32 numpy arrays; the state_dict's keys must be the rows of `table` (the
    model's own, the flagship's by default). `from_jax_variables` with the
    same table inverts it."""
    _check_same("the state_dict", list(state_dict), [key for _, key, _ in table])
    tree: Dict[str, Any] = {}
    for path, key, is_kernel in table:
        v = state_dict[key]
        a = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a.transpose(2, 3, 1, 0) if is_kernel else a
    return tree
