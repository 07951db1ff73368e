"""The weight bridge: the JAX package's variable tree -> this port's state_dict.

`from_jax_variables(variables, table)` takes `{"params", "batch_stats"}` as
nested numpy arrays (a `.ckpt` read by `training/checkpoint.py`, or JAX
variables passed through `np.asarray`) and returns a state_dict under the
reference's key names. For the flagship these are the same keys and values,
in the same order, that the JAX package's
`models/convert.py::export_uavsal_state_dict` produces; for the other zoo
models the keys that the JAX `convert_zoo_state_dict` reads, so that
`to_jax_variables` is the zoo exporter that the JAX package lacks. It loads
into the model of the same name and configuration (`models/uavsal.py`,
or its `ZooModelAdapter`) with `load_state_dict(strict=True)`.
`to_jax_variables` reads the same table the other way.

This module keeps its own copy of that name map, built per model and
configuration by `table_for(cnn_type, num_stblock, bias_type, model_name)`
(`table_of(model)` for a model, `TABLE` for the flagship):

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
                                        (ConvTWA; ConvLSTM's i, f, o, g gates)
  conv_out_st                        -> conv_out_st

The zoo's other names: `uavsal_spconv` and `uavsal_teconv` have no `trunk`
(sfnet/..., st_layer_{i} -> st_layer.{i}, the DWBlock or the temporal
branch itself, fust_layer -> fust_layer.0); the rest have the trunk, with
the ST blocks of their kind (STC3D: `stconv_te`, a 3-D ConvBNAct; STC23D:
`stconv_sp`, `stconv_te`, `stconv_last`; every ordering of
`uavsal_stblocks_type` has STBlock's names, so `st_type` changes no row),
`mp/...` for `uavsal_mp` and `uavsal_lstm`, and `rnn/kernel` for
`uavsal_lstm`. The image stage (`srfnet_image`, `models/srfnet_image.py`)
has `sfnet/...` and `conv_out -> conv_out`.

Conv kernels go from HWIO to OIHW (DHWIO to OIDHW in 3-D); BN scale/bias
-> weight/bias and mean/var -> running_mean/running_var. `s2d_stem` and
`planes` change no key (the leaves' shapes follow the arrays).
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
from .srfnet_image import IMAGE_MODEL_NAME
from .uavsal import NUM_STBLOCK

StateDict = Dict[str, torch.Tensor]
# (path in the JAX tree, starting at "params" or "batch_stats"; state_dict
# key; whether the leaf is a conv kernel, HWIO (DHWIO) in JAX and OIHW
# (OIDHW) here)
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


def _teconv(path, pre) -> List[Row]:
    """Rows of one `TeConvSub`."""
    return (_conv_bn(path + ("reduce_conv",), f"{pre}.reduce_conv.0", f"{pre}.reduce_conv.1")
            + _dwblock(path + ("sub_conv",), f"{pre}.sub_conv")
            + _conv_bn(path + ("last_conv",), f"{pre}.last_conv.0", f"{pre}.last_conv.1"))


def _st_block(path, pre, kind: str) -> List[Row]:
    """Rows of one ST block: "st" (any ordering of `ST_TYPES`: they share
    their names), "stc3d" or "stc2_3d"."""
    if kind == "stc3d":
        return _conv_bn(path + ("stconv_te",), f"{pre}.stconv_te.0", f"{pre}.stconv_te.1")
    last = _conv_bn(path + ("stconv_last",), f"{pre}.stconv_last.0", f"{pre}.stconv_last.1")
    if kind == "stc2_3d":
        return (_conv_bn(path + ("stconv_sp",), f"{pre}.stconv_sp.0", f"{pre}.stconv_sp.1")
                + _conv_bn(path + ("stconv_te",), f"{pre}.stconv_te.0", f"{pre}.stconv_te.1")
                + last)
    return (_dwblock(path + ("stconv_sp", "spconv"), f"{pre}.stconv_sp.spconv")
            + _teconv(path + ("stconv_te",), f"{pre}.stconv_te") + last)


# the ST block of each zoo name with a trunk
_ST_KIND = {"uavsal": "st", "uavsal_stblocks": "st", "uavsal_stblocks_type": "st",
            "uavsal_stc3d": "stc3d", "uavsal_stc2_3d": "stc2_3d", "uavsal_mp": "st",
            "uavsal_lstm": "st"}


@functools.lru_cache(maxsize=None)
def _table(cnn_type: str, num_stblock: int, bias_type: Tuple[int, int, int],
           model_name: str) -> Tuple[Row, ...]:
    image = model_name == IMAGE_MODEL_NAME
    flat = image or model_name in ("uavsal_spconv", "uavsal_teconv")
    root = () if flat else ("trunk",)
    # the backbone's rows drop "trunk" from their paths where there is none
    rows: List[Row] = [(path[:1] + path[2:] if flat else path, key, is_kernel)
                       for path, key, is_kernel in _backbone(cnn_type)]

    def conv_bn(*args):
        rows.extend(_conv_bn(*args))

    def dwblock(*args):
        rows.extend(_dwblock(*args))

    sf = root + ("sfnet",)
    for name in ("conv_lv3", "conv_lv4", "lv5_aspp1", "conv_lv5", "conv_last"):
        conv_bn(sf + (name,), f"sfnet.{name}.0", f"sfnet.{name}.1")
    for name in ("lv5_aspp2", "lv5_aspp3", "lv5_aspp4"):
        dwblock(sf + (name,), f"sfnet.{name}")
    if image:
        dwblock(("conv_out",), "conv_out")
        return tuple(rows)

    for i in range(num_stblock):
        path, pre = root + (f"st_layer_{i}",), f"st_layer.{i}"
        if model_name == "uavsal_spconv":
            dwblock(path, pre)
        elif model_name == "uavsal_teconv":
            rows.extend(_teconv(path, pre))
        else:
            rows.extend(_st_block(path, pre, _ST_KIND[model_name]))
    dwblock(root + ("fust_layer",), "fust_layer.0")

    if model_name in ("uavsal", "uavsal_mp", "uavsal_lstm"):
        for name, on in zip(("gauss_cb_layer", "ob_cb_layer", "cxt_cb_prior"), bias_type):
            for j in range(2 if on else 0):
                dwblock(("mp", f"{name}_{j}"), f"{name}.{j}")
        if any(bias_type):
            dwblock(("mp", "fucb_layer"), "fucb_layer.0")
            dwblock(("mp", "fucbst_layer"), "fucbst_layer.0")
    if model_name in ("uavsal", "uavsal_lstm"):
        rows.append((("params", "rnn", "kernel"), "rnn.cell_list.0.rnn_conv.weight", True))
    dwblock(("conv_out_st",), "conv_out_st")
    return tuple(rows)


def table_for(cnn_type: str = "mobilenet_v2", num_stblock: int = NUM_STBLOCK,
              bias_type: Sequence[int] = (1, 1, 1), model_name: str = "uavsal") -> List[Row]:
    """The rows of the zoo model `model_name` of this configuration (for
    "uavsal" in the order of the JAX package's `export_uavsal_state_dict`:
    backbone, neck, ST blocks, fuse block, prior streams, fusion, TWA gate,
    head; the other names in the same order, without the parts they lack),
    or of the image stage for "srfnet_image" (backbone, neck, `conv_out`).
    `bias_type` matters only where the model has priors. An unknown name
    raises KeyError."""
    model_name = model_name.lower()
    if model_name not in _ST_KIND and model_name not in ("uavsal_spconv", "uavsal_teconv",
                                                         IMAGE_MODEL_NAME):
        raise KeyError(model_name)
    return list(_table(cnn_type.lower(), int(num_stblock),
                       tuple(int(bool(b)) for b in bias_type), model_name))


def table_of(model) -> List[Row]:
    """The rows of `model`'s own name and configuration (a model of
    `models/uavsal.py`, its `ZooModelAdapter`, or `SRFNetImage`)."""
    return table_for(model.cnn_type, model.num_stblock,
                     getattr(model, "bias_type", None) or (0, 0, 0), model.model_name)


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


def leaf_from_jax(leaf, is_kernel: bool) -> np.ndarray:
    """One JAX leaf in the port's layout, f32 C-order: a conv kernel
    (..., I, O) goes to (O, I, ...)."""
    a = np.asarray(leaf)
    if is_kernel:
        a = a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
    return np.array(a, np.float32, order="C")


def leaf_to_jax(a: np.ndarray, is_kernel: bool) -> np.ndarray:
    """The inverse of `leaf_from_jax` (a view where it transposes)."""
    return a.transpose(*range(2, a.ndim), 1, 0) if is_kernel else a


def from_jax_variables(variables: Mapping[str, Any], table: List[Row] = TABLE) -> StateDict:
    """JAX variables of a zoo model -> this port's state_dict (f32 tensors).
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
        out[key] = torch.from_numpy(leaf_from_jax(leaf, is_kernel))
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
        node[path[-1]] = leaf_to_jax(a, is_kernel)
    return tree


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A `.pth` file's state_dict as numpy arrays (the port's copy of the JAX
    package's `models/convert.py::load_torch_checkpoint`): a pickled module
    (the reference's released `UAVSal_*.pth`) gives its `.state_dict()`, a
    raw state_dict is taken as it is. It unpickles: load only files you
    trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def reference_state_dict(state_dict: Mapping[str, Any], table: List[Row] = TABLE) -> Dict[str, Any]:
    """The entries of a reference state_dict that `table`'s model has, in
    its order. Others are left out, as the JAX converter reads only what it
    needs: a released checkpoint also holds BatchNorm's
    `num_batches_tracked` and torchvision's unused last MobileNetV2 conv
    (`sfnet.features.features.18.*`), which the model has not. A key of the
    table that the state_dict lacks raises KeyError naming it."""
    missing = next((key for _, key, _ in table if key not in state_dict), None)
    if missing is not None:
        raise KeyError(f"the checkpoint has no {missing!r}, which this model configuration "
                       "needs (check --model_name, --cnn_type, --num_stblock, --bias_type)")
    return OrderedDict((key, state_dict[key]) for _, key, _ in table)
