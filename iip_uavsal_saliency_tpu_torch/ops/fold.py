"""Serving-time BatchNorm fold. Eval-mode BatchNorm is a frozen per-channel
affine, so it folds into the preceding conv:

    y = (conv(x) - mean) * scale / sqrt(var + eps) + bias
      = conv'(x) + bias',   conv' = conv * s,  bias' = bias - mean * s

- `fold_conv_bn(model)`: the fold the serving path uses, in place on the
  port's modules. Each conv gains a bias and its BatchNorm becomes an
  identity, so a step runs one pass per conv.
- `looks_folded(state_dict)`: whether weights carry that fold's signature.
- `fold_batchnorm(variables)`: own copy of the JAX package's
  `ops/fold.py::fold_batchnorm` on the numpy variable tree, for trees
  handed to other tools. Every Conv+BN pair (`{conv: {kernel}, bn: ...}` and a DWBlock's
`{project, project_bn}`) gets its HWIO kernel pre-scaled and its BN reduced
to an identity plus bias (mean 0, var 1, scale sqrt(1 + eps)). The tree
keeps its structure, so folded and unfolded variables load into the same
model. Do not train on folded variables.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .layers import BN_EPS, BatchNorm


def _fold_pair(kernel, bn_p, bn_s, eps: float):
    kernel = np.asarray(kernel, np.float32)
    scale = np.asarray(bn_p["scale"], np.float32)
    bias = np.asarray(bn_p["bias"], np.float32)
    mean = np.asarray(bn_s["mean"], np.float32)
    var = np.asarray(bn_s["var"], np.float32)
    s = scale / np.sqrt(var + eps)
    bias2 = bias - mean * s
    c = bias2.shape[0]
    ident_p = {
        "scale": np.full((c,), np.sqrt(np.float32(1.0) + np.float32(eps)), np.float32),
        "bias": bias2.astype(np.float32),
    }
    ident_s = {"mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}
    return (kernel * s).astype(np.float32), ident_p, ident_s


def _has_pair(p_node, s_node, conv: str, bn: str) -> bool:
    return (
        isinstance(p_node.get(conv), dict)
        and "kernel" in p_node[conv]
        and (conv != "conv" or "bias" not in p_node[conv])
        and isinstance(p_node.get(bn), dict)
        and isinstance(s_node, dict)
        and isinstance(s_node.get(bn), dict)
    )


def _walk(p_node, s_node, eps: float) -> Tuple[Any, Any]:
    if not isinstance(p_node, dict):
        return p_node, s_node
    p_out: Dict[str, Any] = dict(p_node)
    s_out: Dict[str, Any] = dict(s_node) if isinstance(s_node, dict) else {}
    handled = set()
    for conv, bn in (("conv", "bn"), ("project", "project_bn")):
        if _has_pair(p_node, s_node, conv, bn):
            k2, bn_p, bn_s = _fold_pair(p_node[conv]["kernel"], p_node[bn], s_node[bn], eps)
            p_out[conv] = {**p_node[conv], "kernel": k2}
            p_out[bn], s_out[bn] = bn_p, bn_s
            handled |= {conv, bn}
    for k, v in p_node.items():
        if k in handled or not isinstance(v, dict):
            continue
        sp, ss = _walk(v, s_node.get(k, {}) if isinstance(s_node, dict) else {}, eps)
        p_out[k] = sp
        if isinstance(s_node, dict) and k in s_node:
            s_out[k] = ss
    return p_out, s_out


def fold_batchnorm(variables: Dict[str, Any], eps: float = BN_EPS) -> Dict[str, Any]:
    """`variables` ({'params', 'batch_stats'}) with every Conv+BN pair folded."""
    p2, s2 = _walk(variables.get("params", {}), variables.get("batch_stats", {}), float(eps))
    return {**variables, "params": p2, "batch_stats": s2}


def looks_folded(state_dict, eps: float = BN_EPS) -> bool:
    """Whether a state_dict carries `fold_batchnorm`'s signature: some
    BatchNorm whose weight is sqrt(1 + eps) on every channel (a fresh init
    has 1.0) with running stats exactly mean 0, var 1. Training on such
    weights would count the absorbed BN scale twice."""
    marker = np.sqrt(np.float32(1.0) + np.float32(eps))
    for key, mean in state_dict.items():
        if key.endswith(".running_mean"):
            bn = key[:-len("running_mean")]
            if (torch.all(state_dict[bn + "weight"] == torch.tensor(marker))
                    and torch.all(mean == 0) and torch.all(state_dict[bn + "running_var"] == 1)):
                return True
    return False


@torch.no_grad()
def fold_conv_bn(model: nn.Module) -> None:
    """Fold every BatchNorm that follows a Conv2d in an nn.Sequential into
    that conv, in place: W' = W * s, bias' = b (+ W's old bias * s)."""
    for seq in model.modules():
        if not isinstance(seq, nn.Sequential):
            continue
        for i in range(len(seq) - 1):
            conv, bn = seq[i], seq[i + 1]
            if not (isinstance(conv, nn.Conv2d) and isinstance(bn, BatchNorm)):
                continue
            s, b = bn.affine()
            w = conv.weight.to(s.dtype)
            bias = b if conv.bias is None else b + conv.bias.to(s.dtype) * s
            conv.weight.copy_((w * s.view(-1, 1, 1, 1)).to(conv.weight.dtype))
            conv.bias = nn.Parameter(bias.to(conv.weight.dtype), requires_grad=False)
            seq[i + 1] = nn.Identity()
