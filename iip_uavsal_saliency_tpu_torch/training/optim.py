"""The optimizer: Adam with L2 weight decay, and frozen subtrees (counterpart
of `iip_uavsal_saliency_tpu/training/optim.py`).

The JAX package chains `add_decayed_weights` -> `scale_by_adam` ->
`scale(-lr)`: the decay is added to the gradient before the moments, which
is `torch.optim.Adam(weight_decay=wd)` (not AdamW). A frozen parameter takes
no update and holds no moments there (optax `set_to_zero` under
`multi_transform`); here it stays out of the optimizer and out of autograd,
which gives the same parameters without computing its gradient. Its
BatchNorm running stats still move in train mode, as in the JAX package.

An epoch checkpoint holds Adam's state in optax's layout (`optax_tree`), so
that either package resumes a run the other began; `load_optimizer_state`
reads it, and the port's own layout of earlier versions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.convert import TABLE, Row, leaf_from_jax, leaf_to_jax, table_of
from ..utils.logging import get_logger

log = get_logger("train")


def jax_param_paths(table: List[Row] = TABLE) -> Dict[str, str]:
    """Port parameter name -> its '/'-joined path under the JAX tree's
    `params` (e.g. 'trunk/sfnet/features/features_0/conv/kernel'), from the
    weight bridge's table (the flagship's by default)."""
    return {key: "/".join(path[1:]) for path, key, _ in table if path[0] == "params"}


def make_frozen_mask(model: nn.Module, frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trainable}. A parameter is frozen when its JAX path
    starts with any of the prefixes, as the JAX package reads them, e.g.
    ('trunk/sfnet', 'trunk/st_layer'), over the model's own table. A
    prefix that matches nothing is almost always a naming mistake and is
    warned about."""
    paths = jax_param_paths(table_of(model))
    names = [name for name, _ in model.named_parameters()]
    missing = [n for n in names if n not in paths]
    if missing:
        raise KeyError(f"parameters without a JAX path in the weight bridge: {missing[:4]}")
    for p in frozen_prefixes:
        if not any(paths[n].startswith(p) for n in names):
            log.warning("freeze prefix %r matches no parameter; nothing frozen by it "
                        "(param roots: %s)", p, sorted({paths[n].split("/")[0] for n in names}))
    return {n: not any(paths[n].startswith(p) for p in frozen_prefixes) for n in names}


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4, weight_decay: float = 5e-5,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   trainable_mask: Optional[Dict[str, bool]] = None) -> torch.optim.Adam:
    """Adam over the trainable parameters of `model`; the frozen ones (False
    in `trainable_mask`) get `requires_grad=False`."""
    params = []
    for name, p in model.named_parameters():
        trainable = trainable_mask is None or trainable_mask[name]
        p.requires_grad_(trainable)
        if trainable:
            params.append(p)
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def _sorted(tree):
    """A tree of dicts with its keys in sorted order at every level, as a
    JAX pytree that went through `jit` holds them."""
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def _param_rows(table: List[Row]):
    return [(path[1:], key, is_kernel) for path, key, is_kernel in table if path[0] == "params"]


def _trainable(optimizer: torch.optim.Optimizer):
    return {p for group in optimizer.param_groups for p in group["params"]}


def optax_tree(model: nn.Module, optimizer: torch.optim.Adam, table: List[Row],
               masked: bool) -> Dict:
    """Adam's state in the layout of the JAX package's epoch checkpoint:
    `flax.serialization.to_state_dict` of the optax chain its
    `make_optimizer` builds, `{"0": {}, "1": {"count", "mu", "nu"}, "2": {}}`
    (the decay or identity, `scale_by_adam`, `scale`: their states are
    empty), under `{"inner_states": {"frozen": {"inner_state": {}},
    "train": {"inner_state": ...}}}` when the run has a freeze list
    (`masked`; optax's `multi_transform`, whatever the mask holds).

    `mu` and `nu` mirror the `params` tree of `table` (keys sorted, as the
    JAX state holds them), f32, conv kernels in HWIO through the weight
    bridge's transposes; a frozen parameter is an empty map (optax's
    `MaskedNode`), a trainable one without Adam state yet zeros. `count`
    is an int32 scalar: torch's per-parameter `step`, which is one count
    for all since every parameter takes a gradient each step."""
    params = dict(model.named_parameters())
    trainable = _trainable(optimizer)
    count = max((int(st["step"]) for st in optimizer.state.values() if "step" in st), default=0)

    def moments(key):
        tree: Dict = {}
        for path, name, is_kernel in _param_rows(table):
            p = params[name]
            if p not in trainable:
                leaf = {}
            elif key in optimizer.state.get(p, {}):
                leaf = leaf_to_jax(optimizer.state[p][key].detach().float().cpu().numpy(),
                                   is_kernel)
            else:
                leaf = leaf_to_jax(np.zeros(tuple(p.shape), np.float32), is_kernel)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return _sorted(tree)

    chain = {"0": {}, "1": {"count": np.asarray(count, np.int32), "mu": moments("exp_avg"),
                            "nu": moments("exp_avg_sq")}, "2": {}}
    if not masked:
        return chain
    return {"inner_states": {"frozen": {"inner_state": {}}, "train": {"inner_state": chain}}}


def load_optimizer_state(model: nn.Module, optimizer: torch.optim.Adam, tree: Dict,
                         table: List[Row], masked: bool) -> None:
    """Put an epoch checkpoint's `opt_state` into `optimizer`: optax's
    layout (`optax_tree`, which the JAX package writes too), or the port's
    own of earlier versions, {parameter name: {step, exp_avg, exp_avg_sq}}.
    Each moment goes to its parameter's device and dtype; torch's `step`
    is an f32 scalar on the CPU, as torch keeps it. A checkpoint whose
    freeze setting differs from the run's (`masked`) is refused, as the
    JAX trainer refuses it."""
    params = dict(model.named_parameters())
    if set(tree) <= set(params):  # the port's own layout
        for name, st in tree.items():
            p = params[name]
            optimizer.state[p] = {
                k: torch.tensor(np.asarray(v), dtype=torch.float32) if k == "step"
                else torch.tensor(np.asarray(v)).to(p.device, p.dtype) for k, v in st.items()}
        return
    if ("inner_states" in tree) != masked:
        raise ValueError(f"the checkpoint's optimizer state was written "
                         f"{'with' if 'inner_states' in tree else 'without'} a freeze list, "
                         f"this run has {'one' if masked else 'none'}")
    adam = (tree["inner_states"]["train"]["inner_state"] if masked else tree)["1"]
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    trainable = _trainable(optimizer)
    for path, name, is_kernel in _param_rows(table):
        p = params[name]
        mu, nu = adam["mu"], adam["nu"]
        for k in path:
            mu, nu = mu[k], nu[k]
        if p not in trainable:
            continue
        if isinstance(mu, dict):
            raise ValueError(f"{name} is trained in this run but frozen in the checkpoint")
        optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": torch.from_numpy(leaf_from_jax(mu, is_kernel)).to(p.device, p.dtype),
            "exp_avg_sq": torch.from_numpy(leaf_from_jax(nu, is_kernel)).to(p.device, p.dtype)}
