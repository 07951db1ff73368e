"""The optimizer: Adam with L2 weight decay, and frozen subtrees (counterpart
of `iip_uavsal_saliency_tpu/training/optim.py`).

The JAX package chains `add_decayed_weights` -> `scale_by_adam` ->
`scale(-lr)`: the decay is added to the gradient before the moments, which
is `torch.optim.Adam(weight_decay=wd)` (not AdamW). A frozen parameter takes
no update and holds no moments there (optax `set_to_zero` under
`multi_transform`); here it stays out of the optimizer and out of autograd,
which gives the same parameters without computing its gradient. Its
BatchNorm running stats still move in train mode, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.convert import TABLE
from ..utils.logging import get_logger

log = get_logger("train")


def jax_param_paths() -> Dict[str, str]:
    """Port parameter name -> its '/'-joined path under the JAX tree's
    `params` (e.g. 'trunk/sfnet/features/features_0/conv/kernel'), from the
    weight bridge's table."""
    return {key: "/".join(path[1:]) for path, key, _ in TABLE if path[0] == "params"}


def make_frozen_mask(model: nn.Module, frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trainable}. A parameter is frozen when its JAX path
    starts with any of the prefixes, as the JAX package reads them, e.g.
    ('trunk/sfnet', 'trunk/st_layer'). A prefix that matches nothing is
    almost always a naming mistake and is warned about."""
    paths = jax_param_paths()
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


def optimizer_tree(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, Dict]:
    """The optimizer's per-parameter state as {parameter name: {key: numpy
    array}} (Adam: `step`, `exp_avg`, `exp_avg_sq`), the port's own layout
    in an epoch checkpoint."""
    names = {p: n for n, p in model.named_parameters()}
    return {names[p]: {k: v.detach().cpu().numpy() for k, v in st.items()}
            for p, st in optimizer.state.items()}


def load_optimizer_tree(model: nn.Module, optimizer: torch.optim.Optimizer,
                        tree: Dict[str, Dict]) -> None:
    """Put the state `optimizer_tree` made back into `optimizer`, each
    entry on its parameter's device (Adam's `step` stays an f32 scalar on
    the CPU, as torch keeps it)."""
    params = dict(model.named_parameters())
    for name, st in tree.items():
        p = params[name]
        optimizer.state[p] = {
            k: torch.tensor(np.asarray(v), dtype=torch.float32) if k == "step"
            else torch.tensor(np.asarray(v)).to(p.device, p.dtype) for k, v in st.items()}
