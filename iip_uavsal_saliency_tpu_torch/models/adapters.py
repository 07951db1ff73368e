"""Zoo-model adapters (counterpart of
`iip_uavsal_saliency_tpu/models/adapters.py`): one stateful interface for
every model of the zoo.

The zoo mixes three call signatures: frames alone `f(x)`, frames and
priors `f(x, gauss, ob)`, and UAVSal's `f(x5, gauss, ob, state)`, which
UAVSal and UAVSalLSTM have natively. `ZooModelAdapter` gives the others
UAVSal's `forward(x5, gauss, ob, state) -> (out5, new_state)` and
`init_state(h, w, n, dtype=, device=)`, so the serving step, the runner,
the trainer and its train step take any zoo name. A model without a
recurrent state carries a (V, 8, 8, 1) zero state through unchanged (a
graph's static buffer keeps its shape).
"""

from __future__ import annotations

import inspect
from typing import Optional, Tuple

import torch
from torch import nn

from .uavsal import MODEL_ZOO, UAVSalMP, _Stateful, build_model

# the configuration a zoo model may carry, read through the adapter
_CONFIG = ("model_name", "cnn_type", "time_dims", "num_stblock", "bias_type", "st_type",
           "planes")


class ZooModelAdapter(nn.Module):
    """A zoo model without a recurrent state behind UAVSal's stateful
    interface.

    The adapter holds the model's parts as its own children, under their
    own names, so that its state_dict is the model's (the reference's keys,
    what `models/convert.py::table_of` lists), and moving, casting,
    `functional_call` and `train()` act on the model's parts; it calls the
    model's own forward. The model's configuration (`_CONFIG`, None where
    the class has none) reads through the adapter.

    V > 1 videos are flattened into one (V*S) frame batch, as in the JAX
    adapter, and bounded per video: the temporal differences per S frames
    (`diff_group=S`) and, for UAVSalMP, the context tiled frame-aligned
    (`compat_cxt_tile=False`), so that no stencil or context tile crosses
    videos. V = 1 keeps the reference's behaviour. V is the whole batch's,
    `videos` where given, as in `UAVSal`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        if isinstance(model, _Stateful):
            raise TypeError(f"{type(model).__name__} has the stateful interface already")
        self.__dict__["model"] = model  # not a child: its parts are (below)
        for child_name, child in model.named_children():
            self.add_module(child_name, child)
        self.takes_priors = isinstance(model, UAVSalMP)
        for key in _CONFIG:
            setattr(self, key, getattr(model, key, None))

    def train(self, mode: bool = True):
        self.model.training = mode
        return super().train(mode)

    def init_state(self, height: int, width: int, n_videos: int = 1, dtype=torch.float32,
                   device=None) -> torch.Tensor:
        """The (V, 8, 8, 1) dummy state of a model without one."""
        return torch.zeros(n_videos, 8, 8, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, gauss_prior: Optional[torch.Tensor],
                ob_prior: Optional[torch.Tensor], state: torch.Tensor,
                videos: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        v, s = x.shape[0], x.shape[1]
        flat = x.reshape(v * s, *x.shape[2:])
        several = (v if videos is None else videos) > 1
        bounds = {"diff_group": s} if several else {}
        if self.takes_priors:
            if several:
                bounds["compat_cxt_tile"] = False
            y = self.model(flat, gauss_prior, ob_prior, **bounds)
        else:
            y = self.model(flat, **bounds)
        if isinstance(y, tuple):  # UAVSalSTBlocks returns (out, features)
            y = y[0]
        return y.reshape(v, s, *y.shape[1:]), state


def build_adapted_model(name: str = "uavsal", filter_kwargs: bool = False, **kwargs):
    """The model for any zoo name: UAVSal or UAVSalLSTM itself (their
    interface is the native one), else the model behind a
    `ZooModelAdapter`. `filter_kwargs=True` drops the keywords the class
    does not take (the SpConv ablation has no time_dims, the stateless ones
    no bias_type), so that one configuration drives every name. An unknown
    name raises KeyError."""
    name = name.lower()
    if filter_kwargs:
        taken = inspect.signature(MODEL_ZOO[name]).parameters
        kwargs = {k: v for k, v in kwargs.items() if k in taken}
    model = build_model(name, **kwargs)
    return model if isinstance(model, _Stateful) else ZooModelAdapter(model)
