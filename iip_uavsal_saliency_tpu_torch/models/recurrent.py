"""ConvTWA, the temporal-weighted-average recurrence (counterpart of
`iip_uavsal_saliency_tpu/models/recurrent.py::ConvTWA`).

    i_t = sigmoid(conv([x_t, h_{t-1}], W))
    h_t = i_t * x_t + (1 - i_t) * h_{t-1}

The gate conv is linear, so it splits into conv(x, W[:, :Cin]) +
conv(h, W[:, Cin:]). The input half runs once over all V*S frames as one
`F.conv2d`; the scan over frames (`ops/twa.py::twa_scan`, kernel K1 on the
card) runs only the hidden half and the gate.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.twa import twa_scan


class _TWACell(nn.Module):
    """Holds the gate conv under the reference's key `rnn_conv`."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.rnn_conv = nn.Conv2d(2 * hidden_dim, hidden_dim, 3, padding=1, bias=False)


class ConvTWA(nn.Module):
    """x (V, S, H, W, C), state (V, H, W, C) -> (ys (V, S, H, W, C), h_last).

    The gate weight is split into its input half (OIHW, for the conv) and
    its hidden half permuted into the HWIO layout the kernel reads. For
    serving (no gradient wanted) the split is made once and again only when
    the weight changes; when a gradient is wanted it is made on the fly, so
    that it reaches `rnn_conv.weight` (on the card the scan's backward
    recomputes it through `twa_scan_ref`)."""

    def __init__(self, hidden_dim: int = 256):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([_TWACell(hidden_dim)])
        self._split: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._split_key = None
        # the scan to run; None is `ops/twa.py::twa_scan` (K1 on the card).
        # A check that holds K1's path against the plain one sets it to
        # `twa_scan_ref` on a model of its own
        self.scan: Optional[Callable] = None

    def init_state(self, height: int, width: int, n_videos: int = 1,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(n_videos, height, width, self.hidden_dim, dtype=dtype, device=device)

    def split_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W_x as OIHW in channels-last memory, W_h as contiguous HWIO)."""
        w = self.cell_list[0].rnn_conv.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return self._split_of(w)
        key = (w.data_ptr(), w.dtype, w.device, w._version)
        if self._split_key != key:
            self._split = self._split_of(w.detach())
            self._split_key = key
        return self._split

    def _split_of(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (w[:, :self.hidden_dim].contiguous(memory_format=torch.channels_last),
                w[:, self.hidden_dim:].permute(2, 3, 1, 0).contiguous())

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        v, s, h, w, c = x.shape
        w_x, w_h = self.split_weight()
        frames = x.reshape(v * s, h, w, c).permute(0, 3, 1, 2)
        gx = F.conv2d(frames, w_x, padding=1).permute(0, 2, 3, 1)
        gx = gx.contiguous().reshape(v, s, h, w, c)
        scan = twa_scan if self.scan is None else self.scan
        return scan(x.contiguous(), gx, w_h, state)
