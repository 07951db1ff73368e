"""The stateful recurrences (counterparts of
`iip_uavsal_saliency_tpu/models/recurrent.py`): ConvTWA, the
temporal-weighted-average cell of the flagship, and the ablations'
ConvLSTM, ConvSimGRU and ConvTWADW (below).

    i_t = sigmoid(conv([x_t, h_{t-1}], W))
    h_t = i_t * x_t + (1 - i_t) * h_{t-1}

The gate conv is linear, so it splits into conv(x, W[:, :Cin]) +
conv(h, W[:, Cin:]). The input half runs once over all V*S frames as one
`F.conv2d`; the scan over frames (`ops/twa.py::twa_scan`, kernel K1 on the
card) runs only the hidden half and the gate. Where the scan runs a
per-frame kernel (f32, and bf16 at shapes the persistent kernel refuses) the
hidden half is also packed for it (`ops/twa.py::pack_twa_weights`,
`pack_twa_weights_bf16`), once for serving.

On a spatial mesh (`parallel.spatial.over`) ConvTWA takes this rank's band
of rows: the input half's conv fetches a row of x each side once per clip,
and the scan runs a frame at a time, since each frame's gate reads a row of
h_{s-1} each side from the neighbours' bands: K1 (through `twa_scan`, which
picks its kernel) runs on the band with those rows (zeros beyond the image,
the gate conv's own padding) and with zero rows of x and gx there, whose
outputs are dropped.

On a seq mesh (`parallel.seq.over`) ConvTWA takes this rank's run of each
clip's frames: the input half's conv runs on them, then the rank waits for
h from the rank before (the carried state on the first rank), runs the scan
once over its frames (`twa_scan`: K1's persistent kernel once, or its
per-frame kernel once a frame, from that h) and hands its last h on
(`parallel.seq.hand_state`); the clip's new state is the last rank's.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import DWBlock, laid_out_as
from ..ops.twa import kernel_route, pack_twa_weights, pack_twa_weights_bf16, twa_scan
from ..parallel import seq as seq_axis
from ..parallel import spatial


class _GateCell(nn.Module):
    """Holds a gate conv over concat([x, h]) (`hidden_dim` channels each)
    with `gates` * hidden_dim outputs under the reference's key
    `rnn_conv`."""

    def __init__(self, hidden_dim: int, gates: int = 1):
        super().__init__()
        self.rnn_conv = nn.Conv2d(2 * hidden_dim, gates * hidden_dim, 3, padding=1, bias=False)


def _packs(w: torch.Tensor) -> bool:
    """Whether the scan may read this weight's hidden half packed: the
    per-frame kernels on the card do (f32 and bf16); the CPU reads W_h as it
    is. Whether a scan takes the per-frame route is x's to say
    (`ConvTWA.forward`)."""
    return w.device.type == "cuda" and w.dtype in (torch.float32, torch.bfloat16)


class ConvTWA(nn.Module):
    """x (V, S, H, W, C), state (V, H, W, C) -> (ys (V, S, H, W, C), h_last).

    The gate weight is split into its input half (OIHW, for the conv) and
    its hidden half permuted into the HWIO layout the kernel reads (and,
    where x goes to a per-frame kernel, packed: `packed_weight`). For
    serving (no gradient wanted) the split and the pack are made once and
    again only when the weight changes (in place, by a load or by a cast):
    a served graph's warm-up makes them, never its capture. When a gradient
    is wanted the split is made on the fly, so that it reaches
    `rnn_conv.weight` (on the card the scan's backward recomputes it through
    `twa_scan_ref`), and the scan packs once per call."""

    def __init__(self, hidden_dim: int = 256):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([_GateCell(hidden_dim)])
        self._split: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._split_key = None
        self._packed: Optional[torch.Tensor] = None
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
        if torch.compiler.is_compiling():
            # a trace (`torch.export`) sees fake parameters, whose data cannot
            # key the cache: it bakes the split that an eager call made just
            # before it (`runners/export.py` makes one), and stores nothing
            return self._split if self._split is not None else self._split_of(w)
        key = (w.data_ptr(), w.dtype, w.device, w._version)
        if self._split_key != key:
            self._split = self._split_of(w.detach())
            self._split_key = key
            self._packed = None
        return self._split

    def packed_weight(self, dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
        """W_h packed for the per-frame kernel of `dtype` (the weight's by
        default): `pack_twa_weights` for f32, `pack_twa_weights_bf16` for
        bf16, of W_h cast to it; made once beside the cached split and
        dropped with it; None when a gradient is wanted or the weight is not
        f32 or bf16 on the card."""
        w = self.cell_list[0].rnn_conv.weight
        if (torch.is_grad_enabled() and w.requires_grad) or not _packs(w):
            return None
        dtype = dtype or w.dtype
        w_h = self.split_weight()[1]
        if self._packed is None or self._packed.dtype != dtype:
            pack = pack_twa_weights_bf16 if dtype == torch.bfloat16 else pack_twa_weights
            if torch.compiler.is_compiling():
                return pack(w_h.to(dtype))  # traced, not cached (`split_weight`)
            self._packed = pack(w_h.to(dtype))
        return self._packed

    def _apply(self, fn, *args, **kwargs):
        self._split = self._split_key = self._packed = None  # a cast or a move
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._split = self._split_key = self._packed = None
        super()._load_from_state_dict(*args, **kwargs)

    def _split_of(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (w[:, :self.hidden_dim].contiguous(memory_format=torch.channels_last),
                w[:, self.hidden_dim:].permute(2, 3, 1, 0).contiguous())

    def forward(self, x: torch.Tensor, state: torch.Tensor,
                height: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`height` is for a spatial mesh alone: the state's rows in the
        whole map (module docstring)."""
        if spatial.current() is not None:
            return self._band(x, state, height)
        v, s, h, w, c = x.shape
        w_x, w_h = self.split_weight()
        frames = x.reshape(v * s, h, w, c).permute(0, 3, 1, 2)
        gx = F.conv2d(frames, w_x, padding=1).permute(0, 2, 3, 1)
        gx = gx.contiguous().reshape(v, s, h, w, c)
        x = x.contiguous()
        scan = self.scan
        if scan is None:
            packed = None
            if _packs(w_h) and kernel_route(x.shape, x.dtype) == "twa_step":
                packed = self.packed_weight(x.dtype)
            scan = functools.partial(twa_scan, packed=packed)
        if seq_axis.current() is not None:
            return seq_axis.hand_state(lambda *args: scan(*args)[0], x, gx, w_h, state)
        return scan(x, gx, w_h, state)

    def _band(self, x: torch.Tensor, state: torch.Tensor,
              height: int) -> Tuple[torch.Tensor, torch.Tensor]:
        axis = spatial.current()
        v, s, h, w, c = x.shape
        w_x, w_h = self.split_weight()
        halo = spatial.window_needs(height, axis.world, 1, -1, 3)  # a row each side
        frames = x.reshape(v * s, h, w, c).permute(0, 3, 1, 2)
        frames = spatial.rows(frames, height, halo)
        gx = F.conv2d(frames, w_x, padding=(0, 1)).permute(0, 2, 3, 1)
        gx = gx.contiguous().reshape(v, s, h, w, c)
        zero = x.new_zeros((v, 1, 1, w, c))
        shape = (v, 1, h + 2, w, c)
        packed = None
        if self.scan is None and _packs(w_h) and kernel_route(shape, x.dtype) == "twa_step":
            packed = self.packed_weight(x.dtype)
        h_prev, ys = state, []
        for t in range(s):
            h_ext = spatial.rows(h_prev, height, halo, dim=1).contiguous()
            x_ext = torch.cat([zero, x[:, t:t + 1], zero], 2)
            g_ext = torch.cat([zero, gx[:, t:t + 1], zero], 2)
            if self.scan is not None:
                y, _ = self.scan(x_ext, g_ext, w_h, h_ext)
            else:
                y, _ = twa_scan(x_ext, g_ext, w_h, h_ext, packed=packed)
            h_prev = y[:, 0, 1:h + 1]
            ys.append(h_prev)
        out = torch.stack(ys, 1)
        return out, out[:, -1].clone()


class _GatedScan(nn.Module):
    """The split-gate recurrences of the ablations: a gate conv over
    concat([x_t, h_{t-1}]) with `gates` * C outputs (reference key
    `cell_list.0.rnn_conv`), its input half run once over all V*S frames
    as one conv and its hidden half per frame, as in the JAX cells. Plain
    PyTorch (cuDNN convs): no TPU kernel of the JAX package runs these.
    x (V, S, H, W, C); the carried state is (V, H, W, C) per tensor it
    holds; the frames and the state are NCHW views of channels-last memory
    inside."""

    gates = 1

    def __init__(self, hidden_dim: int = 256):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([_GateCell(hidden_dim, self.gates)])

    def step(self, gates: torch.Tensor, carry):
        """One frame: (the new carry, the frame's output) from the summed
        gate pre-activations (V, gates * C, H, W) and the carry."""
        raise NotImplementedError

    def scan(self, x: torch.Tensor, carry):
        """(ys (V, S, H, W, C), the last carry)."""
        v, s, h, w, c = x.shape
        weight = self.cell_list[0].rnn_conv.weight
        # each half laid out once per call, not once per frame
        w_x, w_h = (half.contiguous(memory_format=torch.channels_last)
                    for half in (weight[:, :c], weight[:, c:]))
        frames = x.reshape(v * s, h, w, c).permute(0, 3, 1, 2)
        gx = F.conv2d(frames, w_x, padding=1)
        gx = gx.reshape(v, s, *gx.shape[1:])
        ys = []
        for t in range(s):
            carry, y = self.step(gx[:, t] + F.conv2d(carry[0], w_h, padding=1), carry)
            ys.append(y.permute(0, 2, 3, 1))
        return torch.stack(ys, 1), carry


class ConvLSTM(_GatedScan):
    """x (V, S, H, W, C), state (V, 2, H, W, C) = (h, c) -> (ys, new state).

        [i, f, o, g] = conv([x_t, h_{t-1}], W), in that channel order
        c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
        h_t = sigmoid(o) * tanh(c_t)"""

    gates = 4

    def init_state(self, height: int, width: int, n_videos: int = 1,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(n_videos, 2, height, width, self.hidden_dim, dtype=dtype,
                           device=device)

    def step(self, gates, carry):
        ci, cf, co, cg = gates.chunk(4, dim=1)
        c = torch.sigmoid(cf) * carry[1] + torch.sigmoid(ci) * torch.tanh(cg)
        h = torch.sigmoid(co) * torch.tanh(c)
        return (h, c), h

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ys, (h, c) = self.scan(x, (state[:, 0].permute(0, 3, 1, 2),
                                   state[:, 1].permute(0, 3, 1, 2)))
        return ys, torch.stack([h.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)], 1)


class ConvSimGRU(_GatedScan):
    """x (V, S, H, W, C), state (V, H, W, C) -> (ys, h_last).

        [i, g] = conv([x_t, h_{t-1}], W)
        h_t = sigmoid(i) * tanh(g) + (1 - sigmoid(i)) * h_{t-1}"""

    gates = 2

    def init_state(self, height: int, width: int, n_videos: int = 1,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(n_videos, height, width, self.hidden_dim, dtype=dtype, device=device)

    def step(self, gates, carry):
        ci, cg = gates.chunk(2, dim=1)
        i = torch.sigmoid(ci)
        h = i * torch.tanh(cg) + (1.0 - i) * carry[0]
        return (h,), h

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ys, (h,) = self.scan(x, (state.permute(0, 3, 1, 2),))
        return ys, h.permute(0, 2, 3, 1)


class _EvalDWBlock(DWBlock):
    """A DWBlock that stays in eval form: `train(True)` leaves it in eval
    mode, so its BatchNorms always normalize with their running stats,
    which never move. The JAX `_TWADWCell` calls its gate block with
    `train=False`, also while the model trains."""

    def train(self, mode: bool = True):
        return super().train(False)


class _TWADWCell(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.rnn_conv = _EvalDWBlock(2 * hidden_dim, hidden_dim, 3, expand_ratio=4,
                                     res_connect=False)


class ConvTWADW(nn.Module):
    """TWA with a depthwise-separable gate: x (V, S, H, W, C), state
    (V, H, W, C) -> (ys, h_last).

        i_t = sigmoid(DWBlock(concat([x_t, h_{t-1}])))   (2C -> C, expand 4)
        h_t = i_t * x_t + (1 - i_t) * h_{t-1}

    The block's expand conv is not separable across the concat, so the
    whole block runs every frame. Its BatchNorms are always in eval form
    (`_EvalDWBlock`)."""

    def __init__(self, hidden_dim: int = 256):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([_TWADWCell(hidden_dim)])

    def init_state(self, height: int, width: int, n_videos: int = 1,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(n_videos, height, width, self.hidden_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gate_block = self.cell_list[0].rnn_conv
        h = state.permute(0, 3, 1, 2)
        ys = []
        for t in range(x.shape[1]):
            x_t = x[:, t].permute(0, 3, 1, 2)
            gate = torch.sigmoid(gate_block(laid_out_as(torch.cat([x_t, h], 1), x_t)))
            h = gate * x_t + (1.0 - gate) * h
            ys.append(h.permute(0, 2, 3, 1))
        return torch.stack(ys, 1), ys[-1]
