"""Conv building blocks (NCHW modules, channels_last on the card).

Counterparts of `iip_uavsal_saliency_tpu/ops/layers.py`:

- `BatchNorm` == TorchBatchNorm: in eval mode `y = x * s + b` with the
  per-channel affine computed in f32 and applied in the activation dtype; in
  train mode batch statistics and the running-stat EMA, which
  `running_stats_held()` switches off while a rematerialized forward is
  recomputed.
- `ConvBNAct` == BasicConv2d: Conv(bias=False) -> BatchNorm -> ReLU6 (no
  activation with `act=False`, as ResNet's `downsample`) with symmetric
  `dilation * (k - 1) // 2` padding. The JAX package computes the ASPP
  rate-18 depthwise conv as an exact pad-add sum; here it is the same
  dilated depthwise conv.
- `ConvBNAct3D` == ConvBNAct3D: Conv3d(bias=False) -> BatchNorm -> ReLU6
  over (N, C, T, H, W), the same padding on all three axes (the 3-D
  ablation blocks).
- `S2DStem` == S2DStem: the 3x3 stride-2 stem computed exactly as a 2x2
  conv over the 2x2 space-to-depth input (`space_to_depth`), with the
  plain stem's weights and keys.
- `DWBlock` == dwBlock: [1x1 expand] -> depthwise kxk -> 1x1 project + BN,
  with an identity residual when stride == 1 and in == out channels (which
  `res_connect=False` turns off). With `use_kernel=True` a block in eval
  mode that `ops/dwblock.py::supports_fused_dwblock` admits runs as one
  call of `fused_dwblock` (kernel K2 on the card).

On a spatial mesh (inside `parallel.spatial.over(axis)`) `ConvBNAct`,
`S2DStem` and `DWBlock` take a band of the rows of their input and give
their band of the output rows: called with `height`, the input's rows in
the whole map, each conv fetches the input rows its output band reads
(`band_conv`: zeros beyond the image, which is the conv's own zero
padding) and runs with its row padding off, so each BatchNorm sees this
rank's rows alone and reduces them with every other rank's
(`parallel/batchnorm.py`). A DWBlock that takes the fused kernel fetches
a row of x each side instead (real rows only: at the image's edges the
kernel's own padding of its expansion acts) and keeps its band of the
kernel's output. A band of no rows runs no conv.

Module names follow the reference's state_dict keys (`<conv>.0/.1`,
`<block>.conv.{0..3}`), so a state_dict from `models/convert.py` loads
with `strict=True`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from ..parallel.batchnorm import cross_rank_batch_norm
from ..parallel.mesh import batch_group
from .dwblock import fused_dwblock, pack_dwblock_weights, supports_fused_dwblock

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention, new = m * old + (1 - m) * batch (torch's 0.1)

# open `running_stats_held` contexts; a global, not a thread-local: the
# autograd engine recomputes a checkpointed forward on its own thread
_stats_held = 0


@contextlib.contextmanager
def running_stats_held() -> Iterator[None]:
    """Train-mode BatchNorms inside take their batch statistics as before
    but leave the running stats where they are. The recompute of a
    checkpointed forward runs in it (`training/steps.py`, `remat`): the
    forward moved the stats once, as the JAX package's forward does."""
    global _stats_held
    _stats_held += 1
    try:
        yield
    finally:
        _stats_held -= 1


def channels_last_format(t: torch.Tensor) -> torch.memory_format:
    """The channels-last memory format of a tensor of t's rank:
    `channels_last` for 4-D (N, C, H, W), `channels_last_3d` for 5-D
    (N, C, T, H, W), else the plain contiguous format."""
    return {4: torch.channels_last, 5: torch.channels_last_3d}.get(
        t.dim(), torch.contiguous_format)


def laid_out_as(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` in channels-last memory where `ref` lies so (as activations do on
    the card), else `t` as it is. `cat`, `repeat` and reshapes give up the
    layout; the fused dwBlock kernel needs it and cuDNN is faster with it.

    While `torch.export` traces, the strides it sees are its fake tensors',
    which on the card need not be those the real `cat` gives: there every
    activation is laid out (a copy in the exported graph), and a `contiguous`
    that the fake strides call a no-op is not left out of it."""
    fmt = channels_last_format(t)
    if torch.compiler.is_compiling() and t.device.type == "cuda" and fmt != torch.contiguous_format:
        return t.clone(memory_format=fmt)
    if ref.is_contiguous(memory_format=channels_last_format(ref)) and not ref.is_contiguous():
        return t.contiguous(memory_format=fmt)
    return t


def to_channels_last(model: nn.Module, device=None) -> nn.Module:
    """`model` moved to `device` (where given) with every 4-D parameter and
    buffer in `channels_last` memory and every 5-D one (a Conv3d kernel) in
    `channels_last_3d`, in place, as `Module.to(memory_format=channels_last)`
    lays out 4-D ones (it raises on a 5-D tensor). `Tensor.to`, not
    `contiguous`: a 1x1 or depthwise kernel's default strides already count
    as channels-last contiguous, but only the canonical ones make cuDNN
    give channels-last outputs (which the fused dwBlock kernel needs)."""
    if device is not None:
        model.to(device)
    return model._apply(lambda t: t.to(memory_format=channels_last_format(t))
                        if t.dim() in (4, 5) else t)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of a 4-D or 5-D input with the torch key layout
    (`weight`, `bias`, `running_mean`, `running_var`); the module's
    `training` flag picks the mode.

    Train mode (the JAX package's TorchBatchNorm): the statistics come from
    the batch over N*H*W in at least f32 (bf16 activations are not widened
    in memory: torch's mixed-type batch norm reduces them in f32), the
    activation is normalized with the biased variance, and the f32 running
    stats move by an EMA with momentum `BN_MOMENTUM` in flax's convention
    whose variance term carries the unbiased n/(n-1) factor. That is
    `F.batch_norm(training=True, momentum=1 - BN_MOMENTUM)`, whose variance
    is a two-pass (or Welford) one, not E[x^2] - E[x]^2, which cancels badly
    after ReLU6 (mean >> std). Parameters of another dtype than f32 (the
    bf16 copies of a mixed-precision step) are widened to f32 for it, as
    the JAX module widens them to its stat dtype; the output keeps the
    activation dtype. Inside `parallel.batch_over(group)` of more than one
    rank the statistics are those of every rank's batch together
    (`parallel/batchnorm.py`), as in the JAX package's step over a sharded
    batch; with no group, or one rank, the path above is unchanged."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(s, b) of the eval mode in f32 (f64 for f64 params)."""
        dt = torch.promote_types(self.weight.dtype, torch.float32)
        s = self.weight.to(dt) * torch.rsqrt(self.running_var.to(dt) + self.eps)
        b = self.bias.to(dt) - self.running_mean.to(dt) * s
        return s, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dt = self.running_mean.dtype
            layout = channels_last_format(x)
            cpu_channels_last = x.device.type == "cpu" and not x.is_contiguous()
            if cpu_channels_last:
                # torch's CPU kernel sums a channels-last batch's statistics
                # in f32, row after row: at 360x640 (576,000 samples per
                # channel in the first blocks) a train step's TWA state
                # drifted 2% from the card's; the contiguous kernel
                # accumulates in f64
                x = x.contiguous()
            stats = (self.running_mean, self.running_var)
            if _stats_held:  # copies that take the EMA (no stats at all save fewer tensors,
                stats = tuple(t.clone() for t in stats)  # which the recompute check refuses)
            group = batch_group()
            if group is not None and group.world > 1:
                y = cross_rank_batch_norm(x, self.weight.to(dt), self.bias.to(dt), *stats,
                                          1.0 - BN_MOMENTUM, self.eps, group)
            else:
                y = F.batch_norm(x, *stats, self.weight.to(dt), self.bias.to(dt), True,
                                 1.0 - BN_MOMENTUM, self.eps)
            return y.contiguous(memory_format=layout) if cpu_channels_last else y
        s, b = self.affine()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return torch.addcmul(b.to(x.dtype).view(shape), x, s.to(x.dtype).view(shape))


class _EmptyConv(torch.autograd.Function):
    """A conv's output of no rows (no `F.conv2d`: it refuses an input of
    no rows), wired to its input and weight so that the backward reaches
    the layers before it as it does on every other rank."""

    @staticmethod
    def forward(ctx, x, weight, shape):
        ctx.save_for_backward(x, weight)
        return x.new_zeros(shape)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return torch.zeros_like(x), torch.zeros_like(weight), None


def band_conv(conv: nn.Conv2d, x: torch.Tensor,
              height: Optional[int]) -> Tuple[torch.Tensor, Optional[int]]:
    """`conv` on this rank's band of a map of `height` rows, inside
    `parallel.spatial.over`: (its band of the output, the output's rows in
    the whole map). A 1x1 stride-1 conv runs on the band as it is (no
    `height` needed); any other fetches the input rows its output band
    reads, zeros beyond the image, and runs with its row padding off, which
    anchors a strided conv's grid on the right row."""
    axis = spatial.current()
    (k, _), (s, s_w), (d, d_w), (p, p_w) = conv.kernel_size, conv.stride, conv.dilation, \
        conv.padding
    if k == 1 and s == 1 and p == 0:
        out_height, xe = height, x
    else:
        if height is None:
            raise ValueError("a conv with a halo needs its input's rows in the whole map "
                             "(height=) on a spatial mesh")
        out_height = spatial.conv_rows(height, k, s, d, p)
        needs = spatial.window_needs(out_height, axis.world, s, -p, d * (k - 1) + 1)
        xe = laid_out_as(spatial.rows(x, height, needs), x)
    if (xe.shape[2] - d * (k - 1) - 1) // s + 1 <= 0:  # a band of no rows
        w_out = (x.shape[3] + 2 * p_w - d_w * (conv.kernel_size[1] - 1) - 1) // s_w + 1
        y = _EmptyConv.apply(xe, conv.weight, (x.shape[0], conv.out_channels, 0, w_out))
        return laid_out_as(y, x), out_height
    y = F.conv2d(xe, conv.weight, conv.bias, (s, s_w), (0, p_w), (d, d_w), conv.groups)
    return laid_out_as(y, x), out_height


class ConvBNAct(nn.Sequential):
    """Conv2d(bias=False) -> BatchNorm -> [ReLU6]; keys `0.weight`, `1.*`.
    `height` is for a spatial mesh alone (`band_conv`)."""

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        if spatial.current() is None:
            return super().forward(x)
        return self.band(x, height)[0]

    def band(self, x: torch.Tensor, height: Optional[int]) -> Tuple[torch.Tensor, Optional[int]]:
        """(this rank's band of the output, the output's rows in the whole
        map) for x a band of a map of `height` rows (`band_conv`)."""
        y, out_height = band_conv(self[0], x, height)
        for layer in list(self)[1:]:
            y = layer(y)
        return y, out_height

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 act: bool = True):
        pad = dilation * (kernel_size - 1) // 2
        layers = [
            nn.Conv2d(in_ch, out_ch, kernel_size, stride, pad, dilation,
                      groups=groups, bias=False),
            BatchNorm(out_ch),
        ]
        if act:
            layers.append(nn.ReLU6())
        super().__init__(*layers)


class ConvBNAct3D(nn.Sequential):
    """Conv3d(bias=False) -> BatchNorm -> ReLU6 over (N, C, T, H, W), padded
    by `dilation * (k - 1) // 2` on all three axes; keys `0.weight`, `1.*`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1):
        pad = dilation * (kernel_size - 1) // 2
        super().__init__(
            nn.Conv3d(in_ch, out_ch, kernel_size, stride, pad, dilation, bias=False),
            BatchNorm(out_ch),
            nn.ReLU6(),
        )


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2); channel (2a + b)*C + c holds the
    pixel at phase (a, b) of its 2x2 block, the JAX package's order. The
    result lies in memory as x does."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs H and W divisible by 2, got {h}x{w}")
    y = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return laid_out_as(y.reshape(n, 4 * c, h // 2, w // 2), x)


class S2DStem(ConvBNAct):
    """The 3x3 stride-2 stem (padding 1) computed exactly as a 2x2 stride-1
    conv over the 2x2 space-to-depth input, padded by one row and column
    before. It is the plain stem's ConvBNAct (same modules and keys), so a
    checkpoint loads unchanged and `ops/fold.py::fold_conv_bn` folds it as
    it folds the plain stem; the kernel is regrouped at each call: padded
    with a zero row and column before, its 4x4 taps split into 2x2 blocks of
    2x2 phases. Needs even H and W."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, stride=2)

    def s2d_weight(self) -> torch.Tensor:
        """The stem's (F, C, 3, 3) kernel as the (F, 4C, 2, 2) kernel over
        `space_to_depth`'s channels."""
        k = self[0].weight
        f, c = k.shape[:2]
        kp = F.pad(k, (1, 0, 1, 0))  # (F, C, 4, 4), a zero tap row and column before
        k2 = kp.reshape(f, c, 2, 2, 2, 2)  # [f, c, ki, a, kj, b]
        return k2.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 2, 2)

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        conv = self[0]
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        axis = spatial.current()
        if axis is None:
            y = F.conv2d(F.pad(space_to_depth(x), (1, 0, 1, 0)), self.s2d_weight().to(x.dtype),
                         bias)
        else:  # output row o reads rows 2o - 2 .. 2o + 1 (a zero row pair above row 0)
            needs = spatial.window_needs(height // 2, axis.world, 2, -2, 4)
            xe = F.pad(space_to_depth(laid_out_as(spatial.rows(x, height, needs), x)), (1, 0))
            weight = self.s2d_weight().to(x.dtype)
            if xe.shape[2] < 2:  # a band of no rows
                y = _EmptyConv.apply(xe, weight, (x.shape[0], conv.out_channels, 0,
                                                  x.shape[3] // 2))
            else:
                y = F.conv2d(xe, weight, bias)
        y = laid_out_as(y, x)
        for layer in list(self)[1:]:
            y = layer(y)
        return y


def _folded(conv: nn.Conv2d, bn: nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, bias) of `conv` with the BatchNorm after it folded in, in
    f32; `bn` is an Identity once `ops/fold.py::fold_conv_bn` has run."""
    w = conv.weight.to(torch.promote_types(conv.weight.dtype, torch.float32))
    bias = None if conv.bias is None else conv.bias.to(w.dtype)
    if isinstance(bn, BatchNorm):
        s, b = bn.affine()
        w = w * s.view(-1, 1, 1, 1)
        bias = b if bias is None else b + bias * s
    elif bias is None:
        bias = w.new_zeros(w.shape[0])
    return w, bias


class DWBlock(nn.Module):
    """Inverted-residual block (expand_ratio default 6).

    With expand: `conv.0` (1x1 ConvBNAct), `conv.1` (depthwise ConvBNAct),
    `conv.2` (1x1 project), `conv.3` (BatchNorm). Without (ratio 1): `conv.0`
    depthwise, `conv.1` project, `conv.2` BatchNorm.

    `use_kernel=True` (counterpart of the JAX block's `use_pallas`, off by
    default as there): in eval mode, where `supports_fused_dwblock` admits
    the block and the input's dtype, the whole block is one call of `fused_dwblock` on
    BN-folded weights packed into the kernel's layouts; otherwise the three
    convs. The gate reads only the block's own static facts, its mode and
    the input's shape and dtype. The state_dict is the same on both paths. On the card
    the input must lie in channels-last memory."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, expand_ratio: int = 6, dilation: int = 1,
                 res_connect: Optional[bool] = None, use_kernel: bool = False):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        use_res = stride == 1 and in_ch == out_ch
        if res_connect is not None:
            use_res = use_res and res_connect
        self.use_res = use_res
        self.use_kernel = use_kernel
        self.out_ch = out_ch
        self.geometry = (kernel_size, stride, dilation, expand_ratio)
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(in_ch, hidden, 1))
        layers += [
            ConvBNAct(hidden, hidden, kernel_size, stride, dilation, groups=hidden),
            nn.Conv2d(hidden, out_ch, 1, bias=False),
            BatchNorm(out_ch),
        ]
        self.conv = nn.Sequential(*layers)
        self._packed: Optional[Tuple[torch.Tensor, ...]] = None
        self._blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def takes_kernel(self, x_shape, dtype: torch.dtype) -> bool:
        """Whether an (N, C, H, W) input of `dtype` goes through the kernel.
        Never in train mode: the kernel folds BatchNorm from the running
        stats, as the JAX block's `_fused_path` refuses training too."""
        if self.training or not self.use_kernel or len(x_shape) != 4:
            return False
        n, c, h, w = x_shape
        return supports_fused_dwblock((n, h, w, c), dtype, *self.geometry,
                                      self.out_ch, self.use_res)

    def pack(self, dtype: torch.dtype) -> None:
        """Pack the kernel's weights once, for serving: the folded weights
        and the kernel's shared-memory layout of them for bf16 or f32
        (`pack_dwblock_weights`). From here on the kernel path reads these
        and no longer looks at the parameters, so call it after the last
        cast or load (`make_baked_infer_step` does); a later `.to()`,
        `load_state_dict` or `pack` drops them. A block without an expand
        conv never takes the kernel and packs nothing."""
        if len(self.conv) == 4:
            with torch.no_grad():
                self._packed = self._pack(dtype)
                w1, b1, wd, bd, w2, _ = self._packed
                self._blobs = (pack_dwblock_weights(w1, b1, wd, bd, w2)
                               if dtype in (torch.bfloat16, torch.float32) else None)

    def packed_weights(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """(W1 (C, E), b1, Wd (3, 3, E), bd, W2 (E, Co), b2) in `dtype` with
        BatchNorm folded, as `fused_dwblock` reads them: those `pack` made,
        or else (and whenever a gradient is wanted, so that it reaches the
        block's parameters) packed on the fly from the parameters as they
        are now."""
        packed = self._packed
        if packed is None or packed[0].dtype != dtype or (
                torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())):
            return self._pack(dtype)
        return packed

    def kernel_weights(self, dtype: torch.dtype):
        """(`packed_weights(dtype)`, the kernel's blobs that `pack` made of
        exactly those, or None: then the kernel's wrapper packs on the fly)."""
        weights = self.packed_weights(dtype)
        return weights, self._blobs if weights is self._packed else None

    def _apply(self, fn, *args, **kwargs):
        self._packed = self._blobs = None  # a cast or a move: the packed copies are stale
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._packed = self._blobs = None
        super()._load_from_state_dict(*args, **kwargs)

    def _pack(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        expand, dw, project, project_bn = self.conv
        w1, b1 = _folded(expand[0], expand[1])
        wd, bd = _folded(dw[0], dw[1])
        w2, b2 = _folded(project, project_bn)
        packed = (w1[:, :, 0, 0].t(), b1, wd[:, 0].permute(1, 2, 0), bd,
                  w2[:, :, 0, 0].t(), b2)
        return tuple(t.to(dtype).contiguous() for t in packed)

    def out_height(self, height: int) -> int:
        """The block's output rows for `height` input rows."""
        k, s, d, _ = self.geometry
        return spatial.conv_rows(height, k, s, d, d * (k - 1) // 2)

    def forward(self, x: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        """`height` is for a spatial mesh alone: the rows of x's map."""
        if spatial.current() is not None:
            return self._band(x, height)
        if self.takes_kernel(x.shape, x.dtype):
            # NCHW tensor in channels-last memory <-> the NHWC the kernel reads;
            # on the card the kernel's wrapper raises on any other memory
            weights, blobs = self.kernel_weights(x.dtype)
            out = fused_dwblock(x.permute(0, 2, 3, 1), *weights, self.use_res, blobs)
            return out.permute(0, 3, 1, 2)
        y = self.conv(x)
        return x + y if self.use_res else y

    def _band(self, x: torch.Tensor, height: Optional[int]) -> torch.Tensor:
        """The block on this rank's band (module docstring). Whether the
        fused kernel runs is read off the whole map's shape, so every rank
        of the axis takes the same path and the same exchanges."""
        axis = spatial.current()
        n, c, _, w = x.shape
        if height is not None and self.takes_kernel((n, c, height, w), x.dtype):
            lo, hi = spatial.owned(height, axis.world, axis.rank)
            needs = [(max(a - 1, 0), min(b + 1, height)) if b > a else (0, 0)
                     for a, b in (spatial.owned(height, axis.world, q) for q in range(axis.world))]
            xe = laid_out_as(spatial.rows(x, height, needs), x)
            weights, blobs = self.kernel_weights(x.dtype)
            if hi == lo:
                return laid_out_as(_EmptyConv.apply(xe, weights[0], (n, self.out_ch, 0, w)), x)
            out = fused_dwblock(xe.permute(0, 2, 3, 1), *weights, self.use_res, blobs)
            return laid_out_as(out.permute(0, 3, 1, 2).narrow(2, lo - needs[axis.rank][0], hi - lo),
                               x)
        y, h = x, height
        for layer in self.conv:
            if isinstance(layer, ConvBNAct):
                y, h = layer.band(y, h)
            elif isinstance(layer, nn.Conv2d):
                y, h = band_conv(layer, y, h)
            else:
                y = layer(y)
        return x + y if self.use_res else y
