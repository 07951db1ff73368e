"""UAVSal, the full stateful video saliency model (counterpart of
`iip_uavsal_saliency_tpu/models/uavsal.py::UAVSal`), and `init_uavsal`, its
initialization from scratch.

trunk (SRF-Net -> STBlocks -> fuse DWBlock) -> MultiPriors -> ConvTWA ->
1-channel DWBlock head -> sigmoid, with the JAX model's knobs: the backbone
(`cnn_type`, and `s2d_stem` for MobileNetV2), the number of STBlocks
(`num_stblock`) and the prior streams (`bias_type` = (gauss, ob, context),
each 0 or 1). The flagship is MobileNetV2, 2 STBlocks and all three
streams.

The submodules carry the reference's state_dict names (`sfnet`,
`st_layer.{i}`, `fust_layer.0`, `gauss_cb_layer.{j}`, `ob_cb_layer.{j}`,
`cxt_cb_prior.{j}`, `fucb_layer.0`, `fucbst_layer.0`, `rnn`,
`conv_out_st`), which is why the JAX package's `_Trunk` and `MultiPriors`
are methods here (`trunk`, `multi_priors`) rather than nested modules. A
prior stream that is off has no layers, and with all three off neither
has `fucb_layer` nor `fucbst_layer`, as in the JAX model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.initializers import kaiming_normal_, lecun_normal_
from ..ops.layers import BatchNorm, DWBlock, laid_out_as
from ..ops.resize import resize_bilinear_align_corners
from .recurrent import ConvTWA
from .srfnet import SRFNet
from .stblock import STBlock

PLANES = 256
NUM_STBLOCK = 2
NB_GAUSSIAN = 8
NB_OB = 20
CB_OUPLANES = (64, 64, 64)
# the modules whose conv kernels the JAX package draws with kaiming fan_in
# (ConvBNAct's default; VGG16's plain convs take flax's lecun_normal); every
# other conv takes fan_out (its `_FAN_OUT`)
FAN_IN_PREFIXES = ("sfnet.features.", "gauss_cb_layer.", "ob_cb_layer.", "cxt_cb_prior.",
                   "fucb_layer.", "fucbst_layer.")


def _prior_nchw(prior: torch.Tensor) -> torch.Tensor:
    """(Ho, Wo, C) prior map -> (1, C, Ho, Wo)."""
    return prior.permute(2, 0, 1).unsqueeze(0)


class UAVSal(nn.Module):
    """forward(x, gauss_prior, ob_prior, state) -> (saliency, new_state)

    The module's `training` flag is the JAX model's `train`: BatchNorm takes
    batch statistics and moves its running stats, and MultiPriors runs its
    train form.

    x           : (V, S, H, W, 3) normalized frames, S % time_dims == 0
    gauss_prior : (H/8, W/8, 8), or None when bias_type[0] == 0
    ob_prior    : (H/8, W/8, 20), or None when bias_type[1] == 0
    state       : (V, H/8, W/8, 256) carried TWA hidden state
    saliency    : (V, S, H/8, W/8, 1)

    `fused_dwblock=True` switches `use_kernel` on for every DWBlock of the
    model; each block then runs as one fused kernel call (K2 on the card)
    wherever `ops/dwblock.py::supports_fused_dwblock` admits it, and as
    three convs elsewhere. Off by default, as in the JAX package.
    """

    def __init__(self, time_dims: int = 5, fused_dwblock: bool = False,
                 cnn_type: str = "mobilenet_v2", num_stblock: int = NUM_STBLOCK,
                 bias_type: Sequence[int] = (1, 1, 1), s2d_stem: bool = False):
        super().__init__()
        self.time_dims = time_dims
        self.cnn_type = cnn_type.lower()
        self.num_stblock = num_stblock
        self.bias_type = tuple(int(bool(b)) for b in bias_type)
        self.s2d_stem = s2d_stem
        planes = PLANES
        use_gauss, use_ob, use_cxt = self.bias_type

        self.sfnet = SRFNet(self.cnn_type, s2d_stem)
        self.st_layer = nn.ModuleList(
            [STBlock(planes, planes, reduction=planes // 32) for _ in range(num_stblock)])
        self.fust_layer = nn.Sequential(DWBlock(planes, planes, 3))
        self.gauss_cb_layer = nn.ModuleList(
            [DWBlock(NB_GAUSSIAN, CB_OUPLANES[0]),
             DWBlock(CB_OUPLANES[0], CB_OUPLANES[0])]) if use_gauss else None
        self.ob_cb_layer = nn.ModuleList(
            [DWBlock(NB_OB, CB_OUPLANES[1]),
             DWBlock(CB_OUPLANES[1], CB_OUPLANES[1])]) if use_ob else None
        self.cxt_cb_prior = nn.ModuleList(
            [DWBlock(planes, CB_OUPLANES[2], stride=2),
             DWBlock(CB_OUPLANES[2], CB_OUPLANES[2], stride=2)]) if use_cxt else None
        if any(self.bias_type):
            width = sum(c for c, on in zip(CB_OUPLANES, self.bias_type) if on)
            self.fucb_layer = nn.Sequential(DWBlock(width, planes // 4))
            self.fucbst_layer = nn.Sequential(DWBlock(planes + planes // 4, planes))
        self.rnn = ConvTWA(planes)
        self.conv_out_st = DWBlock(planes, 1, 3)
        if fused_dwblock:
            for module in self.modules():
                if isinstance(module, DWBlock):
                    module.use_kernel = True

    def init_state(self, height: int, width: int, n_videos: int = 1,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        """Zero TWA state for inputs of (height, width) pixels."""
        return self.rnn.init_state(height // 8, width // 8, n_videos, dtype, device)

    def trunk(self, x: torch.Tensor, diff_group: Optional[int] = None) -> torch.Tensor:
        """SRF-Net -> STBlocks -> fuse DWBlock over (N, 3, H, W) frames."""
        x = self.sfnet(x)
        for block in self.st_layer:
            x = block(x, diff_group)
        return self.fust_layer(x)

    def multi_priors(self, x: torch.Tensor, gauss_prior: Optional[torch.Tensor],
                     ob_prior: Optional[torch.Tensor], compat_cxt_tile: bool) -> torch.Tensor:
        """MP-Net prior fusion over (S, C, Ho, Wo) trunk features, with the
        streams `bias_type` switches on; with none, x as it is.

        Eval form: the prior streams run once and are broadcast, and `fucb`
        runs on the distinct rows only: G = S / time_dims with the context
        stream, one without it. Train form (as the JAX module's
        `train=True`): the prior streams run on S copies of their map, the
        context stream is tiled to S rows after its convs, and `fucb` runs
        on all S rows, because the running-var EMA's n/(n-1) factor depends
        on the batch size. `compat_cxt_tile` tiles the context t-major, as
        the reference does; it holds for one video only, since with V > 1
        it would mix context across videos."""
        use_gauss, use_ob, use_cxt = self.bias_type
        if not (use_gauss or use_ob or use_cxt):
            return x
        s, c, ho, wo = x.shape
        t = self.time_dims

        def stream(prior, layers):
            p = _prior_nchw(prior)  # (1, C, Ho, Wo) in channels-last memory
            if self.training:
                p = p.expand(s, -1, -1, -1).contiguous(memory_format=torch.channels_last)
            for layer in layers:
                p = layer(p)
            return p

        def tile(p):
            return p.repeat(t, 1, 1, 1) if compat_cxt_tile else p.repeat_interleave(t, dim=0)

        streams = []
        if use_gauss:
            streams.append(stream(gauss_prior, self.gauss_cb_layer))
        if use_ob:
            streams.append(stream(ob_prior, self.ob_cb_layer))
        if use_cxt:
            cxt = x.reshape(s // t, t, c, ho, wo).sum(dim=1)
            for layer in self.cxt_cb_prior:
                cxt = layer(cxt)
            cxt = resize_bilinear_align_corners(cxt, ho, wo)
            streams.append(tile(cxt) if self.training else cxt)
        rows = s if self.training else (s // t if use_cxt else 1)
        cb = torch.cat([p.expand(rows, *p.shape[1:]) for p in streams], dim=1)
        x_cb = self.fucb_layer(laid_out_as(cb, x))
        if rows != s:
            x_cb = tile(x_cb) if use_cxt else x_cb.expand(s, -1, -1, -1)
        return self.fucbst_layer(torch.cat([x, laid_out_as(x_cb, x)], dim=1))

    def forward(self, x: torch.Tensor, gauss_prior: Optional[torch.Tensor],
                ob_prior: Optional[torch.Tensor],
                state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        v, s, h, w, c = x.shape
        if s % self.time_dims:
            raise ValueError(f"S={s} is not a multiple of time_dims={self.time_dims}")
        # (V*S, 3, H, W) view whose memory stays channels-last
        frames = x.reshape(v * s, h, w, c).permute(0, 3, 1, 2)
        feats = self.trunk(frames, diff_group=s if v > 1 else None)
        feats = self.multi_priors(feats, gauss_prior, ob_prior, compat_cxt_tile=v == 1)
        ho, wo = feats.shape[-2], feats.shape[-1]
        seq = feats.permute(0, 2, 3, 1).reshape(v, s, ho, wo, PLANES)
        ys, new_state = self.rnn(seq, state)
        out = self.conv_out_st(ys.reshape(v * s, ho, wo, PLANES).permute(0, 3, 1, 2))
        return torch.sigmoid(out).permute(0, 2, 3, 1).reshape(v, s, ho, wo, 1), new_state


def init_uavsal(model: UAVSal, generator: torch.Generator) -> UAVSal:
    """Initialize `model` from scratch, in place, as the JAX package's
    `init_variables` does layer by layer: every conv kernel kaiming-normal
    with fan_in in the backbone (MobileNetV2, ResNet) and the prior streams
    and fan_out elsewhere (the SRF-Net neck, the STBlocks, the fuse block,
    the TWA gate and the head); VGG16's convs as flax's plain `nn.Conv`
    draws them, `lecun_normal` kernels and zero biases; BatchNorm scale 1,
    bias 0, running mean 0 and var 1. The draws come from `generator` (a
    CPU generator for a model on the CPU), in the order of
    `named_parameters`."""
    vgg = model.cnn_type == "vgg16"
    for name, p in model.named_parameters():
        if vgg and name.startswith("sfnet.features."):
            if p.dim() == 4:
                lecun_normal_(p, generator=generator)
            else:
                with torch.no_grad():
                    p.zero_()
        elif p.dim() == 4:
            mode = "fan_in" if name.startswith(FAN_IN_PREFIXES) else "fan_out"
            kaiming_normal_(p, mode=mode, generator=generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
