"""UAVSal, the full stateful video saliency model, and the ablation zoo
(counterparts of `iip_uavsal_saliency_tpu/models/uavsal.py`: `UAVSal`,
the 8 other `MODEL_ZOO` classes, `build_model`), and `init_model`, the
initialization of any of them from scratch.

UAVSal is trunk (SRF-Net -> STBlocks -> fuse DWBlock) -> MultiPriors ->
ConvTWA -> 1-channel DWBlock head -> sigmoid, with the JAX model's knobs:
the backbone (`cnn_type`, and `s2d_stem` for MobileNetV2), the number of
STBlocks (`num_stblock`) and the prior streams (`bias_type` = (gauss, ob,
context), each 0 or 1). The flagship is MobileNetV2, 2 STBlocks and all
three streams. The ablations keep the trunk and swap or drop a part (the
reference's ablation study): the ST stage (`UAVSalSpConv`: DWBlocks,
`UAVSalTeConv`: temporal branches only, `UAVSalSTBlocksType`: another
ordering of the branches, `UAVSalSTC3D`/`UAVSalSTC23D`: 3-D convs), the
recurrence (`UAVSalLSTM`: ConvLSTM; `UAVSalMP`: none) or the priors and
the recurrence both (`UAVSalSTBlocks`, the others but `UAVSalLSTM`).

The submodules carry the reference's state_dict names (`sfnet`,
`st_layer.{i}`, `fust_layer.0`, `gauss_cb_layer.{j}`, `ob_cb_layer.{j}`,
`cxt_cb_prior.{j}`, `fucb_layer.0`, `fucbst_layer.0`, `rnn`,
`conv_out_st`), which is why the JAX package's `_Trunk` and `MultiPriors`
are methods here (`trunk`, `multi_priors`) rather than nested modules. A
prior stream that is off has no layers, and with all three off neither
has `fucb_layer` nor `fucbst_layer`, as in the JAX model.

Call signatures are the JAX classes': UAVSal and UAVSalLSTM take (V, S,
H, W, 3) frames, the priors and the carried state and return (saliency
(V, S, H/8, W/8, 1), new state); UAVSalMP takes (S, H, W, 3) frames and
the priors; the others (S, H, W, 3) frames alone; those return (S, H/8,
W/8, 1) (UAVSalSTBlocks with the trunk's (S, H/8, W/8, planes) features).
Every class takes the JAX field `planes`, the trunk's width (256).
`models/adapters.py` gives them all UAVSal's interface. Where the JAX
classes set `diff_group` (and UAVSalMP `compat_cxt_tile`) as fields that
the adapter clones, these take them as arguments of `forward`.

On a spatial mesh (`parallel.spatial.over(axis)`) UAVSal takes this rank's
band of the frames' rows and of the state's and returns its band of the
saliency and of the new state: every layer runs on its band
(`ops/layers.py`), the priors are cut to the band, the context stream
keeps its bands down to H/32 and is resized back to the band, and the TWA
scan fetches a row of h_{s-1} each side each frame (`models/recurrent.py`).
The other classes of the zoo have no band form (ROADMAP A.13.1b).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.initializers import kaiming_normal_, lecun_normal_, xavier_uniform_
from ..ops.layers import BatchNorm, DWBlock, laid_out_as
from ..ops.resize import resize_bilinear_align_corners
from ..parallel import spatial
from .recurrent import ConvLSTM, ConvTWA
from .srfnet import SRFNet
from .stblock import ST_TYPES, STC23D, STC3D, STBlock, TeConvSub

NUM_STBLOCK = 2
NB_GAUSSIAN = 8
NB_OB = 20
CB_OUPLANES = (64, 64, 64)
# the modules whose conv kernels the JAX package draws with kaiming fan_in
# (ConvBNAct's default; VGG16's plain convs take flax's lecun_normal); every
# other conv takes fan_out (its `_FAN_OUT`) but ConvLSTM's gate (xavier_uniform)
FAN_IN_PREFIXES = ("sfnet.features.", "gauss_cb_layer.", "ob_cb_layer.", "cxt_cb_prior.",
                   "fucb_layer.", "fucbst_layer.")


def _prior_nchw(prior: torch.Tensor) -> torch.Tensor:
    """(Ho, Wo, C) prior map -> (1, C, Ho, Wo)."""
    return prior.permute(2, 0, 1).unsqueeze(0)


def _frames_nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) frames -> an (N, 3, H, W) view whose memory stays
    channels-last."""
    return x.permute(0, 3, 1, 2)


class _Zoo(nn.Module):
    """What the zoo's models share: the configuration, SRF-Net
    (`sfnet`), and the methods over the parts a model builds: `trunk`
    (`sfnet` -> `st_layer` -> `fust_layer`), `multi_priors` (the prior
    streams) and `head` (`conv_out_st` and the sigmoid). `model_name` is
    the class's `MODEL_ZOO` name."""

    model_name = ""

    def __init__(self, cnn_type: str, time_dims: Optional[int], num_stblock: int,
                 s2d_stem: bool = False, planes: int = 256):
        super().__init__()
        self.time_dims = time_dims
        self.cnn_type = cnn_type.lower()
        self.num_stblock = num_stblock
        self.s2d_stem = s2d_stem
        self.planes = planes
        self.sfnet = SRFNet(self.cnn_type, s2d_stem, last_channel=planes)

    def _add_trunk(self, block) -> None:
        """`st_layer` of `num_stblock` blocks made by `block()`, and
        `fust_layer`."""
        self.st_layer = nn.ModuleList([block() for _ in range(self.num_stblock)])
        self.fust_layer = nn.Sequential(DWBlock(self.planes, self.planes, 3))

    def _st_block(self, block_cls):
        """A maker of `block_cls` as the JAX `_Trunk` builds it: planes ->
        planes with the identity residual, and a temporal width of planes /
        (planes // 32) where it has a temporal branch; the 3-D blocks take
        `time_dims` instead."""
        if block_cls in (STC3D, STC23D):
            return functools.partial(block_cls, self.planes, self.planes, self.time_dims)
        return functools.partial(block_cls, self.planes, self.planes,
                                 reduction=self.planes // 32)

    def _add_priors(self, bias_type: Sequence[int]) -> None:
        """The prior streams that `bias_type` switches on, and with any on
        `fucb_layer` and `fucbst_layer`."""
        self.bias_type = tuple(int(bool(b)) for b in bias_type)
        use_gauss, use_ob, use_cxt = self.bias_type
        self.gauss_cb_layer = nn.ModuleList(
            [DWBlock(NB_GAUSSIAN, CB_OUPLANES[0]),
             DWBlock(CB_OUPLANES[0], CB_OUPLANES[0])]) if use_gauss else None
        self.ob_cb_layer = nn.ModuleList(
            [DWBlock(NB_OB, CB_OUPLANES[1]),
             DWBlock(CB_OUPLANES[1], CB_OUPLANES[1])]) if use_ob else None
        self.cxt_cb_prior = nn.ModuleList(
            [DWBlock(self.planes, CB_OUPLANES[2], stride=2),
             DWBlock(CB_OUPLANES[2], CB_OUPLANES[2], stride=2)]) if use_cxt else None
        if any(self.bias_type):
            width = sum(c for c, on in zip(CB_OUPLANES, self.bias_type) if on)
            cb_last = self.planes // 4
            self.fucb_layer = nn.Sequential(DWBlock(width, cb_last))
            self.fucbst_layer = nn.Sequential(DWBlock(self.planes + cb_last, self.planes))

    def trunk(self, x: torch.Tensor, diff_group: Optional[int] = None,
              height: Optional[int] = None) -> torch.Tensor:
        """SRF-Net -> ST blocks -> fuse DWBlock over (N, 3, H, W) frames; on
        a spatial mesh over a band of an image of `height` rows."""
        x = self.sfnet(x, height=height)
        ho = None if height is None else self.sfnet.features.stage_heights(height)[2]
        band = {} if height is None else {"height": ho}  # the 3-D blocks have no band form
        for block in self.st_layer:
            x = block(x, diff_group, **band)
        return self.fust_layer[0](x, height=ho)

    def multi_priors(self, x: torch.Tensor, gauss_prior: Optional[torch.Tensor],
                     ob_prior: Optional[torch.Tensor], compat_cxt_tile: bool,
                     height: Optional[int] = None) -> torch.Tensor:
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
        it would mix context across videos.

        On a spatial mesh x is a band of a map of `height` rows: the priors
        are cut to it and every stream keeps its bands."""
        use_gauss, use_ob, use_cxt = self.bias_type
        if not (use_gauss or use_ob or use_cxt):
            return x
        s, c, ho, wo = x.shape
        t = self.time_dims
        axis = spatial.current()
        band = None if axis is None else spatial.owned(height, axis.world, axis.rank)

        def stream(prior, layers):
            if band is not None:
                prior = prior[band[0]:band[1]]
            p = _prior_nchw(prior)  # (1, C, Ho, Wo) in channels-last memory
            if self.training:
                p = p.expand(s, -1, -1, -1).contiguous(memory_format=torch.channels_last)
            for layer in layers:
                p = layer(p, height=height)
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
            hc = height
            for layer in self.cxt_cb_prior:
                cxt = layer(cxt, height=hc)
                hc = None if hc is None else layer.out_height(hc)
            cxt = resize_bilinear_align_corners(cxt, ho if height is None else height, wo,
                                                height=hc)
            streams.append(tile(cxt) if self.training else cxt)
        rows = s if self.training else (s // t if use_cxt else 1)
        cb = torch.cat([p.expand(rows, *p.shape[1:]) for p in streams], dim=1)
        x_cb = self.fucb_layer[0](laid_out_as(cb, x), height=height)
        if rows != s:
            x_cb = tile(x_cb) if use_cxt else x_cb.expand(s, -1, -1, -1)
        return self.fucbst_layer[0](torch.cat([x, laid_out_as(x_cb, x)], dim=1), height=height)

    def head(self, feats: torch.Tensor, height: Optional[int] = None) -> torch.Tensor:
        """(N, planes, Ho, Wo) features -> saliency (N, Ho, Wo, 1)."""
        return torch.sigmoid(self.conv_out_st(feats, height=height)).permute(0, 2, 3, 1)

    def _check_clip(self, s: int) -> None:
        if s % self.time_dims:
            raise ValueError(f"S={s} is not a multiple of time_dims={self.time_dims}")


class _Stateful(_Zoo):
    """UAVSal and UAVSalLSTM: trunk -> MultiPriors -> a recurrence `rnn`
    over (V, S, Ho, Wo, planes) -> head, on (V, S, H, W, 3) frames with the
    carried state. `compat_cxt_tile` holds for one video: with V > 1 the
    context is tiled frame-aligned and the temporal differences are bounded
    per video, as in the JAX classes. V is the whole batch's: `videos`
    where a data-parallel train step gives this rank its rows of a batch of
    `videos` (the JAX step's jit sees the whole batch), else x's own, as a
    serving rank's (its `shard_map` runs each device's program on its
    shard). On a spatial mesh x and the state are this rank's bands of
    rows, which hold equal shares of the image's rows and of the state's
    (module docstring)."""

    compat_cxt_tile = True

    def forward(self, x: torch.Tensor, gauss_prior: Optional[torch.Tensor],
                ob_prior: Optional[torch.Tensor], state: torch.Tensor,
                videos: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        v, s, h, w, c = x.shape
        self._check_clip(s)
        videos = v if videos is None else videos
        axis = spatial.current()
        height = out_height = None
        band = {}
        if axis is not None:
            spatial.check_model(self)
            if h % 8 or state.shape[1] * 8 != h:
                raise ValueError(f"a band of {h} image rows needs one of {h // 8} state rows, got "
                                 f"{state.shape[1]} (H and H/8 must divide by {axis.world})")
            height, out_height = h * axis.world, h * axis.world // 8
            band = {"height": out_height}
        feats = self.trunk(_frames_nchw(x.reshape(v * s, h, w, c)),
                           diff_group=s if videos > 1 else None, height=height)
        feats = self.multi_priors(feats, gauss_prior, ob_prior,
                                  compat_cxt_tile=self.compat_cxt_tile and videos == 1,
                                  height=out_height)
        ho, wo = feats.shape[-2], feats.shape[-1]
        seq = feats.permute(0, 2, 3, 1).reshape(v, s, ho, wo, self.planes)
        ys, new_state = self.rnn(seq, state, **band)
        out = self.head(_frames_nchw(ys.reshape(v * s, ho, wo, self.planes)), height=out_height)
        return out.reshape(v, s, ho, wo, 1), new_state

    def init_state(self, height: int, width: int, n_videos: int = 1,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        """Zero recurrent state for inputs of (height, width) pixels."""
        return self.rnn.init_state(height // 8, width // 8, n_videos, dtype, device)


class UAVSal(_Stateful):
    """forward(x, gauss_prior, ob_prior, state) -> (saliency, new_state)

    The module's `training` flag is the JAX model's `train`: BatchNorm takes
    batch statistics and moves its running stats, and MultiPriors runs its
    train form.

    x           : (V, S, H, W, 3) normalized frames, S % time_dims == 0
    gauss_prior : (H/8, W/8, 8), or None when bias_type[0] == 0
    ob_prior    : (H/8, W/8, 20), or None when bias_type[1] == 0
    state       : (V, H/8, W/8, planes) carried TWA hidden state
    saliency    : (V, S, H/8, W/8, 1)

    `planes` is the trunk's width (256; the JAX field: 128 takes SRF-Net's
    narrow laterals, `models/srfnet.py`).

    `fused_dwblock=True` switches `use_kernel` on for every DWBlock of the
    model; each block then runs as one fused kernel call (K2 on the card)
    wherever `ops/dwblock.py::supports_fused_dwblock` admits it, and as
    three convs elsewhere. Off by default, as in the JAX package.
    """

    model_name = "uavsal"

    def __init__(self, time_dims: int = 5, fused_dwblock: bool = False,
                 cnn_type: str = "mobilenet_v2", num_stblock: int = NUM_STBLOCK,
                 bias_type: Sequence[int] = (1, 1, 1), s2d_stem: bool = False,
                 planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, s2d_stem, planes)
        self._add_trunk(self._st_block(STBlock))
        self._add_priors(bias_type)
        self.rnn = ConvTWA(planes)
        self.conv_out_st = DWBlock(planes, 1, 3)
        if fused_dwblock:
            for module in self.modules():
                if isinstance(module, DWBlock):
                    module.use_kernel = True


class UAVSalLSTM(_Stateful):
    """UAVSal with a ConvLSTM for the TWA cell: the same call, a state of
    (V, 2, H/8, W/8, planes) (h and c)."""

    model_name = "uavsal_lstm"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, bias_type: Sequence[int] = (1, 1, 1),
                 compat_cxt_tile: bool = True, planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self.compat_cxt_tile = compat_cxt_tile
        self._add_trunk(self._st_block(STBlock))
        self._add_priors(bias_type)
        self.rnn = ConvLSTM(planes)
        self.conv_out_st = DWBlock(planes, 1, 3)


class _Stateless(_Zoo):
    """Trunk -> head over (S, H, W, 3) frames -> (S, H/8, W/8, 1)."""

    def forward(self, x: torch.Tensor, diff_group: Optional[int] = None) -> torch.Tensor:
        return self.head(self.trunk(_frames_nchw(x), diff_group))


class UAVSalSpConv(_Stateless):
    """Sp-Net: the ST blocks are plain DWBlocks with the identity residual
    (`st_layer.{i}` is the block itself). No temporal op: `diff_group` is
    taken and not needed."""

    model_name = "uavsal_spconv"

    def __init__(self, cnn_type: str = "mobilenet_v2", num_stblock: int = NUM_STBLOCK,
                 planes: int = 256):
        super().__init__(cnn_type, None, num_stblock, planes=planes)  # no time_dims
        self._add_trunk(functools.partial(DWBlock, planes, planes, 3, res_connect=True))
        self.conv_out_st = DWBlock(planes, 1, 3)

    def trunk(self, x: torch.Tensor, diff_group: Optional[int] = None) -> torch.Tensor:
        x = self.sfnet(x)
        for block in self.st_layer:
            x = block(x)
        return self.fust_layer(x)


class UAVSalTeConv(_Stateless):
    """Te-Net: the ST blocks are temporal branches alone (`TeConvSub` with
    the identity residual; `st_layer.{i}` is the branch itself)."""

    model_name = "uavsal_teconv"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self._add_trunk(functools.partial(TeConvSub, planes, planes, planes // 32,
                                          res_connect=True))
        self.conv_out_st = DWBlock(planes, 1, 3)


class UAVSalSTBlocks(_Stateless):
    """ST-Net: the trunk and the head, no priors, no recurrence. Returns
    (saliency, the trunk's features (S, H/8, W/8, planes))."""

    model_name = "uavsal_stblocks"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self._add_trunk(self._st_block(STBlock))
        self.conv_out_st = DWBlock(planes, 1, 3)

    def forward(self, x: torch.Tensor,
                diff_group: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.trunk(_frames_nchw(x), diff_group)
        return self.head(feats), feats.permute(0, 2, 3, 1)


class UAVSalSTBlocksType(_Stateless):
    """ST-Net with the branches in the order `st_type` names (`ST_TYPES`:
    "st" parallel, "s2t", "t2s", "s_s2t")."""

    model_name = "uavsal_stblocks_type"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, st_type: str = "st", planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self.st_type = st_type
        self._add_trunk(self._st_block(ST_TYPES[st_type]))
        self.conv_out_st = DWBlock(planes, 1, 3)


class UAVSalSTC3D(_Stateless):
    """The ST blocks are one 3x3x3 ConvBNAct3D each (`STC3D`), over runs of
    `time_dims` frames, which never cross videos: `diff_group` is taken and
    not needed."""

    model_name = "uavsal_stc3d"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self._add_trunk(self._st_block(STC3D))
        self.conv_out_st = DWBlock(planes, 1, 3)


class UAVSalSTC23D(_Stateless):
    """The ST blocks are parallel 2-D and 3-D convs (`STC23D`), as
    `UAVSalSTC3D` for the videos."""

    model_name = "uavsal_stc2_3d"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self._add_trunk(self._st_block(STC23D))
        self.conv_out_st = DWBlock(planes, 1, 3)


class UAVSalMP(_Zoo):
    """MP-Net: the trunk, MultiPriors and the head, no recurrence, over
    (S, H, W, 3) frames: forward(x, gauss_prior, ob_prior, diff_group=None,
    compat_cxt_tile=None) -> (S, H/8, W/8, 1). `compat_cxt_tile` None is
    the model's own (the reference's t-major tile by default)."""

    model_name = "uavsal_mp"

    def __init__(self, cnn_type: str = "mobilenet_v2", time_dims: int = 5,
                 num_stblock: int = NUM_STBLOCK, bias_type: Sequence[int] = (1, 1, 1),
                 compat_cxt_tile: bool = True, planes: int = 256):
        super().__init__(cnn_type, time_dims, num_stblock, planes=planes)
        self.compat_cxt_tile = compat_cxt_tile
        self._add_trunk(self._st_block(STBlock))
        self._add_priors(bias_type)
        self.conv_out_st = DWBlock(planes, 1, 3)

    def forward(self, x: torch.Tensor, gauss_prior: Optional[torch.Tensor],
                ob_prior: Optional[torch.Tensor], diff_group: Optional[int] = None,
                compat_cxt_tile: Optional[bool] = None) -> torch.Tensor:
        self._check_clip(x.shape[0])
        tile = self.compat_cxt_tile if compat_cxt_tile is None else compat_cxt_tile
        feats = self.multi_priors(self.trunk(_frames_nchw(x), diff_group), gauss_prior,
                                  ob_prior, tile)
        return self.head(feats)


MODEL_ZOO = {cls.model_name: cls for cls in (
    UAVSal, UAVSalSpConv, UAVSalTeConv, UAVSalSTBlocks, UAVSalSTBlocksType, UAVSalSTC3D,
    UAVSalSTC23D, UAVSalMP, UAVSalLSTM)}


def build_model(name: str = "uavsal", **kwargs) -> nn.Module:
    """The `MODEL_ZOO` class of `name` (a KeyError for any other name)."""
    return MODEL_ZOO[name.lower()](**kwargs)


def init_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize any model of the zoo (or a part of one) from scratch, in
    place, as the JAX package's `init_variables` does layer by layer:
    every conv kernel kaiming-normal with fan_in in the backbone
    (MobileNetV2, ResNet) and the prior streams and fan_out elsewhere (the
    SRF-Net neck, the ST blocks and their 3-D convs, the fuse block, the
    TWA and SimGRU gates, ConvTWADW's gate block and the head); ConvLSTM's
    gate xavier-uniform; VGG16's convs as flax's plain `nn.Conv` draws
    them, `lecun_normal` kernels and zero biases; BatchNorm scale 1, bias
    0, running mean 0 and var 1. The draws come from `generator` (a CPU
    generator for a model on the CPU), in the order of `named_parameters`."""
    vgg = getattr(model, "cnn_type", None) == "vgg16"
    xavier = {id(m.cell_list[0].rnn_conv.weight) for m in model.modules()
              if isinstance(m, ConvLSTM)}
    for name, p in model.named_parameters():
        if vgg and name.startswith("sfnet.features."):
            if p.dim() == 4:
                lecun_normal_(p, generator=generator)
            else:
                with torch.no_grad():
                    p.zero_()
        elif id(p) in xavier:
            xavier_uniform_(p, generator=generator)
        elif p.dim() >= 4:
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
