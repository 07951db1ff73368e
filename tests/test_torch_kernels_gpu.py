"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. A CUDA kernel has no CPU mode, so every test here is marked
`gpu` and skips without a card.

This file imports torch and the port only, so it also runs on a machine
without JAX; the repository's conftest imports JAX, so run it there as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.ops import dwblock as dw
from iip_uavsal_saliency_tpu_torch.ops.dwblock import (dwblock_ref, fused_dwblock,
                                                       fused_dwblock_kernel, pack_dwblock_weights)
from iip_uavsal_saliency_tpu_torch.ops import twa
from iip_uavsal_saliency_tpu_torch.ops.twa import (_lib, _twa_scan_cuda, clip_takes,
                                                    kernel_route, pack_twa_weights,
                                                    pack_twa_weights_bf16, twa_scan,
                                                    twa_scan_ref)
from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference, predict_videos
from iip_uavsal_saliency_tpu_torch.serving.steps import WARMUP_CALLS, graph_step, make_baked_infer_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(v, s, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(v, s, h, w, c) * 0.5, rng.randn(v, s, h, w, c) * 0.5,
            rng.randn(3, 3, c, c) * np.sqrt(2.0 / (9 * c)), rng.randn(v, h, w, c) * 0.5)


def _launches(route, frames):
    """What a scan of `frames` frames adds to the counts on `route`."""
    return {"twa_scan": int(route == "twa_scan"),
            "twa_step": frames if route == "twa_step" else 0, "dwblock": 0}


# f32: the kernel's 3xTF32 products (each within about 2^-21 of the f32
# product, the tensor cores' sums folded into f32 every 96 of K) and cuDNN
# (TF32 off) sum the 9*C products in other orders.
# bf16: the plain version rounds the conv and the gate to bf16 every frame,
# the kernel keeps them in f32 until it stores h_s.
STEP_CASES = {
    # name: (v, s, h, w, c), dtypes; every shape here goes to the per-frame kernel
    "ragged": ((2, 5, 13, 7, 24), ("f32", "bf16")),        # C % 32 != 0
    "three_videos": ((3, 4, 20, 8, 8), ("f32", "bf16")),
    "one_pixel": ((1, 2, 1, 1, 8), ("f32", "bf16")),
    "flagship": ((1, 20, 45, 80, 256), ("f32",)),           # as the f32 paths serve it
    "c40": ((2, 3, 9, 11, 40), ("f32",)),                   # N and K not multiples of the tiles
    "c264": ((1, 3, 7, 19, 264), ("f32",)),                 # a second, 8-column block of N
    "planes128": ((1, 20, 45, 80, 128), ("f32",)),          # UAVSal(planes=128), f32
}
STEP_TOL = {"f32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("name,dtype_name", [(n, d) for n, (_, ds) in STEP_CASES.items()
                                             for d in ds])
def test_twa_kernel_matches_ref(card, name, dtype_name):
    """The per-frame kernel against the plain version, one launch per
    frame; in f32 (3xTF32) also equal bits on a repeated run and with W_h
    packed beforehand."""
    shape = STEP_CASES[name][0]
    dtype, atol = STEP_TOL[dtype_name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _case(*shape)]
    kernels.reset_launches()
    ys, last = twa_scan(*args)
    torch.cuda.synchronize()
    assert kernel_route(shape, dtype) == "twa_step"
    assert kernels.launches == _launches("twa_step", shape[1])
    ref, ref_last = twa_scan_ref(*args)
    torch.testing.assert_close(ys.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(last.float(), ref_last.float(), atol=atol, rtol=0)
    if dtype == torch.float32:
        again, _ = twa_scan(*args)
        packed, _ = twa_scan(*args, packed=pack_twa_weights(args[2]))
        assert torch.equal(again, ys) and torch.equal(packed, ys)


def test_twa_f32_layout_constants_are_the_kernels(card):
    """The f32 pack's layout constants are the ones the kernel source states."""
    values = [ctypes.c_int() for _ in range(4)]
    _lib().twa_f32_layout(*[ctypes.byref(v) for v in values])
    assert [v.value for v in values] == [twa.F32_CHUNK, twa.F32_COLUMN_BLOCK, twa.F32_K_STEP,
                                         twa.F32_PLANE]


def test_twa_f32_packs_once_per_scan_and_once_for_serving(card, monkeypatch):
    """A scan with a gradient wanted packs W_h once, not once per frame;
    ConvTWA serving packs once and reuses the pack; a pack of the wrong size
    is refused."""
    from iip_uavsal_saliency_tpu_torch.models import recurrent
    from iip_uavsal_saliency_tpu_torch.models.recurrent import ConvTWA

    made = []

    def counting(w_h):
        made.append(w_h.shape)
        return pack_twa_weights(w_h)

    monkeypatch.setattr(twa, "pack_twa_weights", counting)
    monkeypatch.setattr(recurrent, "pack_twa_weights", counting)
    args = [torch.tensor(a, dtype=torch.float32, device=card) for a in _case(1, 5, 6, 7, 16)]
    args[0].requires_grad_()
    kernels.reset_launches()
    ys, _ = twa_scan(*args)
    ys.square().sum().backward()
    assert len(made) == 1 and kernels.launches["twa_step"] == 5
    tm = ConvTWA(16).to(card)
    x = args[0].detach()
    with torch.no_grad():
        first, _ = tm(x, tm.init_state(6, 7, device=card))
        again, _ = tm(x, tm.init_state(6, 7, device=card))
    assert len(made) == 2 and torch.equal(first, again)
    with pytest.raises(ValueError, match="packed W_h"):
        twa_scan(*(a.detach() for a in args), packed=pack_twa_weights(args[2])[:-4])


# The bf16 per-frame kernel (wgmma) at the shapes chip_smoke.py holds it
# at, forced onto it where the persistent kernel would take the shape: the
# flagship frame at V = 1 and V = 4, 720x1280 serving's 90x160 state, the
# ragged C = 24, C = 8, and a width the persistent kernel refuses at
# C = 64 (N and K far below the block's). Against the plain version as above;
# against the persistent kernel (where it takes the shape) within one bf16
# ulp of |h| < 4, as the two bf16 kernels are held in chip_smoke.py.
BF16_STEP_SHAPES = {
    "flagship_v1": (1, 20, 45, 80, 256),
    "flagship_v4": (4, 20, 45, 80, 256),
    "720p_state": (1, 20, 90, 160, 256),
    "ragged": (2, 3, 13, 7, 24),
    "c8": (2, 3, 6, 5, 8),
    "w300_c64": (1, 3, 4, 300, 64),
    "planes128": (1, 20, 45, 80, 128),  # UAVSal(planes=128), forced to the per-frame kernel
}


@pytest.mark.parametrize("name", sorted(BF16_STEP_SHAPES))
def test_twa_bf16_step_kernel_matches_ref(card, name):
    shape = BF16_STEP_SHAPES[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, torch.bfloat16)
            for a in _case(*shape)]
    kernels.reset_launches()
    ys, last = _twa_scan_cuda(*args, route="twa_step")
    torch.cuda.synchronize()
    assert kernels.launches == _launches("twa_step", shape[1])
    ref, ref_last = twa_scan_ref(*args)
    torch.testing.assert_close(ys.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(last.float(), ref_last.float(), atol=2e-2, rtol=0)
    again, _ = _twa_scan_cuda(*args, route="twa_step")
    packed, _ = _twa_scan_cuda(*args, route="twa_step", packed=pack_twa_weights_bf16(args[2]))
    assert torch.equal(again, ys) and torch.equal(packed, ys)
    if clip_takes(shape[3], shape[4]):
        clip, _ = _twa_scan_cuda(*args, route="twa_scan")
        torch.testing.assert_close(ys.float(), clip.float(), atol=2.0 ** -6, rtol=0)


def test_twa_bf16_layout_constants_are_the_kernels(card):
    """The bf16 pack's layout constants are the ones the kernel source states."""
    values = [ctypes.c_int() for _ in range(3)]
    _lib().twa_bf16_layout(*[ctypes.byref(v) for v in values])
    assert [v.value for v in values] == [twa.BF16_CHUNK, twa.BF16_COLUMNS, twa.BF16_PLANE]


def test_twa_bf16_packs_once_per_scan_and_once_for_serving(card, monkeypatch):
    """On the bf16 per-frame route a scan with a gradient wanted packs W_h
    once, not once per frame; a served ConvTWA packs once and reuses the
    pack, and none on the persistent route; a pack of the wrong size is
    refused."""
    from iip_uavsal_saliency_tpu_torch.models import recurrent
    from iip_uavsal_saliency_tpu_torch.models.recurrent import ConvTWA

    made = []

    def counting(w_h):
        made.append(w_h.shape)
        return pack_twa_weights_bf16(w_h)

    monkeypatch.setattr(twa, "pack_twa_weights_bf16", counting)
    monkeypatch.setattr(recurrent, "pack_twa_weights_bf16", counting)
    args = [torch.tensor(a, dtype=torch.float32).to(card, torch.bfloat16)
            for a in _case(1, 5, 6, 7, 24)]
    args[0].requires_grad_()
    kernels.reset_launches()
    ys, _ = twa_scan(*args)
    ys.float().square().sum().backward()
    assert len(made) == 1 and kernels.launches["twa_step"] == 5
    tm = ConvTWA(24).to(card, torch.bfloat16)
    x = args[0].detach()
    with torch.no_grad():
        first, _ = tm(x, tm.init_state(6, 7, dtype=torch.bfloat16, device=card))
        again, _ = tm(x, tm.init_state(6, 7, dtype=torch.bfloat16, device=card))
    assert len(made) == 2 and torch.equal(first, again)
    tm32 = ConvTWA(32).to(card, torch.bfloat16)  # the persistent kernel takes 6x7x32
    x32 = torch.randn(1, 5, 6, 7, 32, device=card).bfloat16()
    with torch.no_grad():
        tm32(x32, tm32.init_state(6, 7, dtype=torch.bfloat16, device=card))
    assert len(made) == 2
    with pytest.raises(ValueError, match="packed W_h"):
        twa_scan(*(a.detach() for a in args), packed=pack_twa_weights_bf16(args[2])[:-8])


CLIP_SHAPES = {
    # (v, s, h, w, c): shapes the persistent kernel takes in bf16
    "flagship_s1": (1, 1, 45, 80, 256),
    "flagship_s2": (1, 2, 45, 80, 256),
    "flagship_s20": (1, 20, 45, 80, 256),
    "flagship_v2": (2, 20, 45, 80, 256),
    "flagship_v4": (4, 20, 45, 80, 256),       # four tiles per block
    "288x512_v1": (1, 20, 36, 64, 256),
    "288x512_v4": (4, 2, 36, 64, 256),
    "ragged_last_tile": (2, 20, 10, 80, 256),  # tiles of 3, 3, 3 and 1 rows
    "narrow_c64": (2, 3, 7, 50, 64),           # tiles of 5 and 2 rows, two slices
    "one_row_tiles": (1, 2, 4, 128, 256),      # the halo tile fits one row only
    "one_pixel": (1, 2, 1, 1, 32),
    "planes128": (1, 20, 45, 80, 128),         # UAVSal(planes=128), as it serves in bf16
}


# bf16 against the plain version: as above, 2e-2 over 20 frames. Against
# the per-frame bf16 kernel: both accumulate in f32 and round once, so they
# differ in summation order (and the gate's last f32 bits) only, which moves
# a stored h_s by one bf16 ulp now and then; h stays below 4, where an ulp is
# 2^-6, and the card showed 2^-7.
@pytest.mark.parametrize("name", sorted(CLIP_SHAPES))
def test_twa_persistent_kernel_matches_ref_and_per_frame_kernel(card, name):
    shape = CLIP_SHAPES[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, torch.bfloat16)
            for a in _case(*shape)]
    assert kernel_route(shape, torch.bfloat16) == "twa_scan"
    kernels.reset_launches()
    ys, last = twa_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches == _launches("twa_scan", shape[1])  # one launch per clip
    ref, ref_last = twa_scan_ref(*args)
    torch.testing.assert_close(ys.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(last.float(), ref_last.float(), atol=2e-2, rtol=0)
    assert torch.equal(last, ys[:, -1])
    again, _ = twa_scan(*args)
    assert torch.equal(again, ys)  # no atomics on data: the same bits every run
    kernels.reset_launches()
    step, _ = _twa_scan_cuda(*args, route="twa_step")
    assert kernels.launches == _launches("twa_step", shape[1])
    torch.testing.assert_close(ys.float(), step.float(), atol=2.0 ** -6, rtol=0)


# The tile height is the kernel source's; Python only gates. The two must
# say the same about which shapes the persistent kernel takes.
@pytest.mark.parametrize("hwc,rows", [((45, 80, 256), 3), ((36, 64, 256), 4), ((7, 50, 64), 5),
                                      ((2, 80, 256), 2), ((4, 128, 256), 1), ((4, 142, 256), 1),
                                      ((4, 143, 256), 0), ((4, 150, 256), 0), ((4, 300, 64), 0),
                                      ((4, 80, 320), 0), ((13, 7, 24), 0), ((1, 1, 32), 1),
                                      ((10, 80, 256), 3)])
def test_twa_gate_agrees_with_the_kernels_tile_rows(card, hwc, rows):
    h, w, c = hwc
    assert _lib().twa_clip_tile_rows(h, w, c) == rows
    assert clip_takes(w, c) == bool(rows)
    for width in range(1, 300, 7):  # and over a sweep of widths and channel counts
        for channels in (32, 64, 128, 256, 288, 320, 24):
            assert clip_takes(width, channels) == bool(
                _lib().twa_clip_tile_rows(4, width, channels)), (width, channels)


# `twa_scan_sharded` of the JAX package: the kernel unchanged on each V
# shard. On one card that is shard invariance: V = 4 gives the bits that
# x[:2] and x[2:] give, on each kernel (f32: the 3xTF32 per-frame one).
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 3, 13, 7, 24), (4, 3, 45, 80, 256)],
                         ids=["ragged", "flagship_width"])
def test_twa_kernel_is_shard_invariant(card, shape, dtype, atol):
    x, gx, w_h, h0 = [torch.tensor(a, dtype=torch.float32).to(card, dtype)
                      for a in _case(*shape)]
    ys, last = twa_scan(x, gx, w_h, h0)
    parts = [twa_scan(x[i:i + 2].contiguous(), gx[i:i + 2].contiguous(), w_h,
                      h0[i:i + 2].contiguous()) for i in (0, 2)]
    assert torch.equal(torch.cat([p[0] for p in parts]), ys)
    assert torch.equal(torch.cat([p[1] for p in parts]), last)
    ref, _ = twa_scan_ref(x, gx, w_h, h0)
    torch.testing.assert_close(ys.float(), ref.float(), atol=atol, rtol=0)


def _halo(t, lo, hi, axis=1):
    """Rows lo - 1 .. hi of t along `axis` (the band and a row each side),
    zeros beyond the map: what a rank of a spatial mesh fetches."""
    h = t.shape[axis]
    parts = [t.narrow(axis, max(lo - 1, 0), min(hi + 1, h) - max(lo - 1, 0))]
    edge = list(t.shape)
    edge[axis] = 1
    if lo == 0:
        parts.insert(0, t.new_zeros(edge))
    if hi == h:
        parts.append(t.new_zeros(edge))
    return torch.cat(parts, axis).contiguous()


# the state's bands on a spatial mesh: 720x1280 over 2 ranks (the per-frame
# kernel in bf16 too: W = 160), 360x640 over 3 (the persistent kernel in bf16)
BAND_SCANS = {"720x1280_over_2": ((1, 3, 90, 160, 256), 2),
              "360x640_over_3": ((1, 3, 45, 80, 256), 3)}


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BAND_SCANS))
def test_twa_kernel_per_frame_on_bands_with_halo_rows(card, name, dtype, atol):
    """K1 as the spatial scan runs it (`models/recurrent.py::ConvTWA._band`):
    a frame at a time, on each band with a row of h_{s-1} each side (zeros
    beyond the image) and zero rows of x and gx there, the band's rows kept;
    the bands cut from a whole map in one process, against the plain scan
    on the whole map, one launch per frame per band."""
    shape, n = BAND_SCANS[name]
    v, s, h, w, c = shape
    x, gx, w_h, h0 = [torch.tensor(a, dtype=torch.float32).to(card, dtype)
                      for a in _case(*shape)]
    ref, ref_last = twa_scan_ref(x, gx, w_h, h0)
    band = -(-h // n)
    route = kernel_route((v, 1, band + 2, w, c), dtype)
    kernels.reset_launches()
    prev, ys = h0, []
    for t in range(s):
        rows = []
        for lo in range(0, h, band):
            hi = min(lo + band, h)
            zero = x.new_zeros((v, 1, 1, w, c))
            x_ext = torch.cat([zero, x[:, t:t + 1, lo:hi], zero], 2)
            g_ext = torch.cat([zero, gx[:, t:t + 1, lo:hi], zero], 2)
            y, _ = twa_scan(x_ext, g_ext, w_h, _halo(prev, lo, hi))
            rows.append(y[:, 0, 1:hi - lo + 1])
        prev = torch.cat(rows, 1)
        ys.append(prev)
    torch.cuda.synchronize()
    got = torch.stack(ys, 1)
    assert dict(kernels.launches) == {**_launches(route, 1), route: s * n}
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)
    assert torch.equal(got[:, -1], prev) and torch.allclose(prev.float(), ref_last.float(),
                                                            atol=atol, rtol=0)


def test_twa_kernel_raises_on_what_it_does_not_take(card):
    """A CUDA tensor launches the kernel or raises; nothing falls back."""
    x, gx, w_h, h0 = [torch.zeros(s, device=card) for s in
                      ((1, 2, 3, 4, 12), (1, 2, 3, 4, 12), (3, 3, 12, 12), (1, 3, 4, 12))]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="C % 8"):
        twa_scan(x, gx, w_h, h0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        twa_scan(*(t[..., :8].half().contiguous() for t in (x, gx)),
                 w_h[:, :, :8, :8].half().contiguous(), h0[..., :8].half().contiguous())
    with pytest.raises(ValueError, match="persistent"):  # f32 is not the persistent kernel's
        _twa_scan_cuda(*(t[..., :8].contiguous() for t in (x, gx)),
                       w_h[:, :, :8, :8].contiguous(), h0[..., :8].contiguous(),
                       route="twa_scan")
    assert kernels.launches["twa_scan"] == 0 and kernels.launches["twa_step"] == 0


def _dw_case(n, h, w, c, e, co, seed=0):
    """Folded-block inputs whose e, d and output are all of order 1."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c) * 0.5, rng.randn(c, e) * np.sqrt(2.0 / c),
            rng.randn(e) * 0.5, rng.randn(3, 3, e) * 0.3, rng.randn(e) * 0.5,
            rng.randn(e, co) * np.sqrt(1.0 / e), rng.randn(co) * 0.5)


DW_SHAPES = {
    # (n, h, w, c, e, co), residual
    "ragged": ((2, 13, 7, 24, 144, 16), False),         # partial tiles, E chunk and Co tile
    "co_differs": ((2, 12, 16, 64, 384, 32), False),
    "residual": ((2, 12, 16, 64, 384, 64), True),
    "one_frame": ((1, 9, 33, 32, 192, 32), True),        # N = 1, three column tiles
    "one_pixel": ((1, 1, 1, 8, 48, 8), True),
    "wide": ((1, 5, 6, 320, 1920, 264), False),          # C at fucbst's width, two Co tiles
    # widths whose last slice of W1 is partial (32 and 64 rows of 128)
    "c160_two_co_tiles": ((2, 12, 20, 160, 960, 320), False),  # features.17
    "c192_four_frames": ((4, 9, 20, 192, 1152, 64), False),    # fucb_layer.0
    "widest": ((1, 9, 17, 352, 2112, 352), True),              # C = MAX_C
    # the flagship widths: st_layer / fust_layer and fucbst_layer.0
    "c256": ((2, 9, 20, 256, 1536, 256), True),
    "c320_to_256": ((1, 11, 18, 320, 1920, 256), False),
    # UAVSal(planes=128): st_layer / fust_layer, fucbst_layer.0 (128 + 32 in)
    "planes128": ((2, 9, 20, 128, 768, 128), True),
    "planes128_fucbst": ((1, 11, 18, 160, 960, 128), False),
}


# f32: the kernel's 3xTF32 products (each within about 2^-21 of the f32
# product) and the plain version's matmuls summed in other orders; outputs
# are of order 1 to 10. bf16: e, d and
# the output are rounded to bf16 at the same points in both, so they differ
# where an f32 sum that differs in its last bits rounds to the other
# neighbour: one bf16 ulp of an output below 16 is 2^-4 = 0.0625.
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 0.0625)])
@pytest.mark.parametrize("name", sorted(DW_SHAPES))
def test_dwblock_kernel_matches_ref(card, name, dtype, atol):
    shape, residual = DW_SHAPES[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _dw_case(*shape)]
    kernels.reset_launches()
    out = fused_dwblock_kernel(*args, residual)
    torch.cuda.synchronize()
    assert kernels.launches["dwblock"] == 1
    ref = dwblock_ref(*args, residual)
    assert out.shape == ref.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


# (n, h, w, c, e, co), residual, bands: the flagship's STBlock width at
# 720x1280 over 2 ranks, and a residual block over 3 uneven bands
DW_BANDS = {"c256_720x1280_over_2": ((2, 90, 160, 256, 1536, 256), True, 2),
            "residual_over_3": ((2, 13, 16, 64, 384, 64), True, 3)}


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 0.0625)])
@pytest.mark.parametrize("name", sorted(DW_BANDS))
def test_dwblock_kernel_on_bands_with_halo_rows(card, name, dtype, atol):
    """K2 as a DWBlock runs it on a spatial mesh (`ops/layers.py::
    DWBlock._band`): each band with a real row of x each side (none beyond
    the image, where the kernel's own padding of its expansion acts), the
    band's rows kept; the bands cut from a whole map in one process,
    against the plain version on the whole map, one launch per band."""
    shape, residual, n = DW_BANDS[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _dw_case(*shape)]
    x, weights = args[0], args[1:]
    h = x.shape[1]
    band = -(-h // n)
    kernels.reset_launches()
    rows = []
    for lo in range(0, h, band):
        hi = min(lo + band, h)
        start = max(lo - 1, 0)
        out = fused_dwblock_kernel(x[:, start:min(hi + 1, h)].contiguous(), *weights, residual)
        rows.append(out[:, lo - start:hi - start])
    torch.cuda.synchronize()
    assert kernels.launches["dwblock"] == n
    ref = dwblock_ref(x, *weights, residual)
    torch.testing.assert_close(torch.cat(rows, 1).float(), ref.float(), atol=atol, rtol=0)


def test_dwblock_layout_constants_are_the_kernels(card):
    """The pack's layout constants are the ones the kernel source states."""
    values = [ctypes.c_int() for _ in range(5)]
    dw._lib().dwblock_bf16_layout(*[ctypes.byref(v) for v in values])
    assert [v.value for v in values] == [dw.CHUNK, dw.SLICE_ROWS, dw.PLANE, dw.COLUMN_BLOCK,
                                         dw.K_STEP]


def test_dwblock_f32_layout_constants_are_the_kernels(card):
    """The f32 pack's layout constants are the ones the kernel source states."""
    values = [ctypes.c_int() for _ in range(5)]
    dw._lib().dwblock_f32_layout(*[ctypes.byref(v) for v in values])
    assert [v.value for v in values] == [dw.CHUNK, dw.F32_SLICE_ROWS, dw.F32_PLANE,
                                         dw.COLUMN_BLOCK, dw.F32_K_STEP]


# The f32 kernel's cases: C=24 (three x slices, fewer than the ring's slots),
# a ragged last E chunk, partial 13x7 and 9x17 tiles, Co=320 over two column
# blocks (the second of 64), each project width (Co 16, 64, 256), the widest C,
# the flagship widths, residual or not.
@pytest.mark.parametrize("name", ["ragged", "co_differs", "c160_two_co_tiles", "widest",
                                  "c256", "c320_to_256", "residual"])
def test_dwblock_f32_kernel_is_deterministic_with_packed_weights(card, name):
    """The 3xTF32 kernel: two runs give equal bits, weights packed
    beforehand give the bits of the wrapper's own packing, and both hold
    the plain version in f32 within 2e-5."""
    shape, residual = DW_SHAPES[name]
    args = [torch.tensor(a, dtype=torch.float32, device=card) for a in _dw_case(*shape, seed=13)]
    blobs = pack_dwblock_weights(*args[1:6])
    kernels.reset_launches()
    first = fused_dwblock_kernel(*args, residual)
    again = fused_dwblock_kernel(*args, residual, blobs)
    torch.cuda.synchronize()
    assert kernels.launches["dwblock"] == 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first, dwblock_ref(*args, residual), atol=2e-5, rtol=0)


# The cases wgmma and the packed weights make new: K padded to 16 (C=24), a
# ragged last E chunk (E=144), a partial 2x13x7 tile, Co=320 over two column
# blocks, the widest C (two ring slots).
@pytest.mark.parametrize("name", ["ragged", "c160_two_co_tiles", "widest", "wide"])
def test_dwblock_bf16_kernel_is_deterministic_with_packed_weights(card, name):
    """Two runs give equal bits, and weights packed beforehand give the bits
    the wrapper's own packing gives."""
    shape, residual = DW_SHAPES[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, torch.bfloat16)
            for a in _dw_case(*shape, seed=9)]
    blobs = pack_dwblock_weights(*args[1:6])
    kernels.reset_launches()
    first = fused_dwblock_kernel(*args, residual)
    again = fused_dwblock_kernel(*args, residual, blobs)
    torch.cuda.synchronize()
    assert kernels.launches["dwblock"] == 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first.float(), dwblock_ref(*args, residual).float(),
                               atol=0.0625, rtol=0)


def test_dwblock_kernel_raises_on_what_it_does_not_take(card):
    """A CUDA tensor launches the kernel or raises; nothing falls back."""
    args = [torch.tensor(a, dtype=torch.float32, device=card)
            for a in _dw_case(1, 4, 4, 16, 96, 16)]
    kernels.reset_launches()
    with pytest.raises(TypeError, match="bf16 or f32"):
        fused_dwblock_kernel(*(a.half() for a in args), True)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_dwblock_kernel(*(torch.tensor(a, dtype=torch.float32, device=card)
                               for a in _dw_case(1, 4, 4, 12, 72, 12)), True)
    with pytest.raises(ValueError, match="C == Co"):
        fused_dwblock_kernel(*args[:5], args[5][:, :8].contiguous(), args[6][:8].clone(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dwblock_kernel(args[0].permute(0, 2, 1, 3), *args[1:], True)
    with pytest.raises(ValueError, match="shared memory"):
        fused_dwblock_kernel(*(torch.tensor(a, dtype=torch.float32, device=card)
                               for a in _dw_case(1, 2, 2, 360, 720, 8)), False)
    with pytest.raises(ValueError, match="must be"):
        fused_dwblock_kernel(args[0], args[1].bfloat16(), *args[2:], True)
    bf = [a.bfloat16() for a in args]
    w1_blob, w2_blob = pack_dwblock_weights(*bf[1:6])
    with pytest.raises(ValueError, match="packed weights"):
        fused_dwblock_kernel(*bf, True, (w1_blob[:-8], w2_blob))
    with pytest.raises(ValueError, match="packed weights"):  # f32 takes its own layout
        fused_dwblock_kernel(*args, True, (w1_blob, w2_blob))
    f32_blobs = pack_dwblock_weights(*args[1:6])
    with pytest.raises(ValueError, match="packed weights"):
        fused_dwblock_kernel(*args, True, (f32_blobs[0], f32_blobs[1][:-4]))
    assert kernels.launches["dwblock"] == 0


def test_kernel_forward_gradients_match_plain_versions(card):
    """`fused_dwblock` and `twa_scan` with the kernel forward in f32: the
    backward recomputes through the plain version, so the gradients of a
    sum of squares agree with autograd through the plain version up to the
    forward's own f32 difference."""
    def grads(fn, arrays):
        args = [torch.tensor(a, dtype=torch.float32, device=card).requires_grad_()
                for a in arrays]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o ** 2).sum() for o in outs).backward()
        return [a.grad for a in args]

    dw = _dw_case(2, 6, 9, 16, 96, 16, seed=3)
    kernels.reset_launches()
    for got, want in zip(grads(lambda *a: fused_dwblock(*a, True), dw),
                         grads(lambda *a: dwblock_ref(*a, True), dw)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    tw = _case(2, 3, 6, 5, 8, seed=5)
    for got, want in zip(grads(twa_scan, tw), grads(twa_scan_ref, tw)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert kernels.launches == {"twa_scan": 0, "twa_step": 3, "dwblock": 1}  # f32: per frame


# ---------------------------------------------------------------------------
# The serving step replayed from a CUDA graph (serving/steps.py::graph_step)

def _seeded_tree(model, seed):
    """A seeded JAX-layout variables tree of `model`'s UAVSal: conv kernels
    with std sqrt(1 / fan_in), BatchNorm statistics of order 1."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, ref in model.state_dict().items():
        if key.endswith("running_var") or (ref.dim() == 1 and key.endswith("weight")):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1:
            a = rng.normal(0.0, 0.1, ref.shape)
        else:
            a = rng.normal(0.0, np.sqrt(1.0 / np.prod(ref.shape[1:])), ref.shape)
        sd[key] = torch.tensor(a, dtype=torch.float32)
    return to_jax_variables(sd, table_of(model))


@pytest.fixture(scope="module")
def seeded_variables():
    """A seeded JAX-layout variables tree of the flagship UAVSal."""
    return _seeded_tree(UAVSal(), 11)


def _served(variables, hw, dtype, k2):
    model = load_model_for_inference(variables, device="cuda", fused_dwblock=k2)
    ho, wo = hw[0] // 8, hw[1] // 8
    rng = np.random.RandomState(12)
    step = make_baked_infer_step(model, get_gauss_priors(ho, wo, 8),
                                 rng.rand(ho, wo, 20).astype(np.float32), compute_dtype=dtype)
    return model, step


def _clips(hw, n, s=20, v=1):
    rng = np.random.RandomState(13)
    return [torch.from_numpy(rng.randint(0, 256, (v, s) + hw + (3,)).astype(np.uint8)).cuda()
            for _ in range(n)]


SERVING_CASES = [(hw, dtype, k2) for hw in ((64, 128), (360, 640))
                 for dtype in (torch.bfloat16, torch.float32) for k2 in (False, True)]


@pytest.mark.parametrize("hw,dtype,k2", SERVING_CASES,
                         ids=[f"{h}x{w}-{str(d)[6:]}-k2{'on' if k else 'off'}"
                              for (h, w), d, k in SERVING_CASES])
def test_graph_step_equals_eager_step(card, seeded_variables, hw, dtype, k2):
    """Three carried clips: the replayed step gives the eager step's bits,
    saliency and state (the kernels, cuDNN's choices and the inputs are the
    same; only the issue differs). A replay of the same input twice gives
    the same bits, and N replays run N times one eager step's launches:
    the graph's own kernel nodes and the step's tally exactly, and a
    profiler trace shows each of those kernels (`kernels.trace_shows_graph`:
    the profiler drops records), while the wrappers count none."""
    model, step = _served(seeded_variables, hw, dtype, k2)
    graphed = graph_step(step)
    eager_state = graphed_state = model.init_state(*hw, 1, dtype=dtype, device=card)
    clips = _clips(hw, 3)
    for k, x in enumerate(clips):
        want, eager_state = step(x, eager_state)
        got, graphed_state = graphed(x, graphed_state)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"clip {k}: saliency differs"
        assert torch.equal(graphed_state, eager_state), f"clip {k}: state differs"
        assert torch.isfinite(got).all() and got.std() > 0
    first = [t.clone() for t in graphed(clips[0], eager_state)]
    again = graphed(clips[0], eager_state)
    assert all(torch.equal(a, b) for a, b in zip(first, again))

    kernels.reset_launches()
    step(clips[0], eager_state)
    one = dict(kernels.launches)
    assert one["twa_scan" if dtype == torch.bfloat16 else "twa_step"] > 0
    assert (one["dwblock"] > 0) == k2
    kernels.reset_launches()
    tally = dict(graphed.replayed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            graphed(clips[0], eager_state)
        torch.cuda.synchronize()
    assert graphed.graph_launches() == one
    traced = kernels.traced_launches(prof)
    assert kernels.trace_shows_graph(traced, one, 4), traced
    assert not any(kernels.launches.values())
    assert {k: n - tally[k] for k, n in graphed.replayed.items()} == {
        name: 4 * n for name, n in one.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_twa_kernel_on_a_resnet50_uavsal_convtwa_input(card, dtype, monkeypatch):
    """K1 on what ConvTWA of a ResNet-50 UAVSal gives it: seeded weights,
    360x640, S=20, the second of two carried clips (so h_{s-1} starts from
    the first clip's state), through the served step; the arguments of the
    scan are taken from the model. Against `twa_scan_ref` computed in f32
    on those arguments: f32 within 1e-5, bf16 within 2e-2 (the plain
    version's per-frame rounding that the kernel does not do), each scaled
    by the largest |h| where it exceeds 1 (ResNet-50's state runs larger
    than the flagship's), and one launch per clip (bf16) or frame (f32)."""
    from iip_uavsal_saliency_tpu_torch.models import recurrent

    tree = _seeded_tree(UAVSal(cnn_type="resnet50"), 14)
    model = load_model_for_inference(tree, device="cuda", cnn_type="resnet50")
    rng = np.random.RandomState(15)
    step = make_baked_infer_step(model, get_gauss_priors(45, 80, 8),
                                 rng.rand(45, 80, 20).astype(np.float32), compute_dtype=dtype)
    taken = []

    def recorder(*args, **kwargs):
        out = twa_scan(*args, **kwargs)
        taken.append(([a.clone() for a in args], [o.clone() for o in out]))
        return out

    monkeypatch.setattr(recurrent, "twa_scan", recorder)
    state = model.init_state(360, 640, 1, dtype=dtype, device=card)
    clips = _clips((360, 640), 2)
    _, state = step(clips[0], state)
    kernels.reset_launches()
    step(clips[1], state)
    torch.cuda.synchronize()
    shape = (1, 20, 45, 80, 256)
    route = kernel_route(shape, dtype)
    assert route == ("twa_scan" if dtype == torch.bfloat16 else "twa_step")
    assert kernels.launches == _launches(route, 20)
    (x, gx, w_h, h0), (ys, last) = taken[1]
    assert tuple(x.shape) == shape and h0.abs().max() > 0
    exact, exact_last = twa_scan_ref(*(a.float() for a in (x, gx, w_h, h0)))
    top = max(exact.abs().max().item(), 1.0)
    atol = (2e-2 if dtype == torch.bfloat16 else 1e-5) * top
    torch.testing.assert_close(ys.float(), exact, atol=atol, rtol=0)
    torch.testing.assert_close(last.float(), exact_last, atol=atol, rtol=0)


def test_graph_step_counts_warmup_and_capture_launches_and_not_the_replay(card,
                                                                           seeded_variables):
    """The wrappers count the warm-up calls' launches and those the capture
    records into the graph; the replay runs without them."""
    model, step = _served(seeded_variables, (64, 128), torch.bfloat16, True)
    state = model.init_state(64, 128, 1, dtype=torch.bfloat16, device=card)
    x = _clips((64, 128), 1)[0]
    kernels.reset_launches()
    step(x, state)
    one = dict(kernels.launches)
    kernels.reset_launches()
    graphed = graph_step(step)
    graphed(x, state)  # warm-up calls, the capture, one replay
    assert kernels.launches == {name: (WARMUP_CALLS + 1) * n for name, n in one.items()}
    assert graphed.replayed == one


@pytest.mark.parametrize("k2", [False, True])
def test_pipelined_runner_graphed_equals_eager(card, seeded_variables, k2):
    """`predict_videos` with the graphed step and with the eager one: equal
    maps, V=2 in lock-step with a ragged tail and an exhausted video."""
    model, step = _served(seeded_variables, (64, 128), torch.bfloat16, k2)
    rng = np.random.RandomState(14)
    videos = [rng.randint(0, 256, (n, 64, 128, 3)).astype(np.uint8) for n in (45, 15, 30)]
    sizes = [(72, 96), (100, 60), (64, 128)]
    graphed = graph_step(step)
    runs = [predict_videos(s, model, videos, sizes, videos_per_batch=2)
            for s in (step, graphed, graphed)]
    for maps in runs[1:]:
        for got, want in zip(maps, runs[0]):
            assert got.shape == want.shape and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The ablation zoo served: no zoo model but `uavsal` runs K1 or K2

# (model_name, st_type): the 8 other names and the orderings of
# `uavsal_stblocks_type`
ZOO_CASES = [(n, "st") for n in ("uavsal_spconv", "uavsal_teconv", "uavsal_stblocks",
                                 "uavsal_stblocks_type", "uavsal_stc3d", "uavsal_stc2_3d",
                                 "uavsal_mp", "uavsal_lstm")] + [
    ("uavsal_stblocks_type", st) for st in ("s2t", "t2s", "s_s2t")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,st_type", ZOO_CASES,
                         ids=[n + ("" if st == "st" else f"-{st}") for n, st in ZOO_CASES])
def test_zoo_graph_step_equals_eager_step_without_k1_or_k2(card, name, st_type, dtype):
    """A zoo model on seeded weights served at 64x128: over two carried
    clips the replayed step gives the eager step's bits (saliency and
    state: ConvLSTM's, or the dummy passed through unchanged); the eager
    step launches neither K1 nor K2, and the graph holds no node of
    either."""
    from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model

    with torch.device("meta"):
        shape_of = build_adapted_model(name, filter_kwargs=True, st_type=st_type)
    tree = _seeded_tree(shape_of, 16)
    model = load_model_for_inference(tree, device="cuda", model_name=name, st_type=st_type)
    rng = np.random.RandomState(17)
    step = make_baked_infer_step(model, get_gauss_priors(8, 16, 8),
                                 rng.rand(8, 16, 20).astype(np.float32), compute_dtype=dtype)
    graphed = graph_step(step)
    eager_state = graphed_state = model.init_state(64, 128, 1, dtype=dtype, device=card)
    for k, x in enumerate(_clips((64, 128), 2)):
        kernels.reset_launches()
        want, eager_state = step(x, eager_state)
        torch.cuda.synchronize()
        assert not any(kernels.launches.values()), kernels.launches
        got, graphed_state = graphed(x, graphed_state)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"clip {k}: saliency differs"
        assert torch.equal(graphed_state, eager_state), f"clip {k}: state differs"
        assert torch.isfinite(got).all() and got.std() > 0
        assert 0 <= got.min().item() and got.max().item() <= 1
    assert not any(graphed.graph_launches().values())
    if name == "uavsal_lstm":
        assert eager_state.shape == (1, 2, 8, 16, 256) and eager_state.abs().max() > 0
    else:
        assert eager_state.shape == (1, 8, 8, 1) and not eager_state.any()


# ---------------------------------------------------------------------------
# Training: K1 and its gradient under autograd, and the train step's launches

# relative L2 of each gradient against autograd through the plain version:
# f32 differs by the kernel's own summation order; bf16 by K1 keeping the
# conv and gate in f32 where the plain version rounds them to bf16 every
# frame (the backward is the same recompute, fed grad_ys = 2 ys)
TRAIN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 10, 45, 80, 256), (2, 5, 13, 7, 24)],
                         ids=["flagship", "ragged"])
def test_twa_scan_under_autograd_matches_ref(card, shape, dtype):
    """`twa_scan` as a train step runs it (kernel forward on the route its
    gate picks, backward recomputed through `twa_scan_ref`) against autograd
    through `twa_scan_ref`, for a sum of squares of ys and h_last; h0 is
    carried data and takes no gradient."""
    arrays = _case(*shape, seed=21)

    def grads(fn):
        args = [torch.tensor(a, dtype=torch.float32, device=card).to(dtype) for a in arrays]
        for a in args[:3]:
            a.requires_grad_()
        ys, h_last = fn(*args)
        ((ys.float() ** 2).sum() + (h_last.float() ** 2).sum()).backward()
        assert args[3].grad is None
        return [a.grad.float() for a in args[:3]]

    route = kernel_route(shape, dtype)
    assert route == ("twa_scan" if dtype == torch.bfloat16 and shape[-1] == 256 else "twa_step")
    kernels.reset_launches()
    got = grads(twa_scan)
    assert kernels.launches == _launches(route, shape[1])
    want = grads(twa_scan_ref)
    for name, g, w in zip(("x", "gx", "w_h"), got, want):
        err = ((g - w).norm() / w.norm()).item()
        assert err <= TRAIN_GRAD_TOL[dtype], (name, err)


def _train_batch(card, h=64, w=128, s=10, seed=31):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (1, s, h, w, 3)).astype(np.uint8)).to(card)
    y = (rng.rand(1, s, h // 8, w // 8, 2) > 0.7).astype(np.float32)
    y[:, :, 1, 1] = 1.0
    gauss = torch.from_numpy(get_gauss_priors(h // 8, w // 8, 8)).to(card)
    ob = torch.from_numpy(rng.rand(h // 8, w // 8, 20).astype(np.float32)).to(card)
    return x, gauss, ob, torch.from_numpy(y).to(card)


@pytest.mark.parametrize("fused", [False, True], ids=["k2_off", "k2_on"])
def test_train_step_launches(card, fused):
    """One train step launches K1 once (bf16 mixed: the persistent kernel)
    or once per frame (f32), and K2 never, even on a model built with the
    fused dwBlock on: the kernel is refused in train mode. The eval step of
    that model, in eval mode, does take K2."""
    from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state,
                                                             make_eval_step, make_train_step)

    x, gauss, ob, y = _train_batch(card)
    for dtype, want in ((torch.bfloat16, {"twa_scan": 1, "twa_step": 0, "dwblock": 0}),
                        (None, {"twa_scan": 0, "twa_step": 10, "dwblock": 0})):
        model = init_model(UAVSal(fused_dwblock=fused), torch.Generator().manual_seed(0))
        model.to(card, memory_format=torch.channels_last)
        state = create_train_state(model, make_optimizer(model))
        step = make_train_step(state, compute_dtype=dtype)
        rnn = model.init_state(64, 128, device=card)
        for _ in range(2):
            kernels.reset_launches()
            loss, rnn = step(x, gauss, ob, rnn, y)
            torch.cuda.synchronize()
            assert kernels.launches == want, (dtype, kernels.launches)
            assert torch.isfinite(loss) and rnn.dtype == torch.float32 and rnn.grad_fn is None
    kernels.reset_launches()
    make_eval_step(model)(x, gauss, ob, rnn, y)
    torch.cuda.synchronize()
    assert kernels.launches["twa_step"] == 10 and (kernels.launches["dwblock"] > 0) == fused


def _lockstep_step(card, dtype, remat=False, scan=None, contexts=None):
    """One train step of the flagship (seed 0, every parameter trained) at
    64x128 on two videos in lock-step, S=10 each, video 1's last 5 frames a
    ragged clip's padding (mask 0), the trainer's masked loss: (loss,
    gradients, BatchNorm buffers, new state, launches). `scan` replaces
    ConvTWA's scan, `contexts` the remat's recompute contexts."""
    from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model
    from iip_uavsal_saliency_tpu_torch.training import steps
    from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss

    (x0, gauss, ob, y0), (x1, _, _, y1) = _train_batch(card, seed=31), _train_batch(card, seed=32)
    x, y = torch.cat([x0, x1]), torch.cat([y0, y1])
    mask = torch.ones_like(y[..., :1])
    x[1, 5:], y[1, 5:], mask[1, 5:] = x[1, 4], y[1, 4], 0.0
    model = init_model(UAVSal(), torch.Generator().manual_seed(0))
    model.to(card, memory_format=torch.channels_last)
    if scan is not None:
        model.rnn.scan = scan
    state = steps.create_train_state(model, make_optimizer(model))
    if contexts is not None:
        original, steps._recompute_contexts = steps._recompute_contexts, contexts
    try:
        step = steps.make_train_step(state, _masked_loss(loss_fu), dtype, remat=remat)
        kernels.reset_launches()
        loss, rnn = step(x, gauss, ob, model.init_state(64, 128, 2, device=card),
                         torch.cat([y, mask], -1))
        torch.cuda.synchronize()
    finally:
        if contexts is not None:
            steps._recompute_contexts = original
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    bufs = {n: b.double() for n, b in model.named_buffers()}
    return float(loss), grads, bufs, rnn.double(), dict(kernels.launches)


def _grad_error(a, b):
    """Relative L2 of gradient set a against b over the whole model."""
    return (sum(((a[n] - b[n]) ** 2).sum() for n in b) / sum((b[n] ** 2).sum() for n in b)
            ).sqrt().item()


# two videos a step against the plain scan on the card: the bounds of
# chip_smoke.py's training phase (TOL_TRAIN_K1_* in f32, TOL_TRAIN_BF16_*)
LOCKSTEP_TOL = {None: (1e-6, 2e-4, 1e-4), torch.bfloat16: (3e-4, 0.2, 0.3)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_two_video_train_step_k1_against_plain(card, dtype):
    """At V=2 the bf16 mixed step launches the persistent K1 once (its grid
    loops over V) and the f32 step the per-frame kernel once a frame (grid
    z = V), K2 never; loss, gradient and carried state agree with the same
    step through the plain scan."""
    k1 = _lockstep_step(card, dtype)
    plain = _lockstep_step(card, dtype, scan=twa_scan_ref)
    route = "twa_scan" if dtype else "twa_step"
    assert k1[4] == _launches(route, 10) and not any(plain[4].values())
    tol_loss, tol_grad, tol_state = LOCKSTEP_TOL[dtype]
    assert abs(k1[0] - plain[0]) <= tol_loss * abs(plain[0])
    assert _grad_error(k1[1], plain[1]) <= tol_grad
    assert (k1[3] - plain[3]).abs().max().item() <= tol_state
    assert k1[3].shape == (2, 8, 16, 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_remat_step_launches_k1_twice_and_moves_bn_stats_once(card, dtype):
    """With remat the recompute runs K1's forward again in the backward
    (bf16: 2 launches of the persistent kernel; f32: 2 per frame); the
    loss, the carried state and the BatchNorm stats are the plain step's,
    the gradient within the JAX package's remat bound (2e-2 relative L2).
    A recompute let move the stats (the context off) moves them twice."""
    import contextlib

    plain = _lockstep_step(card, dtype)
    remat = _lockstep_step(card, dtype, remat=True)
    route = "twa_scan" if dtype else "twa_step"
    assert remat[4] == {k: 2 * n for k, n in _launches(route, 10).items()}
    assert abs(remat[0] - plain[0]) <= 1e-6 * abs(plain[0])
    assert (remat[3] - plain[3]).abs().max().item() <= 1e-6 * plain[3].abs().max().item()
    for n, b in plain[2].items():
        assert (remat[2][n] - b).abs().max().item() <= 1e-6 * b.abs().max().item(), n
    assert _grad_error(remat[1], plain[1]) <= 2e-2
    twice = _lockstep_step(card, dtype, remat=True,
                           contexts=lambda: (contextlib.nullcontext(), contextlib.nullcontext()))
    moved = max(((twice[2][n] - b).abs().max() / b.abs().max()).item()
                for n, b in plain[2].items())
    assert moved > 1e-3, moved


# Evaluation on the card (no kernel of ours: ATen's sort, cumsum, gathers
# and reductions), held to the same functions on the CPU at the size users
# evaluate, 720x1280, N=8.
EVAL_N, EVAL_H, EVAL_W = 8, 720, 1280


def _eval_frames(seed, levels=None):
    """(pred (N, H, W, 1), true (N, H, W, 2)) f32: a smooth blob plus noise,
    ~40 fixations around its centre and their blurred map; `levels`
    quantizes the saliency to that many uint8 values (ties)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.arange(EVAL_H)[:, None] / EVAL_H, np.arange(EVAL_W)[None, :] / EVAL_W
    pred = np.empty((EVAL_N, EVAL_H, EVAL_W, 1), np.float32)
    true = np.zeros((EVAL_N, EVAL_H, EVAL_W, 2), np.float32)
    for i in range(EVAL_N):
        cy, cx = rng.uniform(0.3, 0.7, 2)
        blob = np.exp(-((ys - cy) / 0.2) ** 2) * np.exp(-((xs - cx) / 0.2) ** 2)
        p = blob + 0.3 * rng.rand(EVAL_H, EVAL_W)
        if levels:
            p = np.floor(p / p.max() * (levels - 0.001)) * (255 // levels)
        pred[i, ..., 0] = p
        py = np.clip(rng.normal(cy, 0.1, 40) * EVAL_H, 0, EVAL_H - 1).astype(int)
        px = np.clip(rng.normal(cx, 0.1, 40) * EVAL_W, 0, EVAL_W - 1).astype(int)
        true[i, py, px, 1] = 1.0
        true[i, ..., 0] = np.exp(-((ys - cy) / 0.1) ** 2) * np.exp(-((xs - cx) / 0.1) ** 2)
    return pred, true


def test_eval_metrics_card_equals_cpu(card):
    """KLD, CC, NSS, SIM, the unjittered AUC-Judd and both sweeps (Borji's
    uniform negatives and a shuffled-like set with fewer valid rows) on the
    card against the CPU on the same inputs, within 1e-5 (f32 sums in other
    orders)."""
    from iip_uavsal_saliency_tpu_torch.evaluation import metrics_torch as mt
    from iip_uavsal_saliency_tpu_torch.evaluation.scorer import _device_metrics

    pred, true = _eval_frames(0)
    rng = np.random.RandomState(1)
    n_fix = (true[..., 1] > 0.5).reshape(EVAL_N, -1).sum(1).astype(np.int32)
    sweeps = [(rng.randint(0, EVAL_H * EVAL_W, (EVAL_N, 256, 100)).astype(np.int32), n_fix),
              (rng.randint(0, EVAL_H * EVAL_W, (EVAL_N, 256, 100)).astype(np.int32),
               np.minimum(n_fix, 17).astype(np.int32))]
    results = {}
    for dev in ("cpu", card):
        p, t = torch.from_numpy(pred).to(dev), torch.from_numpy(true).to(dev)
        rows = [_device_metrics(p, t, None)]
        rows += [mt.eval_auc_sweep(p, t, torch.from_numpy(i).to(dev),
                                   torch.from_numpy(v).to(dev))[None] for i, v in sweeps]
        results[str(dev)] = torch.cat(rows).cpu().numpy()
    got, want = results[str(card)], results["cpu"]
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eval_jittered_auc_judd_on_tied_uint8_matches_numpy(card):
    """AUC-Judd with the card's random tie order on a 16-level 720x1280 map
    against `auc_judd_np`'s 1e-7 jitter in f64: the means over 24 seeds
    agree within noise, as the CPU test holds the CPU's."""
    from iip_uavsal_saliency_tpu_torch.evaluation.metrics_np import auc_judd_np
    from iip_uavsal_saliency_tpu_torch.evaluation.metrics_torch import eval_auc_judd

    pred, true = _eval_frames(2, levels=16)
    p, t = torch.from_numpy(pred[:1]).to(card), torch.from_numpy(true[:1]).to(card)
    n_seeds = 24
    dev = np.array([eval_auc_judd(p, t, generator=torch.Generator(device=card).manual_seed(s))
                    .item() for s in range(n_seeds)])
    ref = np.array([auc_judd_np(pred[0, ..., 0], true[0, ..., 1], jitter=True,
                                rng=np.random.RandomState(100 + s)) for s in range(n_seeds)])
    assert dev.std() > 0, "the jitter had no effect"
    np.testing.assert_allclose(dev.mean(), ref.mean(),
                               atol=3 * ref.std() / np.sqrt(n_seeds) + 1e-3)


def test_eval_score_video_on_the_card_draws_as_on_the_cpu(card):
    """`_score_video` on the card and on the CPU from the same seed: the
    RandomState ends in the same state, and every column but the jittered
    AUC-Judd agrees within 1e-5 (20 frames in batches of 8, the last
    padded)."""
    from iip_uavsal_saliency_tpu_torch.evaluation.scorer import KEYS_ORDER, _score_video

    pred, true = _eval_frames(3, levels=32)
    sal = np.concatenate([pred, pred, pred[:4]]).astype(np.uint8)
    gt = np.concatenate([true, true, true[:4]])
    salmap = sal.transpose(1, 2, 3, 0)
    fixmap = (gt[..., :1] * 255).round().astype(np.uint8).transpose(1, 2, 3, 0)
    fixpts = gt[..., 1:].astype(np.uint8).transpose(1, 2, 3, 0)
    rng = np.random.RandomState(4)
    fix_pool = [np.stack([rng.rand(40), rng.rand(40)], 1) for _ in range(30)]
    rngs = np.random.RandomState(5), np.random.RandomState(5)
    on_card = _score_video(salmap, fixmap, fixpts, fix_pool, KEYS_ORDER, 8, rngs[0], device=card)
    on_cpu = _score_video(salmap, fixmap, fixpts, fix_pool, KEYS_ORDER, 8, rngs[1], device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(rngs[0].get_state(), rngs[1].get_state()))
    other = [k for k, key in enumerate(KEYS_ORDER) if key != "AUC_Judd"]
    assert np.isfinite(on_card).all()
    np.testing.assert_allclose(on_card[:, other], on_cpu[:, other], rtol=0, atol=1e-5)


# The image stage (the reference recipe's SALICON stage) runs no kernel of
# ours; its steps are held card against CPU, and the video model it warm
# starts launches K1 as any train step does.
IMG_H, IMG_W = 128, 160


def _image_batch(seed=41, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (b, IMG_H, IMG_W, 3)).astype(np.uint8)
    y = np.concatenate([rng.rand(b, IMG_H // 8, IMG_W // 8, 1),
                        rng.rand(b, IMG_H // 8, IMG_W // 8, 1) < 0.1], -1).astype(np.float32)
    y[:, 2, 3, 1] = 1.0
    return torch.from_numpy(x), torch.from_numpy(y)


def _image_start():
    from iip_uavsal_saliency_tpu_torch.models.srfnet_image import SRFNetImage
    from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model

    return init_model(SRFNetImage(), torch.Generator().manual_seed(0))


def test_image_train_step_card_equals_cpu(card):
    """One f32 image train step (TF32 off) on the card against the CPU from
    the same weights: the loss within 1e-4 relative, the gradient within
    0.1 relative L2 and the BatchNorm stats within 1e-4 of their scale
    (tests/test_torch_train_step.py's bounds), no launch of K1 or K2."""
    import copy

    from iip_uavsal_saliency_tpu_torch.ops.layers import to_channels_last
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state,
                                                             make_image_train_step)

    start, (x, y) = _image_start(), _image_batch()
    runs = {}
    for device in ("cpu", "cuda"):
        model = to_channels_last(copy.deepcopy(start), device)
        step = make_image_train_step(create_train_state(model, make_optimizer(model)))
        kernels.reset_launches()
        loss = step(x.to(device), y.to(device))
        assert not any(kernels.launches.values()), kernels.launches
        runs[device] = (float(loss), {n: p.grad.double().cpu() for n, p in model.named_parameters()},
                        {n: b.double().cpu() for n, b in model.named_buffers()})
    (lc, gc, bc), (lg, gg, bg) = runs["cpu"], runs["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc), (lg, lc)
    num = sum(((gg[n] - gc[n]) ** 2).sum() for n in gc)
    assert (num / sum((g ** 2).sum() for g in gc.values())).sqrt() <= 0.1
    for n in bc:
        scale = bc[n].abs().max() + (bc[n[:-4] + "var"].max().sqrt() if n.endswith("mean") else 0)
        assert (bg[n] - bc[n]).abs().max() <= 1e-4 * scale, n


def test_predict_images_card_equals_cpu(card):
    """The image runner's device part, eval form with BatchNorm folded, on
    the card and on the CPU from the same weights: uint8 maps at the native
    sizes within one level."""
    from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables
    from iip_uavsal_saliency_tpu_torch.runners.infer_images import (load_image_model,
                                                                    predict_images)

    start = _image_start()
    tree = to_jax_variables(start.state_dict(), table_of(start))
    x, _ = _image_batch(b=3)
    sizes = [(IMG_H, IMG_W), (100, 90), (300, 420)]
    got = predict_images(load_image_model(tree, device="cuda"), x.to("cuda"), sizes)
    want = predict_images(load_image_model(tree, device="cpu"), x, sizes)
    for a, b, size in zip(got, want, sizes):
        assert a.shape == b.shape == size and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("mixed", [True, False], ids=["bf16", "f32"])
def test_transplanted_video_train_step_launches(card, mixed, tmp_path):
    """The video Trainer warm started from an image-stage tree (the neck
    transplanted): each train step launches K1 once (bf16 mixed, the
    persistent kernel) or once per frame (f32), K2 never, and the frozen
    neck's parameters keep the image stage's bits."""
    from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables
    from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer

    start = _image_start()
    tree = to_jax_variables(start.state_dict(), table_of(start))
    rng = np.random.RandomState(43)
    frames = rng.randint(0, 256, (10, 64, 128, 3)).astype(np.uint8)
    maps = rng.randint(0, 256, (10, 8, 16, 1)).astype(np.uint8)
    fixs = (rng.rand(10, 8, 16, 1) < 0.1).astype(np.uint8)
    fixs[:, 2, 3] = 1
    cfg = TrainConfig(iosize=(64, 128, 8, 16), mixed_precision=mixed, epochs=1)
    trainer = Trainer(cfg, "", "synthetic", str(tmp_path), device="cuda",
                      ob_prior=rng.rand(8, 16, 20).astype(np.float32), pre_variables=tree,
                      videos={"train": [("v", frames, maps, fixs)], "val": []})
    (xc, yc), = trainer._clips(frames, maps, fixs)
    rnn = trainer.model.init_state(64, 128, device=card)
    want = ({"twa_scan": 1, "twa_step": 0, "dwblock": 0} if mixed
            else {"twa_scan": 0, "twa_step": 10, "dwblock": 0})
    for _ in range(2):
        kernels.reset_launches()
        loss, rnn = trainer.train_step(torch.from_numpy(xc)[None].to(card), trainer.gauss,
                                       trainer.ob, rnn, torch.from_numpy(yc)[None].to(card))
        torch.cuda.synchronize()
        assert kernels.launches == want and torch.isfinite(loss)
    params = dict(trainer.model.named_parameters())
    for key, value in start.state_dict().items():
        if key.startswith("sfnet.") and "running" not in key:
            assert torch.equal(params[key].detach().cpu(), value), key


OP_CASES = {
    # name: (x shape, dtype, route the op's CUDA implementation takes)
    "k1_persistent_bf16": ((1, 20, 45, 80, 256), torch.bfloat16, "twa_scan"),
    "k1_step_f32": ((1, 5, 45, 80, 256), torch.float32, "twa_step"),
    "k1_step_bf16_ragged": ((2, 5, 13, 7, 24), torch.bfloat16, "twa_step"),
    "k1_step_f32_ragged": ((2, 5, 13, 7, 24), torch.float32, "twa_step"),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_twa_custom_op_equals_the_wrapper(card, name):
    """`uavsal::twa_scan` on the card is the wrapper it registers: the same
    bits as `_twa_scan_cuda` on the same inputs (with W_h packed beforehand
    too, on the per-frame route), and the same launches, counted once per
    launch by the wrapper."""
    shape, dtype, route = OP_CASES[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _case(*shape)]
    assert kernel_route(shape, dtype) == route
    packs = [None]
    if route == "twa_step":
        packs.append((pack_twa_weights_bf16 if dtype == torch.bfloat16
                      else pack_twa_weights)(args[2]))
    for packed in packs:
        kernels.reset_launches()
        ys, last = torch.ops.uavsal.twa_scan(*args, packed)
        torch.cuda.synchronize()
        assert kernels.launches == _launches(route, shape[1])
        want, want_last = _twa_scan_cuda(*args, packed=packed)
        assert torch.equal(ys, want) and torch.equal(last, want_last)
        assert kernels.launches == {k: 2 * n for k, n in _launches(route, shape[1]).items()}
        got, got_last = twa_scan(*args, packed=packed)
        assert torch.equal(got, want) and torch.equal(got_last, want_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["ragged", "c256", "c320_to_256"])
def test_dwblock_custom_op_equals_the_wrapper(card, name, dtype):
    """`uavsal::dwblock` on the card is the wrapper it registers: the bits
    of `fused_dwblock_kernel` on the same inputs, with and without packed
    weights, one launch per call."""
    shape, residual = DW_SHAPES[name]
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _dw_case(*shape)]
    blobs = pack_dwblock_weights(*args[1:6])
    for packed in (None, blobs):
        kernels.reset_launches()
        out = torch.ops.uavsal.dwblock(*args, residual, *(packed or (None, None)))
        torch.cuda.synchronize()
        assert kernels.launches["dwblock"] == 1
        want = fused_dwblock_kernel(*args, residual, packed)
        assert torch.equal(out, want)
        assert torch.equal(fused_dwblock(*args, residual, packed), want)
        assert kernels.launches["dwblock"] == 3


ARTIFACT_CASES = [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)]


@pytest.mark.parametrize("dtype,k2", ARTIFACT_CASES,
                         ids=[f"{str(d)[6:]}-k2{'on' if k else 'off'}" for d, k in ARTIFACT_CASES])
def test_artifact_graphed_equals_eager_and_the_live_step(card, seeded_variables, dtype, k2,
                                                         tmp_path):
    """A 64x128 artifact exported on the card (`runners/export.py`), saved
    and loaded: over three carried clips it launches what the live step
    launches, its graphed replay gives its eager bits, and both give the
    live baked step's bits on the same weights."""
    from iip_uavsal_saliency_tpu_torch.runners.export import (ExportedServing, export_serving,
                                                              save_exported)

    hw = (64, 128)
    rng = np.random.RandomState(12)
    gauss, ob = get_gauss_priors(8, 16, 8), rng.rand(8, 16, 20).astype(np.float32)
    model = load_model_for_inference(seeded_variables, device="cuda", fused_dwblock=k2)
    program, meta = export_serving(model, iosize=hw + (8, 16), batch_size=4, gauss=gauss,
                                   ob=ob, compute_dtype=dtype if dtype != torch.float32 else None)
    assert meta["platforms"] == ["cuda"]
    save_exported(str(tmp_path / "a.aot"), program, meta)
    art = ExportedServing(str(tmp_path / "a.aot"))
    _, live = _served(seeded_variables, hw, dtype, k2)
    clips = _clips(hw, 3)
    state = art.init_state(*hw, 1)
    live_state = state.clone()
    kernels.reset_launches()
    eager = []
    for x in clips:
        out, state = art(x, state)
        eager.append((out.clone(), state.clone()))
    torch.cuda.synchronize()
    counted = dict(kernels.launches)
    kernels.reset_launches()
    for k, x in enumerate(clips):
        want, live_state = live(x, live_state)
        assert torch.equal(eager[k][0], want) and torch.equal(eager[k][1], live_state), k
    assert counted == kernels.launches
    assert (counted["dwblock"] > 0) == k2
    assert counted["twa_scan" if dtype == torch.bfloat16 else "twa_step"] > 0
    graphed = graph_step(art)
    state = art.init_state(*hw, 1)
    for k, x in enumerate(clips):
        out, state = graphed(x, state)
        assert torch.equal(out, eager[k][0]) and torch.equal(state, eager[k][1]), k
    assert graphed.graph_launches() == {name: n // 3 for name, n in counted.items()}


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ranks", ["none", "nccl"])
@pytest.mark.parametrize("parts", [1, 2])
def test_cross_rank_batch_norm_at_one_rank_equals_batch_norm(card, dtype, atol, ranks, parts,
                                                             tmp_path):
    """`parallel/batchnorm.py` on CUDA tensors at one rank (no group, and a
    one-rank NCCL group, whose collectives then run), the batch reduced
    whole or as two parts, against `F.batch_norm` in train mode: the
    output, the gradients of x, the scale and the bias, and the running
    stats after, on a channels-last (N, C, H, W) batch with a mean far
    above its spread (as after ReLU6)."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from iip_uavsal_saliency_tpu_torch.parallel import cross_rank_batch_norm, init_ranks

    group = init_ranks(0, 1, "nccl", str(tmp_path / "rendezvous"), "cuda") \
        if ranks == "nccl" else None
    try:
        rng = np.random.RandomState(4)
        x0 = torch.tensor(rng.rand(6, 40, 23, 17) * 0.3 + 4.0, dtype=torch.float32)
        x0 = x0.to(card, dtype).contiguous(memory_format=torch.channels_last)
        w0 = torch.tensor(rng.rand(40) + 0.5, dtype=torch.float32, device=card)
        b0 = torch.tensor(rng.randn(40) * 0.1, dtype=torch.float32, device=card)
        dy = torch.tensor(rng.randn(6, 40, 23, 17), dtype=torch.float32).to(card, dtype)
        out = {}
        for how in ("ours", "torch"):
            x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
            stats = (torch.zeros(40, device=card), torch.ones(40, device=card))
            if how == "ours":
                y = cross_rank_batch_norm(x, w, b, *stats, 0.1, 1e-5, group, parts)
            else:
                y = F.batch_norm(x, *stats, w, b, True, 0.1, 1e-5)
            y.backward(dy)
            out[how] = (y.float(), x.grad.float(), w.grad, b.grad, *stats)
        for name, a, ref in zip(("y", "dx", "dw", "db", "mean", "var"), out["ours"],
                                out["torch"]):
            scale = max(ref.abs().max().item(), 1.0)
            assert (a - ref).abs().max().item() <= atol * scale, name
    finally:
        if group is not None:
            dist.destroy_process_group()
