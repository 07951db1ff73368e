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
from iip_uavsal_saliency_tpu_torch.ops.twa import (_lib, _twa_scan_cuda, clip_takes,
                                                    kernel_route, twa_scan, twa_scan_ref)
from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
from iip_uavsal_saliency_tpu_torch.models.convert import to_jax_variables
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


# f32: the kernel and cuDNN (TF32 off) sum the 9*C products in other orders.
# bf16: the plain version rounds the conv and the gate to bf16 every frame,
# the kernel keeps them in f32 until it stores h_s.
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 5, 13, 7, 24), (3, 4, 20, 8, 8), (1, 2, 1, 1, 8)],
                         ids=["ragged", "three_videos", "one_pixel"])
def test_twa_kernel_matches_ref(card, shape, dtype, atol):
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _case(*shape)]
    kernels.reset_launches()
    ys, last = twa_scan(*args)
    torch.cuda.synchronize()
    assert kernel_route(shape, dtype) == "twa_step"  # C % 32 != 0: one launch per frame
    assert kernels.launches == _launches("twa_step", shape[1])
    ref, ref_last = twa_scan_ref(*args)
    torch.testing.assert_close(ys.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(last.float(), ref_last.float(), atol=atol, rtol=0)


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
# x[:2] and x[2:] give, on either kernel.
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
}


# f32: the kernel's FMA chains and the plain version's matmuls sum C and E
# products in other orders; outputs are of order 1 to 10. bf16: e, d and
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


def test_dwblock_layout_constants_are_the_kernels(card):
    """The pack's layout constants are the ones the kernel source states."""
    values = [ctypes.c_int() for _ in range(5)]
    dw._lib().dwblock_bf16_layout(*[ctypes.byref(v) for v in values])
    assert [v.value for v in values] == [dw.CHUNK, dw.SLICE_ROWS, dw.PLANE, dw.COLUMN_BLOCK,
                                         dw.K_STEP]


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

@pytest.fixture(scope="module")
def seeded_variables():
    """A seeded JAX-layout variables tree of the flagship UAVSal: conv
    kernels with std sqrt(1 / fan_in), BatchNorm statistics of order 1."""
    rng = np.random.RandomState(11)
    sd = {}
    for key, ref in UAVSal().state_dict().items():
        if key.endswith("running_var") or (ref.dim() == 1 and key.endswith("weight")):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1:
            a = rng.normal(0.0, 0.1, ref.shape)
        else:
            a = rng.normal(0.0, np.sqrt(1.0 / np.prod(ref.shape[1:])), ref.shape)
        sd[key] = torch.tensor(a, dtype=torch.float32)
    return to_jax_variables(sd)


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
    counted from a profiler trace, while the wrappers count none."""
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
    assert kernels.traced_launches(prof) == {name: 4 * n for name, n in one.items()}
    assert not any(kernels.launches.values())
    assert {k: n - tally[k] for k, n in graphed.replayed.items()} == {
        name: 4 * n for name, n in one.items()}


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
    from iip_uavsal_saliency_tpu_torch.models.uavsal import init_uavsal
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state,
                                                             make_eval_step, make_train_step)

    x, gauss, ob, y = _train_batch(card)
    for dtype, want in ((torch.bfloat16, {"twa_scan": 1, "twa_step": 0, "dwblock": 0}),
                        (None, {"twa_scan": 0, "twa_step": 10, "dwblock": 0})):
        model = init_uavsal(UAVSal(fused_dwblock=fused), torch.Generator().manual_seed(0))
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
