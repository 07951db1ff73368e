#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the main path from `iip_uavsal_saliency_tpu_torch/csrc/` with
   nvcc for sm_90a, one nvcc per source, all started together.
2. Holds each kernel against its plain PyTorch version on the card:
   K1 (`ops/twa.py::twa_scan`) vs `twa_scan_ref`: the persistent kernel
   (one launch per clip, bf16) at the flagship shape (S=20, 45x80x256) for
   V=1, 2 and 4, also against the per-frame bf16 kernel on the same inputs
   and for equal bits on 20 more runs (a stale read of h_{s-1} between blocks
   would be rare, so one repeat is not enough); the per-frame kernel at the flagship
   shape in f32 and at a ragged shape (V=2, S=3, 13x7x24) in bf16 and f32;
   and shard invariance, the content of the JAX package's
   `twa_scan_sharded`: K1 on V=4 (S=3, 13x7x24 and 45x80x256, bf16 and f32)
   equals, bit for bit, K1 on x[:2] and x[2:] concatenated. K2 (`ops/dwblock.py::
   fused_dwblock_kernel`) vs `dwblock_ref` at 20x45x80 with C=256->256,
   E=1536, residual, with C=320->256, E=1920, and at a ragged 2x13x7 with
   C=24->16, in bf16 and f32; and, with phase 3, at every shape the main
   path gives it: each DWBlock that K2's gate admits, on the block's own
   packed weights and the input it receives in a serving step, in bf16 and
   f32. Then the gradient wrappers `fused_dwblock` and `twa_scan`, kernel
   forward in f32, against autograd through the plain versions.
3. Drives the port's main paths at full width: UAVSal at 360x640 with
   seeded random weights (numpy -> JAX variable tree -> `from_jax_variables`
   -> BatchNorm folded into the convs, through `load_model_for_inference`),
   the baked bf16 serving step, and `predict_videos` over one synthetic
   uint8 video of 3 clips of S=20 frames with the state carried, postprocessed to a native
   540x960 uint8. Launch counts are reset just before and read just after;
   a bf16 run must launch the persistent K1 exactly 3 times (once per clip)
   and the per-frame K1 never, an f32 run the per-frame K1 exactly 60 times
   and the persistent one never. Outputs must be finite, in
   [0, 1], the state must change from clip to clip, and the bf16 saliency
   must agree with an f32 run of the port on the card (CC >= 0.99 per frame).
   What K1 was given and what it returned in each clip of the bf16 runs is
   kept, and the persistent kernel's served output is held against the
   per-frame kernel and the plain version on those same inputs.
   The same video then goes through the fused-dwBlock path
   (`load_model_for_inference(..., fused_dwblock=True)`): every DWBlock the
   kernel's gate admits is one launch of K2, so the run must launch K1 as
   above and K2 once per admitted block and clip, exactly; its bf16 maps
   must agree with the f32 run and with the bf16 run without K2 (CC >= 0.99
   per frame), and its f32 maps with the f32 run without K2.
   Each of the four paths runs twice: with the eager step (the checks
   above, whose recorders need Python to run on every call) and as a user
   runs it, the step replayed from a CUDA graph (`graph_step`) through the
   pipelined `predict_videos`, under the profiler. The kernels that ran in
   the graphed run, counted from the trace, must be the eager run's
   launches, exactly (the wrappers count none there: a replay runs without
   them); it must give the eager run's uint8 maps bit for bit, and over the
   3 carried clips the eager step's saliency and state bit for bit. The
   `launches` of the kernels line are the eager runs' counts.
4. Times the serving step with K2 off and on, eager and graphed (ms per
   clip, FPS), the host's time to issue one step (eager against one
   replay), the pipelined `predict_videos` end to end, graphed and eager,
   K2 off and on, in turns, five runs each over 3 clips and over 20 clips
   (host clock), the runner alone (a step that does no work) and the idle
   share of the serving stream over one graphed 20-clip run under the
   profiler (`build/chip_smoke_profile_runner.txt`), and each
   kernel (its time per launch, its plain version's, one PyTorch call's, and
   its bound) with CUDA events after warm-up, each the median of 7 timed
   windows; K1's two kernels and its library yardstick in turns (per-frame,
   persistent, library, library, persistent, per-frame) at V=1 and V=4 in
   bf16, with the fastest window beside each median, and the per-frame
   kernel in f32, as the f32 paths launch it, beside its own f32 yardstick,
   plain version and bound; K2 at each admitted block of the bf16 path on
   that block's own input beside the block as three cuDNN convs and its
   bound; and writes a profiler table of one clip of each path to
   `build/chip_smoke_profile.txt` and `build/chip_smoke_profile_k2.txt`.
5. Trains at full width (360x640, S=10 = batch_size 2 x time_dims 5, V=1)
   on seeded weights from `init_uavsal`: one f32 train step on the card
   against the same step on the CPU (TF32 off); the bf16 mixed and the f32
   step with K1 (forward) and its gradient (`_TWAScan`, backward recomputed
   through the plain scan) against the same step with `ConvTWA.scan =
   twa_scan_ref`; the launches of one train step, exactly bf16
   {twa_scan 1, twa_step 0, dwblock 0} and f32 {0, 10, 0}, with the fused
   dwBlock off and on (K2 is refused in train mode); TBPTT over 3 carried
   clips and the loss falling over 10 steps on one clip, f32 and bf16; the
   trainer's own loop (2 epochs over in-memory videos), its `_final.ckpt`
   read back through `load_model_for_inference` and served to the trained
   model's maps; then ms per train step f32 and bf16 in turns, frames/s,
   peak memory, the eval step, the TWA backward's recompute timed alone and
   a profile of one bf16 step (`build/chip_smoke_profile_train.txt`).

The line before the last is a JSON object with one entry per kernel (with
`train_step_launches`, its launches counted in one train step of the dtype
it serves, K2's with the fused dwBlock on); the
last line is `{"ok": true, "device": {...}}`. Any failure exits non-zero
before that line is printed. Needs no network and starts no process that
outlives it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: K1's f32 route is plain FMA
PEAK_BYTES = 3.35e12

# K1 tolerances, max abs error against twa_scan_ref on the same inputs.
# f32: the kernel and cuDNN (TF32 off) sum 9*C products in different orders.
# bf16: the reference rounds the conv output and the gate to bf16 each step,
# the kernel keeps them in f32; the two drift apart by two bf16 ulps (0.0156)
# of values of order 1 over 20 steps.
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
# K1's persistent kernel against its per-frame bf16 kernel on the same inputs:
# both accumulate in f32 and round once per frame, at the store of h_s, so
# they differ by summation order (and the last f32 bits of the gate), which
# moves a stored value to the neighbouring bf16 now and then. |h| < 4 here,
# where one bf16 ulp is 2^-6; the card showed 2^-7.
TOL_K1_KERNELS = 2.0 ** -6
REPEATS = 20   # further runs of the persistent kernel that must give the first run's bits
CC_MIN = 0.99  # bf16 vs f32 saliency, Pearson CC per frame
# K2 tolerances, max abs error against dwblock_ref on the same inputs.
# f32: the kernel's FMA chains and the plain version's matmuls sum the C and
# E products in other orders (outputs of order 1 to 10).
# bf16: both round e, d and the output to bf16 at the same points, so they
# differ only where f32 sums that differ in their last bits round to the
# other neighbour: one bf16 ulp of the output, 2^-5 for the outputs below 8
# that these inputs give (checked).
TOL_K2_F32 = 2e-5
TOL_K2_BF16 = 2.0 ** -5
# The admitted blocks get the activations of a serving step, whose outputs
# are not all below 8: there the tolerances above scale with the largest
# output, as one bf16 ulp does (2^-8 of the power of two at or below it).
# f32 serving with K2 on against f32 serving with K2 off: saliency in [0, 1]
# after the sum-order differences of every admitted block and 20 TWA steps.
TOL_F32_PATHS = 1e-4
# gradients through the kernel forward against autograd through the plain
# version: the backward is the same recompute, fed the kernel's f32 output
TOL_GRAD = 2e-4

# training: train-mode step against the port on the CPU (f32, TF32 off), and
# K1's path against the plain scan. Each f32 run drifts from the exact answer
# through ~100 train-mode BatchNorms (tests/test_torch_train_step.py: at
# 64x128 the CPU's f32 loss 1e-5 relative from f64, its gradient 2.5-3.4%
# relative L2, up to 9.6% on a leaf, BN stats 4e-5, the state 1.6e-3); these
# bounds are those of that test. Gradients are read relative L2, each leaf's
# norm floored at 1e-4 of the whole gradient's (a BatchNorm bias before
# another BatchNorm has an exact gradient of 0, and its f32 value is noise).
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 0.1
TOL_TRAIN_GRAD_LEAF = 0.25
TOL_TRAIN_BN = 1e-4    # relative to the stat's scale (`bn_scale`)
TOL_TRAIN_STATE = 5e-3
# K1 against the plain scan in the same step on the card. f32: the two sum
# each frame's 9*C products in other orders (TOL_F32 of K1 alone) and the
# rest of the step is the same code on the same card; an H100 read the loss
# equal, the gradient 7.5e-5, the worst leaf 2.6e-3, BN stats 6.4e-8, the
# state 1.55e-5. The leaf bound holds every leaf, ConvTWA's among them.
TOL_TRAIN_K1_LOSS = 1e-6
TOL_TRAIN_K1_GRAD = TOL_GRAD
TOL_TRAIN_K1_LEAF = 1e-2
TOL_TRAIN_K1_BN = 1e-6
TOL_TRAIN_K1_STATE = 1e-4
# bf16 mixed: K1 keeps conv and gate in f32 where the plain scan rounds both
# to bf16 every frame, about two bf16 ulps of h (TOL_BF16) that the head, the
# loss and the backward carry on; an H100 read loss 6.4e-5, gradient 0.076,
# BN stats 9.9e-5, state 0.094 (values up to 8), each bound a few times that.
# A leaf is not held here: a BatchNorm bias before another BatchNorm has an
# exact gradient of 0, and in bf16 its value is noise of either step.
TOL_TRAIN_BF16_LOSS = 3e-4
TOL_TRAIN_BF16_GRAD = 0.2
TOL_TRAIN_BF16_BN = 3e-4
TOL_TRAIN_BF16_STATE = 0.3
TRAIN_S = 10        # batch_size 2 x time_dims 5, as the trainer's clips
TRAIN_REPEATS = 10  # steps on one repeated clip, over which the loss must fall
TRAIN_LR, TRAIN_WD = 1e-4, 5e-5  # the trainer's defaults

V, S, CLIPS = 1, 20, 3
LONG_CLIPS = 20  # the runner's steady state is timed over a video of this many clips
E2E_RUNS = 5     # end-to-end runs per path, in turns
IN_H, IN_W, OUT_H, OUT_W = 360, 640, 45, 80
NATIVE_H, NATIVE_W = 540, 960
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, windows: int = 7) -> float:
    """Milliseconds per call of fn() on the card: after one warm-up call,
    `windows` windows of `reps` calls each are timed with CUDA events, and
    the median window's mean is returned."""
    return float(np.median(cuda_windows(fn, reps, windows)))


def cuda_windows(fn, reps: int, windows: int = 7) -> list:
    """The windows of `cuda_ms`, each its mean in ms per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def random_state_dict(model, rng):
    """Seeded weights for every entry of the model's state_dict: conv
    kernels with std sqrt(1 / fan_in), which keeps activations of order 1
    and the random network from amplifying rounding (larger gains make the
    bf16 and f32 maps decorrelate), and non-trivial BatchNorm statistics."""
    import torch

    sd = {}
    for key, ref in model.state_dict().items():
        if key.endswith("running_mean"):
            a = rng.normal(0.0, 0.1, ref.shape)
        elif key.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1 and key.endswith("weight"):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1:
            a = rng.normal(0.0, 0.1, ref.shape)
        else:
            fan_in = ref.shape[1] * ref.shape[2] * ref.shape[3]
            a = rng.normal(0.0, np.sqrt(1.0 / fan_in), ref.shape)
        sd[key] = torch.tensor(a, dtype=torch.float32)
    return sd


def synthetic_video(rng, n: int) -> np.ndarray:
    """(n, 360, 640, 3) uint8: a bright disk moving over a noisy gradient."""
    yy, xx = np.mgrid[0:IN_H, 0:IN_W]
    base = (xx * 0.2 + yy * 0.1).astype(np.float32)
    frames = np.empty((n, IN_H, IN_W, 3), np.uint8)
    for t in range(n):
        cy, cx = IN_H / 2 + 80 * np.sin(t / 7.0), 60 + t * 8
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2 < 40 ** 2) * 180.0
        img = base[..., None] + disk[..., None] + rng.normal(0, 12, (IN_H, IN_W, 3))
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def k1_arrays(rng, shape):
    v, s, h, w, c = shape
    return [rng.normal(0, 0.5, shape), rng.normal(0, 0.5, shape),
            rng.normal(0, np.sqrt(2.0 / (9 * c)), (3, 3, c, c)),
            rng.normal(0, 0.5, (v, h, w, c))]


def k1_case(torch, rng, shape, dtype, arrays=None):
    return [torch.tensor(a, dtype=torch.float32).to("cuda", dtype)
            for a in arrays or k1_arrays(rng, shape)]


def check_k1(torch, kernels, twa, rng):
    """Phase 2: K1's two kernels against twa_scan_ref and each other, and
    shard invariance. Returns the flagship errors of the persistent kernel
    (bf16) and of the per-frame kernel as the main paths launch it (f32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the main generator gives the flagship and the ragged case and then goes
    # on to K2's cases and the model's weights; the other cases have their own
    flagship, ragged = (1, S, OUT_H, OUT_W, 256), (2, 3, 13, 7, 24)
    drawn = {flagship: k1_arrays(rng, flagship), ragged: k1_arrays(rng, ragged)}
    rng = np.random.default_rng(SEED + 1)

    def held(what, shape, dtype, ys, h_last, args, tol):
        ref, ref_last = twa.twa_scan_ref(*args)
        err = (ys.float() - ref.float()).abs().max().item()
        err_last = (h_last.float() - ref_last.float()).abs().max().item()
        v, s, h, w, c = shape
        name = str(dtype).replace("torch.", "")
        print(f"K1 {what} {name} V={v} S={s} {h}x{w}x{c}: max_abs_err {err:.3g} "
              f"(h_last {err_last:.3g}), tolerance {tol}")
        if not (err <= tol and err_last <= tol):
            fail(f"K1 ({what}) disagrees with twa_scan_ref in {name} at {shape}: {err}")
        return err

    def scan(args, route, frames):
        """`twa_scan` on the route its gate must pick, counted."""
        if twa.kernel_route(args[0].shape, args[0].dtype) != route:
            fail(f"K1's gate does not send {tuple(args[0].shape)} {args[0].dtype} to {route}")
        kernels.reset_launches()
        out = twa.twa_scan(*args)
        torch.cuda.synchronize()
        want = {"twa_scan": int(route == "twa_scan"),
                "twa_step": frames if route == "twa_step" else 0, "dwblock": 0}
        if kernels.launches != want:
            fail(f"K1 at {tuple(args[0].shape)}: launched {kernels.launches}, expected {want}")
        return out

    # the persistent kernel: flagship frame, V = 1, 2, 4
    errs = {}
    for v in (1, 2, 4):
        shape = (v, S, OUT_H, OUT_W, 256)
        args = k1_case(torch, rng, shape, torch.bfloat16, drawn.get(shape))
        ys, h_last = scan(args, "twa_scan", S)
        err = held("persistent", shape, torch.bfloat16, ys, h_last, args, TOL_BF16)
        step, step_last = twa._twa_scan_cuda(*args, route="twa_step")
        for run in range(REPEATS):
            again, again_last = twa.twa_scan(*args)
            if not (torch.equal(again, ys) and torch.equal(again_last, h_last)):
                fail(f"K1 (persistent) gives other bits on run {run + 2} at V={v}")
        diff = (ys.float() - step.float()).abs().max().item()
        print(f"K1 persistent vs per-frame bf16 kernel V={v}: max abs diff {diff:.3g} "
              f"({(ys != step).float().mean().item():.3%} of values differ), tolerance "
              f"{TOL_K1_KERNELS}; {REPEATS + 1} persistent runs give equal bits")
        if not diff <= TOL_K1_KERNELS:
            fail(f"K1's two bf16 kernels disagree at V={v}: {diff}")
        if v == 1:
            errs["twa_scan"] = err
            held("per-frame", shape, torch.bfloat16, step, step_last, args, TOL_BF16)
    # the per-frame kernel: f32 at the flagship shape, the ragged shape in both
    for shape, dtype, tol in [(flagship, torch.float32, TOL_F32), (ragged, torch.float32, TOL_F32),
                              (ragged, torch.bfloat16, TOL_BF16)]:
        args = k1_case(torch, rng, shape, dtype, drawn[shape])
        ys, h_last = scan(args, "twa_step", shape[1])
        err = held("per-frame", shape, dtype, ys, h_last, args, tol)
        if (shape, dtype) == (flagship, torch.float32):
            errs["twa_step"] = err
    # shard invariance: whole V against the two halves, bit for bit
    for hwc in ((13, 7, 24), (OUT_H, OUT_W, 256)):
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            shape = (4, 3, *hwc)
            x, gx, w_h, h0 = k1_case(torch, rng, shape, dtype)
            ys, h_last = twa.twa_scan(x, gx, w_h, h0)
            halves = [twa.twa_scan(x[i:i + 2].contiguous(), gx[i:i + 2].contiguous(), w_h,
                                   h0[i:i + 2].contiguous()) for i in (0, 2)]
            torch.cuda.synchronize()
            route = twa.kernel_route(shape, dtype)
            held(f"whole V ({route})", shape, dtype, ys, h_last, (x, gx, w_h, h0), tol)
            if not (torch.equal(torch.cat([p[0] for p in halves]), ys)
                    and torch.equal(torch.cat([p[1] for p in halves]), h_last)):
                fail(f"K1 ({route}) on x[:2], x[2:] gives other bits than on x at {shape} {dtype}")
            print(f"K1 {route} V=4 equals V=2 + V=2 bit for bit at {shape} "
                  f"{str(dtype).replace('torch.', '')}")
    return errs


def dw_case(rng, n, h, w, c, e, co):
    """Folded-block inputs (x, W1, b1, Wd, bd, W2, b2) whose e, d and output
    are all of order 1."""
    return [rng.normal(0, 0.5, (n, h, w, c)), rng.normal(0, np.sqrt(2.0 / c), (c, e)),
            rng.normal(0, 0.5, (e,)), rng.normal(0, 0.3, (3, 3, e)), rng.normal(0, 0.5, (e,)),
            rng.normal(0, np.sqrt(1.0 / e), (e, co)), rng.normal(0, 0.5, (co,))]


K2_FLAGSHIP = (V * S, OUT_H, OUT_W, 256, 1536, 256)


def check_k2(torch, dwblock, rng):
    """Phase 2: K2 against dwblock_ref. Returns the flagship bf16 error."""
    flagship_err = None
    for shape, residual in [(K2_FLAGSHIP, True), ((V * S, OUT_H, OUT_W, 320, 1920, 256), False),
                            ((2, 13, 7, 24, 144, 16), False)]:
        arrays = dw_case(rng, *shape)
        for dtype, tol in ((torch.float32, TOL_K2_F32), (torch.bfloat16, TOL_K2_BF16)):
            args = [torch.tensor(a, dtype=torch.float32).to("cuda", dtype) for a in arrays]
            out = dwblock.fused_dwblock_kernel(*args, residual)
            torch.cuda.synchronize()
            ref = dwblock.dwblock_ref(*args, residual)
            err = (out.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            name = str(dtype).replace("torch.", "")
            print(f"K2 {name} N,H,W,C,E,Co={shape} residual={residual}: max_abs_err {err:.3g}, "
                  f"max |ref| {top:.3g}, tolerance {tol}")
            if out.shape != ref.shape or not err <= tol or not top < 8:
                fail(f"K2 disagrees with dwblock_ref in {name} at {shape}: {err}")
            if (shape, dtype) == (K2_FLAGSHIP, torch.bfloat16):
                flagship_err = err
    return flagship_err


def check_k2_admitted(torch, dwblock, DWBlock, model, step, clip, state):
    """K2 against dwblock_ref at every shape the main path gives it: one
    serving step with a hook on each DWBlock keeps the input of every block
    the gate admits; K2 and the plain version then run on that input and the
    block's own weights as `DWBlock.pack` made them (for bf16 the packed
    layout too). Returns the admitted (name, shape) list and, per block,
    (name, module, input)."""
    taken = []
    hooks = [m.register_forward_pre_hook(
        lambda m, inp, name=name: taken.append((name, m, inp[0].clone()))
        if m.takes_kernel(inp[0].shape, inp[0].dtype) else None)
        for name, m in model.named_modules() if isinstance(m, DWBlock)]
    step(clip, state)
    for hook in hooks:
        hook.remove()
    if not taken:
        fail("the gate admits no DWBlock of the model")
    worst = 0.0
    for name, m, x in taken:
        weights, blobs = m.kernel_weights(x.dtype)
        if x.dtype == torch.bfloat16 and blobs is None:
            fail(f"{name}: the served bf16 block has no packed weights")
        args = (x.permute(0, 2, 3, 1), *weights, m.use_res)
        out = dwblock.fused_dwblock_kernel(*args, blobs)
        torch.cuda.synchronize()
        ref = dwblock.dwblock_ref(*args)
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        scale = max(1.0, 2.0 ** np.floor(np.log2(max(top, 1e-30))) / 4)  # 1 below 8
        tol = (TOL_K2_BF16 if x.dtype == torch.bfloat16 else TOL_K2_F32) * scale
        n, c, h, w = x.shape
        print(f"  {name} N,H,W,C,E,Co={(n, h, w, c, args[1].shape[1], out.shape[3])} "
              f"residual={m.use_res}: max_abs_err {err:.3g}, max |ref| {top:.3g}, "
              f"tolerance {tol:.3g}")
        if out.shape != ref.shape or not torch.isfinite(out).all() or not err <= tol:
            fail(f"K2 disagrees with dwblock_ref in {name} ({x.dtype}) at {tuple(x.shape)}: {err}")
        worst = max(worst, err / tol)
    print(f"K2 holds dwblock_ref at all {len(taken)} admitted blocks of {len(hooks)} DWBlocks "
          f"in {str(x.dtype).replace('torch.', '')}; largest error {worst:.3g} of its tolerance")
    return [(name, tuple(x.shape)) for name, _, x in taken], taken


def k2_bound(n, h, w, c, e, co, itemsize=2, peak_flops=PEAK_BF16_FLOPS):
    """(ms, bound_by) the card needs at least for one block: x, the weights
    and the output moved once, or the three convs' operations."""
    flops = 2.0 * n * h * w * (c * e + 9 * e + e * co)
    bytes_moved = (n * h * w * (c + co) + c * e + 11 * e + e * co + co) * itemsize
    flops_ms, bytes_ms = flops / peak_flops * 1e3, bytes_moved / PEAK_BYTES * 1e3
    return max(flops_ms, bytes_ms), "operations" if flops_ms >= bytes_ms else "bytes"


def graph_ms(torch, fn, reps: int = 10) -> float:
    """Device milliseconds per call of fn() with the host's issue time taken
    out: fn is captured once in a CUDA graph, after three warm-up calls on a
    side stream (cuDNN's autotuning included), and the graph's replays are
    timed as in `cuda_ms`."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the kernel's launcher sets its shared-memory attribute on every call
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_ms(graph.replay, reps)


def time_k2_admitted(torch, dwblock, taken):
    """K2 at each admitted block of the bf16 path, on that block's own input
    and packed weights, beside the same block as its three cuDNN convs (the
    module with the kernel off, as the K2-off path serves it: conv, bias,
    ReLU6, residual; `cudnn.benchmark` on) and its bound; device us per
    launch, each captured in a CUDA graph so that the host's issue time of a
    small block does not stand in for the card's; one line per block, then
    the sums."""
    torch.backends.cudnn.benchmark = True
    sums = np.zeros(3)
    print("K2 bf16 per admitted block (device us per launch, CUDA graphs): kernel, three cuDNN "
          "convs, bound")
    for name, m, x in taken:
        weights, blobs = m.kernel_weights(x.dtype)
        xn = x.permute(0, 2, 3, 1)
        kernel_ms = graph_ms(torch, lambda: dwblock.fused_dwblock_kernel(xn, *weights, m.use_res,
                                                                          blobs))
        m.use_kernel = False
        try:
            with torch.no_grad():
                convs_ms = graph_ms(torch, lambda: m(x))
        finally:
            m.use_kernel = True
        n, c, h, w = x.shape
        e, co = weights[0].shape[1], weights[4].shape[1]
        bound_ms, bound_by = k2_bound(n, h, w, c, e, co)
        sums += (kernel_ms, convs_ms, bound_ms)
        print(f"  {name} N,H,W,C,E,Co={(n, h, w, c, e, co)}: kernel {kernel_ms * 1e3:.2f}, "
              f"convs {convs_ms * 1e3:.2f}, bound {bound_ms * 1e3:.2f} ({bound_by}); "
              f"kernel/convs {kernel_ms / convs_ms:.3f}, kernel/bound {kernel_ms / bound_ms:.2f}")
    torch.backends.cudnn.benchmark = False
    print(f"K2 bf16 over the {len(taken)} admitted blocks: kernel {sums[0] * 1e3:.2f} us, "
          f"convs {sums[1] * 1e3:.2f} us, bound {sums[2] * 1e3:.2f} us per step")


def check_gradients(torch, kernels, dwblock, twa, rng):
    """Phase 2: the gradient wrappers with the kernel forward, f32, against
    autograd through the plain versions, for a sum of squares."""
    def grads(fn, arrays):
        args = [torch.tensor(a, dtype=torch.float32, device="cuda").requires_grad_()
                for a in arrays]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o ** 2).sum() for o in outs).backward()
        return [a.grad for a in args]

    dw = dw_case(rng, 2, 6, 9, 16, 96, 16)
    tw = [rng.normal(0, 0.5, (2, 3, 6, 5, 8)), rng.normal(0, 0.5, (2, 3, 6, 5, 8)),
          rng.normal(0, 0.15, (3, 3, 8, 8)), rng.normal(0, 0.5, (2, 6, 5, 8))]
    kernels.reset_launches()
    pairs = {"fused_dwblock": (grads(lambda *a: dwblock.fused_dwblock(*a, True), dw),
                               grads(lambda *a: dwblock.dwblock_ref(*a, True), dw)),
             "twa_scan": (grads(twa.twa_scan, tw), grads(twa.twa_scan_ref, tw))}
    if kernels.launches != {"twa_scan": 0, "twa_step": 3, "dwblock": 1}:  # f32: per frame
        fail(f"the gradient phase launched {kernels.launches}")
    for name, (got, want) in pairs.items():
        err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
                  for g, w in zip(got, want))
        print(f"gradients of {name} (kernel forward, f32) vs autograd through the plain "
              f"version, {len(got)} arguments: max error {err:.3g} of the largest entry, "
              f"tolerance {TOL_GRAD}")
        if not err <= TOL_GRAD:
            fail(f"gradients of {name} disagree with the plain version: {err}")


def time_k2(torch, F, dwblock, rng):
    """K2 time per launch at the flagship shape in bf16 (20x45x80, C=256,
    E=1536, residual), beside its plain version, the library yardstick (the
    folded block as three cuDNN convs with bias and ReLU6, `cudnn.benchmark`
    on) and the bound. All in ms per launch."""
    n, h, w, c, e, co = K2_FLAGSHIP
    args = [torch.tensor(a, dtype=torch.float32).to("cuda", torch.bfloat16)
            for a in dw_case(rng, *K2_FLAGSHIP)]
    x, w1, b1, wd, bd, w2, b2 = args
    blobs = dwblock.pack_dwblock_weights(w1, b1, wd, bd, w2)  # packed once, as served
    kernel_ms = cuda_ms(lambda: dwblock.fused_dwblock_kernel(*args, True, blobs), 10)
    plain_ms = cuda_ms(lambda: dwblock.dwblock_ref(*args, True), 3)

    cl = torch.channels_last
    xn = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
    w1c = w1.t().reshape(e, c, 1, 1).contiguous(memory_format=cl)
    wdc = wd.permute(2, 0, 1).reshape(e, 1, 3, 3).contiguous()
    w2c = w2.t().reshape(co, e, 1, 1).contiguous(memory_format=cl)

    def library_block():
        y = F.relu6(F.conv2d(xn, w1c, b1))
        y = F.relu6(F.conv2d(y, wdc, bd, padding=1, groups=e))
        return F.conv2d(y, w2c, b2) + xn

    torch.backends.cudnn.benchmark = True
    library_ms = cuda_ms(library_block, 10)
    torch.backends.cudnn.benchmark = False
    bound_ms, bound_by = k2_bound(n, h, w, c, e, co)
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


def frame_cc(torch, a, b):
    """Pearson CC per frame between two (T, H, W) stacks of maps."""
    a = a - a.mean(dim=(1, 2), keepdim=True)
    b = b - b.mean(dim=(1, 2), keepdim=True)
    return (a * b).sum(dim=(1, 2)) / (a.norm(dim=(1, 2)) * b.norm(dim=(1, 2)))


def k1_library(torch, F, x, gx, w_h, h0):
    """K1's library yardstick on these inputs: per frame one cuDNN conv in
    channels-last memory, a sigmoid and a lerp."""
    w_oihw = w_h.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xs, gxs = x.permute(1, 0, 4, 2, 3), gx.permute(1, 0, 4, 2, 3)  # channels-last views
    hp = h0.permute(0, 3, 1, 2)

    def library_frames():
        hh = hp
        for t in range(x.shape[1]):
            g = torch.sigmoid(gxs[t] + F.conv2d(hh, w_oihw, padding=1))
            hh = torch.lerp(hh, xs[t], g)

    return library_frames


def k1_bound(shape, itemsize, peak_flops):
    """(ms, bound_by) the card needs at least for a scan of this shape: x, gx,
    h_{s-1} and h_s of every frame and W_h once, or 9*C*C FMA per pixel."""
    v, s, h, w, c = shape
    flops_ms = 2.0 * s * v * h * w * 9 * c * c / peak_flops * 1e3
    bytes_ms = (4.0 * s * v * h * w * c + 9 * c * c) * itemsize / PEAK_BYTES * 1e3
    return max(flops_ms, bytes_ms), "operations" if flops_ms >= bytes_ms else "bytes"


def time_k1(torch, F, twa, rng, v):
    """K1 at V x 20 x 45 x 80 x 256 in bf16: the per-frame kernel, the
    persistent kernel and the library yardstick (one cuDNN conv + sigmoid +
    lerp per frame, `cudnn.benchmark` on, autotuned in the warm-up call),
    timed in turns (per-frame, persistent, library, library, persistent,
    per-frame), 7 windows of 10 clips a turn; then the plain version and the
    bound. Returns ms per clip: {name: (median, fastest window)} over a
    name's 14 windows, and the bound."""
    s, h, w, c = S, OUT_H, OUT_W, 256
    x, gx, w_h, h0 = k1_case(torch, rng, (v, s, h, w, c), torch.bfloat16)
    calls = {"per-frame": lambda: twa._twa_scan_cuda(x, gx, w_h, h0, route="twa_step"),
             "persistent": lambda: twa.twa_scan(x, gx, w_h, h0),
             "library": k1_library(torch, F, x, gx, w_h, h0)}
    windows = {name: [] for name in calls}
    torch.backends.cudnn.benchmark = True
    for name in ("per-frame", "persistent", "library", "library", "persistent", "per-frame"):
        turn = cuda_windows(calls[name], 10)
        windows[name] += turn
        print(f"K1 V={v} {name}: median {np.median(turn) / s * 1e3:.2f} us/frame, fastest "
              f"window {min(turn) / s * 1e3:.2f}")
    torch.backends.cudnn.benchmark = False
    times = {name: (float(np.median(ws)), min(ws)) for name, ws in windows.items()}
    times["plain"] = (cuda_ms(lambda: twa.twa_scan_ref(x, gx, w_h, h0), 3), None)
    bound_ms, bound_by = k1_bound(x.shape, 2, PEAK_BF16_FLOPS)  # per clip
    for name, (med, fastest) in times.items():
        best = "" if fastest is None else f", fastest window {fastest / s * 1e3:.2f}"
        print(f"K1 bf16 at {v}x{s}x{h}x{w}x{c}, {name}: {med / s * 1e3:.2f} us/frame{best}")
    print(f"K1 bf16 at {v}x{s}x{h}x{w}x{c}, bound: {bound_ms / s * 1e3:.2f} us/frame ({bound_by})")
    return times, bound_ms, bound_by


def time_k1_f32(torch, F, twa, rng):
    """The per-frame kernel as the f32 main paths launch it, 1 x 45 x 80 x 256
    in f32 on plain FMA, 20 launches a clip: beside its library yardstick
    (one cuDNN conv, TF32 off, + sigmoid + lerp per frame), in turns (kernel,
    library, library, kernel), then the plain version and the bound, which is
    at the f32 rate outside the tensor cores. Returns ms per launch."""
    s, h, w, c = S, OUT_H, OUT_W, 256
    x, gx, w_h, h0 = k1_case(torch, rng, (1, s, h, w, c), torch.float32)
    if twa.kernel_route(x.shape, x.dtype) != "twa_step":
        fail("K1's gate does not send f32 to the per-frame kernel")
    calls = {"kernel": lambda: twa.twa_scan(x, gx, w_h, h0),
             "library": k1_library(torch, F, x, gx, w_h, h0)}
    windows = {name: [] for name in calls}
    torch.backends.cudnn.benchmark = True
    for name in ("kernel", "library", "library", "kernel"):
        windows[name] += cuda_windows(calls[name], 5)
    torch.backends.cudnn.benchmark = False
    out = {name: float(np.median(ws)) / s for name, ws in windows.items()}
    out["plain"] = cuda_ms(lambda: twa.twa_scan_ref(x, gx, w_h, h0), 3) / s
    out["bound"], out["bound_by"] = k1_bound((1, 1, h, w, c), 4, PEAK_F32_FLOPS)
    print(f"K1 per-frame kernel, f32 at 1x{s}x{h}x{w}x{c}: {out['kernel'] * 1e3:.2f} us/frame "
          f"(fastest window {min(windows['kernel']) / s * 1e3:.2f}), library "
          f"{out['library'] * 1e3:.2f} (fastest {min(windows['library']) / s * 1e3:.2f}), plain "
          f"{out['plain'] * 1e3:.2f}, bound {out['bound'] * 1e3:.2f} ({out['bound_by']}, at "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s)")
    return out


def check_k1_served(torch, twa, name, taken):
    """K1 where it is served: `taken` holds, per clip of a bf16 main path,
    the arguments `twa_scan` was called with and what it returned. The
    persistent kernel's served output must be the bits it gives on those
    inputs alone, agree with the per-frame kernel within one bf16 ulp of the
    largest value (`TOL_K1_KERNELS` below 4), and hold the plain version
    computed in f32 on the same bf16 inputs within `TOL_BF16`, which is for
    values below 2 and grows as a bf16 ulp does. The plain version in bf16,
    which rounds conv and gate every frame, is read against the same f32
    result beside it."""
    for k, ((x, gx, w_h, h0), (ys, h_last)) in enumerate(taken):
        args = (x, gx, w_h.to(x.dtype), h0.to(x.dtype))
        alone, alone_last = twa._twa_scan_cuda(*args, route="twa_scan")
        step, _ = twa._twa_scan_cuda(*args, route="twa_step")
        exact = twa.twa_scan_ref(*(a.float() for a in args))[0]
        plain_err = (twa.twa_scan_ref(*args)[0].float() - exact).abs().max().item()
        torch.cuda.synchronize()
        top = exact.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
        tol_exact, tol_step = TOL_BF16 * max(1.0, ulp * 2 ** 7), max(TOL_K1_KERNELS, ulp)
        err = (ys.float() - exact).abs().max().item()
        diff = (ys.float() - step.float()).abs().max().item()
        same = torch.equal(alone, ys) and torch.equal(alone_last, h_last)
        print(f"K1 as served, {name}, clip {k}: max |h| {top:.3g}; vs the plain version in f32 "
              f"{err:.3g} (tolerance {tol_exact:.3g}; the plain version in bf16 {plain_err:.3g}), "
              f"vs per-frame kernel {diff:.3g} (tolerance {tol_step:.3g}), equal bits alone: {same}")
        if not same:
            fail(f"{name} clip {k}: K1's served output is not what it gives on the same inputs")
        if not (err <= tol_exact and diff <= tol_step):
            fail(f"{name} clip {k}: K1's served output disagrees: {err} vs the plain version "
                 f"in f32, {diff} vs the per-frame kernel")


# ---------------------------------------------------------------------------
# 5. Training at full width (360x640, S=10, V=1)


def train_video(rng, n):
    """n frames for training: `synthetic_video`'s moving disk (uint8
    (n, 360, 640, 3)) and its ground truth at 45x80, (n, 45, 80, 2) f32: a
    fixation at the disk's centre and one at random per frame (channel 1)
    and their blurred map, peak 1 (channel 0)."""
    frames = synthetic_video(rng, n)
    yy, xx = np.mgrid[0:OUT_H, 0:OUT_W]
    gaze = np.zeros((n, OUT_H, OUT_W, 2), np.float32)
    for t in range(n):
        cy, cx = IN_H / 2 + 80 * np.sin(t / 7.0), 60 + t * 8  # the disk, as drawn
        points = [(min(int(cy // 8), OUT_H - 1), min(int(cx // 8), OUT_W - 1)),
                  (int(rng.integers(OUT_H)), int(rng.integers(OUT_W)))]
        blur = np.zeros((OUT_H, OUT_W))
        for py, px in points:
            gaze[t, py, px, 1] = 1.0
            blur += np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * 3.0 ** 2))
        gaze[t, :, :, 0] = blur / blur.max()
    return frames, gaze


def train_model(torch, start, device, fused=False, scan=None):
    """The flagship with the weights `start`, channels-last on `device`;
    `scan` is ConvTWA's scan (None: K1 on the card)."""
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal

    model = UAVSal(fused_dwblock=fused)
    model.load_state_dict(start, strict=True)
    model.rnn.scan = scan
    return model.to(device, memory_format=torch.channels_last)


def one_train_step(torch, kernels, start, batch, device, dtype=None, fused=False, scan=None):
    """One train step (Adam, every parameter trained) from the weights
    `start` on `batch` = (x, y, gauss, ob, state): (loss, {name: gradient},
    {name: buffer after}, new state, its launches), all on the host in f64."""
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step

    model = train_model(torch, start, device, fused, scan)
    step = make_train_step(create_train_state(model, make_optimizer(model, TRAIN_LR, TRAIN_WD)),
                           compute_dtype=dtype)
    x, y, gauss, ob, state = (t.to(device) for t in batch)
    kernels.reset_launches()
    loss, new_state = step(x, gauss, ob, state, y)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if new_state.grad_fn is not None or new_state.dtype != torch.float32:
        fail(f"the train step's carried state has grad_fn {new_state.grad_fn}, dtype "
             f"{new_state.dtype}")
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    bufs = {n: b.detach().double().cpu() for n, b in model.named_buffers()}
    return float(loss), grads, bufs, new_state.double().cpu(), launches


def bn_scale(bufs, name):
    """What an error of a running stat is read against: the largest
    variance, or for a mean the largest mean plus the largest std."""
    if name.endswith("running_var"):
        return bufs[name].abs().max().item()
    return bufs[name].abs().max().item() + bufs[name[:-4] + "var"].max().sqrt().item()


def train_diffs(a, b):
    """Step b against step a: the loss (relative), the whole gradient, its
    worst leaf (the leaf's norm floored) and ConvTWA's leaves together
    (relative L2), the worst leaf's
    largest error over its largest entry, the BN stats (relative to
    `bn_scale`) and the carried state (absolute)."""
    la, ga, ba, sa, _ = a
    lb, gb, bb, sb, _ = b
    total = np.sqrt(sum((g ** 2).sum().item() for g in ga.values()))
    top = max(g.abs().max().item() for g in ga.values())
    grad = np.sqrt(sum(((gb[n] - ga[n]) ** 2).sum().item() for n in ga)) / total
    leaf, leaf_name = max(((gb[n] - ga[n]).norm().item() / max(ga[n].norm().item(), 1e-4 * total),
                           n) for n in ga)
    entry = max((gb[n] - ga[n]).abs().max().item() / max(ga[n].abs().max().item(), 1e-4 * top)
                for n in ga)
    bn, bn_name = max(((bb[n] - ba[n]).abs().max().item() / bn_scale(ba, n), n)
                      for n in ba if "running" in n)
    rnn = [n for n in ga if n.startswith("rnn.")]
    rnn_err = np.sqrt(sum(((gb[n] - ga[n]) ** 2).sum().item() for n in rnn)
                      / sum((ga[n] ** 2).sum().item() for n in rnn))
    return {"loss": abs(lb - la) / abs(la), "grad": grad, "leaf": leaf, "leaf_name": leaf_name,
            "rnn": rnn_err, "entry": entry, "bn": bn, "bn_name": bn_name,
            "state": (sb - sa).abs().max().item()}


def held_train(name, d, tol_loss, tol_grad, tol_leaf, tol_bn, tol_state):
    """Print step b's differences from step a (`train_diffs`) and fail
    unless each lies within its tolerance (`tol_leaf` None: not held)."""
    print(f"{name}: loss {d['loss']:.3g} (tolerance {tol_loss}), gradient {d['grad']:.3g} "
          f"(tolerance {tol_grad}), worst leaf {d['leaf']:.3g} ({d['leaf_name']}"
          + (f", tolerance {tol_leaf}" if tol_leaf else ", not held") + "), ConvTWA's "
          f"leaves {d['rnn']:.3g}, worst leaf's largest error {d['entry']:.3g} of its largest "
          f"entry, BN stats {d['bn']:.3g} ({d['bn_name']}, tolerance {tol_bn}), state "
          f"{d['state']:.3g} (tolerance {tol_state})")
    if not (d["loss"] <= tol_loss and d["grad"] <= tol_grad
            and (tol_leaf is None or d["leaf"] <= tol_leaf)
            and d["bn"] <= tol_bn and d["state"] <= tol_state):
        fail(f"{name}: outside its tolerances")


def train_phase(torch, kernels, twa):
    """Training at 360x640, S=10, V=1 on seeded random weights from
    `init_uavsal`: (1) one f32 train step on the card against the same step
    on the CPU; (2) the bf16 mixed and the f32 step with K1 against the same
    step with the plain scan (`ConvTWA.scan = twa_scan_ref`); (3) the launches
    of one step, with the fused dwBlock off and on; (4) TBPTT over 3 carried
    clips, and the loss over repeated steps on one clip; (5) the trainer's own
    loop over in-memory videos, its `_final.ckpt` read back and served;
    (6) the numbers. Returns the launches counted in one train step, by
    dtype ("bf16", "f32") and with the fused dwBlock on ("bf16 fused",
    "f32 fused")."""
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
    from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_uavsal
    from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference
    from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step
    from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
    from iip_uavsal_saliency_tpu_torch.training.steps import (_maybe_normalize,
                                                             create_train_state, make_eval_step,
                                                             make_train_step)
    from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(SEED + 7)  # its own: the serving phases' draws stay as they were
    start = init_uavsal(UAVSal(), torch.Generator().manual_seed(SEED)).state_dict()
    gauss = torch.from_numpy(get_gauss_priors(OUT_H, OUT_W, 8))
    ob = torch.from_numpy(rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32))
    frames, gaze = train_video(rng, 3 * TRAIN_S)
    clips = [(torch.from_numpy(frames[None, k:k + TRAIN_S]),
              torch.from_numpy(gaze[None, k:k + TRAIN_S])) for k in range(0, 3 * TRAIN_S, TRAIN_S)]
    carried = torch.from_numpy(rng.normal(0.0, 0.5, (1, OUT_H, OUT_W, 256)).astype(np.float32))
    batch = (*clips[0], gauss, ob, carried)
    want = {torch.bfloat16: {"twa_scan": 1, "twa_step": 0, "dwblock": 0},
            None: {"twa_scan": 0, "twa_step": TRAIN_S, "dwblock": 0}}

    # (1) the card against the port on the CPU, f32
    t0 = time.perf_counter()
    on_cpu = one_train_step(torch, kernels, start, batch, cpu)
    cpu_s = time.perf_counter() - t0
    on_card = one_train_step(torch, kernels, start, batch, cuda)
    print(f"train step f32 on the CPU took {cpu_s:.1f} s; loss CPU {on_cpu[0]:.6f}, card "
          f"{on_card[0]:.6f}")
    d = train_diffs(on_cpu, on_card)
    held_train("train step f32, card vs CPU", d, TOL_TRAIN_LOSS, TOL_TRAIN_GRAD,
               TOL_TRAIN_GRAD_LEAF, TOL_TRAIN_BN, TOL_TRAIN_STATE)
    del on_cpu

    # (2) K1 and its gradient against the plain scan, in the same step
    launches = {}
    for dtype, tols in ((torch.bfloat16, (TOL_TRAIN_BF16_LOSS, TOL_TRAIN_BF16_GRAD, None,
                                          TOL_TRAIN_BF16_BN, TOL_TRAIN_BF16_STATE)),
                        (None, (TOL_TRAIN_K1_LOSS, TOL_TRAIN_K1_GRAD, TOL_TRAIN_K1_LEAF,
                                TOL_TRAIN_K1_BN, TOL_TRAIN_K1_STATE))):
        name = "bf16 mixed" if dtype else "f32"
        k1 = one_train_step(torch, kernels, start, batch, cuda, dtype) if dtype else on_card
        plain = one_train_step(torch, kernels, start, batch, cuda, dtype, scan=twa.twa_scan_ref)
        if k1[4] != want[dtype] or any(plain[4].values()):
            fail(f"train step {name}: K1 path launched {k1[4]} (expected {want[dtype]}), plain "
                 f"path {plain[4]} (expected none)")
        held_train(f"train step {name}, K1 vs the plain scan", train_diffs(plain, k1), *tols)
        # (3) the fused dwBlock is refused in train mode
        fused = one_train_step(torch, kernels, start, batch, cuda, dtype, fused=True)
        print(f"train step {name}: launches {k1[4]}, with the fused dwBlock on {fused[4]}")
        if fused[4] != want[dtype]:
            fail(f"train step {name} with the fused dwBlock on launched {fused[4]}, "
                 f"expected {want[dtype]}")
        launches["bf16" if dtype else "f32"] = k1[4]
        launches[("bf16" if dtype else "f32") + " fused"] = fused[4]
    del on_card, k1, plain, fused

    # (4) TBPTT over 3 carried clips; the loss over repeated steps on one clip
    g, o = gauss.to(cuda), ob.to(cuda)
    falls = {}
    for dtype in (None, torch.bfloat16):
        name = "bf16 mixed" if dtype else "f32"
        model = train_model(torch, start, cuda)
        state = create_train_state(model, make_optimizer(model, 1e-3, TRAIN_WD))
        step = make_train_step(state, compute_dtype=dtype)
        rnn = model.init_state(IN_H, IN_W, device=cuda)
        for k, (x, y) in enumerate(clips):
            loss, new = step(x.to(cuda), g, o, rnn, y.to(cuda))
            if new.grad_fn is not None or new.requires_grad or torch.equal(new, rnn):
                fail(f"TBPTT {name}, clip {k}: the carried state is not new detached data")
            rnn = new
        x, y = (t.to(cuda) for t in clips[0])
        losses = [float(step(x, g, o, model.init_state(IN_H, IN_W, device=cuda), y)[0])
                  for _ in range(TRAIN_REPEATS)]
        falls[name] = losses
        print(f"TBPTT {name}: 3 carried clips, state detached; {TRAIN_REPEATS} steps on one clip "
              f"(Adam lr 1e-3): loss " + ", ".join(f"{v:.4f}" for v in losses))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"TBPTT {name}: the loss did not fall over {TRAIN_REPEATS} steps")
    del model, state, step

    # (5) the trainer's own clip loop on in-memory videos, 2 epochs
    save_dir = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(save_dir, ignore_errors=True)
    val_frames, val_gaze = train_video(rng, TRAIN_S)

    def array_video(name, f, gz):
        return (name, f, (gz[..., :1] * 255).astype(np.uint8), gz[..., 1:].astype(np.uint8))

    cfg = TrainConfig(method_name="ChipSmoke", iosize=(IN_H, IN_W, OUT_H, OUT_W), epochs=2)
    trainer = Trainer(cfg, "", "synthetic", save_dir, device="cuda", ob_prior=ob.numpy(),
                      videos={"train": [array_video("train", frames[:2 * TRAIN_S],
                                                    gaze[:2 * TRAIN_S])],
                              "val": [array_video("val", val_frames, val_gaze)]})
    t0 = time.perf_counter()
    trainer.train()
    train_s = time.perf_counter() - t0
    final = os.path.join(save_dir, "ChipSmoke", "ChipSmoke_final.ckpt")
    with open(os.path.join(save_dir, "ChipSmoke", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    epochs = {r["tag"] + str(r["step"]): round(r["value"], 4) for r in logged
              if r["tag"].endswith("mean_loss")}
    if trainer.state.step != 4 or not os.path.exists(final):
        fail(f"the trainer took {trainer.state.step} steps (expected 4) or wrote no {final}")
    served = load_model_for_inference(final, fold_bn=False, device="cuda")
    serve = make_baked_infer_step(served, gauss.numpy(), ob.numpy())
    x = torch.from_numpy(val_frames[None]).to(cuda)
    zero = served.init_state(IN_H, IN_W, device=cuda)
    maps, _ = serve(x, zero)
    trainer.model.eval()
    with torch.no_grad():
        mine, _ = trainer.model(_maybe_normalize(x), g, o, zero)
    same = torch.equal(maps, mine)
    print(f"trainer: 2 epochs of 2 train clips and 1 val clip in {train_s:.1f} s, epoch mean "
          f"losses {epochs}; {final} read back and served: maps of shape {tuple(maps.shape)} "
          f"equal to the trained model's in eval mode: {same} (max abs diff "
          f"{(maps - mine).abs().max().item():.3g})")
    if not same or not torch.isfinite(maps).all():
        fail("the served _final.ckpt does not give the trained model's maps")
    del trainer, served, serve

    # (6) numbers: step times in turns, peak memory, the eval step, a profile
    x, y = (t.to(cuda) for t in clips[0])
    steps, models = {}, {}
    for dtype in (None, torch.bfloat16):
        model = train_model(torch, start, cuda)
        st = create_train_state(model, make_optimizer(model, TRAIN_LR, TRAIN_WD))
        steps[dtype], models[dtype] = make_train_step(st, compute_dtype=dtype), model
    zero = models[None].init_state(IN_H, IN_W, device=cuda)
    windows = {None: [], torch.bfloat16: []}
    for dtype in (None, torch.bfloat16, torch.bfloat16, None):
        windows[dtype] += cuda_windows(lambda: steps[dtype](x, g, o, zero, y), 3)
    peak = {}
    for dtype, step in steps.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(x, g, o, zero, y)
        torch.cuda.synchronize()
        peak[dtype] = (before, torch.cuda.max_memory_allocated())
    eval_ms = cuda_ms(lambda: make_eval_step(models[None])(x, g, o, zero, y), 5)
    for dtype, ws in windows.items():
        ms = float(np.median(ws))
        name = "bf16 mixed" if dtype else "f32"
        print(f"train step {name} (V=1, S={TRAIN_S}, 360x640, uint8 clip on the card): median "
              f"{ms:.3f} ms over {len(ws)} windows of 3 steps (turns f32, bf16, bf16, f32), "
              f"fastest {min(ws):.3f}; {TRAIN_S / ms * 1e3:.1f} training frames/s; memory "
              f"allocated {peak[dtype][0] / 2**30:.3f} GiB before the step, peak "
              f"{peak[dtype][1] / 2**30:.3f} GiB in it")
    print(f"eval step f32 (V=1, S={TRAIN_S}, 360x640): {eval_ms:.3f} ms")

    # the TWA backward's recompute at this step's shape, timed alone
    shape = (1, TRAIN_S, OUT_H, OUT_W, 256)
    xs, gx, w_h, h0 = k1_case(torch, np.random.default_rng(SEED + 8), shape, torch.bfloat16)
    grads_out = [torch.randn_like(xs), torch.randn_like(h0)]

    def recompute():
        args = [xs.requires_grad_(), gx.requires_grad_(), w_h.requires_grad_(), h0]
        with torch.enable_grad():
            outs = twa.twa_scan_ref(*args)
        torch.autograd.grad(outs, args[:3], grads_out)

    recompute_ms = cuda_ms(recompute, 5)
    k1_fwd_ms = cuda_ms(lambda: twa.twa_scan(xs.detach(), gx.detach(), w_h.detach(), h0), 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps[torch.bfloat16](x, g, o, zero, y)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # device events, without the annotations (the optimizer's step) that
    # repeat the time of the kernels launched inside them
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    annotations = [e for e in events if getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events if e not in annotations) / 1e3
    k1_dev = sum(e.self_device_time_total for e in events if "twa_clip_kernel" in e.key) / 1e3
    adam = sum(e.self_device_time_total for e in annotations if "Optimizer.step" in e.key) / 1e3
    bf16_ms = float(np.median(windows[torch.bfloat16]))
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_profile_train.txt"), "w") as f:
        f.write(table)
    print(f"profile of one bf16 train step: build/chip_smoke_profile_train.txt; device time "
          f"{total:.3f} ms ({total / bf16_ms:.1%} of the step's median), Adam's step "
          f"{adam:.3f} ms, K1 (twa_clip_kernel) {k1_dev:.3f} ms ({k1_dev / total:.1%}); K1's "
          f"forward alone {k1_fwd_ms:.3f} ms, the TWA backward's recompute through twa_scan_ref "
          f"alone (bf16, {shape}) {recompute_ms:.3f} ms, {recompute_ms / bf16_ms:.1%} of the "
          f"bf16 step's {bf16_ms:.3f} ms")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from iip_uavsal_saliency_tpu_torch import kernels
        from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
        from iip_uavsal_saliency_tpu_torch.models import recurrent
        from iip_uavsal_saliency_tpu_torch.models.convert import to_jax_variables
        from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
        from iip_uavsal_saliency_tpu_torch.ops import dwblock, twa
        from iip_uavsal_saliency_tpu_torch.ops.layers import DWBlock
        from iip_uavsal_saliency_tpu_torch.runners.infer import (
            load_model_for_inference, predict_videos)
        from iip_uavsal_saliency_tpu_torch.serving.steps import graph_step, make_baked_infer_step
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    import torch.nn.functional as F

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({k: round(v, 2) for k, v in build_s.items()})})")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 2. kernels against their plain versions, and the gradient wrappers
    rng = np.random.default_rng(SEED)
    k1_err = check_k1(torch, kernels, twa, rng)
    k2_err = check_k2(torch, dwblock, rng)
    check_gradients(torch, kernels, dwblock, twa, rng)

    # 3. the main paths at full width
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = random_state_dict(UAVSal(), rng)
    # the seeded network: every agreement below is on this one set of weights
    print(f"seeded weights: {len(weights)} tensors, sum |w| "
          f"{sum(t.double().abs().sum().item() for t in weights.values()):.6f}")
    variables = to_jax_variables(weights)
    gauss = get_gauss_priors(OUT_H, OUT_W, 8)
    ob = rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)
    video = synthetic_video(rng, V * S * CLIPS)
    native = [(NATIVE_H, NATIVE_W)]

    def serve(compute_dtype, fused):
        model = load_model_for_inference(variables, fold_bn=True, device="cuda",
                                         fused_dwblock=fused)
        step = make_baked_infer_step(model, gauss, ob, compute_dtype=compute_dtype)
        seen = []

        def spy(x, state):
            out, new_state = step(x, state)
            seen.append((out.clone(), state.float().clone(), new_state.float().clone()))
            return out, new_state

        return model, step, spy, seen

    def drive(name, model, step, spy, seen, bf16, k2_launches):
        """One main path, the eager step: warm-up clip, counts to 0, the whole
        video through `predict_videos`, counts read and held to the expected
        ones exactly: bf16 takes K1's persistent kernel once per clip, f32 its
        per-frame kernel once per frame. Then the same path replayed from a
        CUDA graph (`drive_graphed`)."""
        predict_videos(step, model, [video[:S]], native, batch_size=4)  # warm-up
        torch.cuda.synchronize()
        taken = []

        def recorder(*args):  # ConvTWA's call of K1, its arguments and results kept
            out = twa.twa_scan(*args)
            taken.append(([a.clone() for a in args], [o.clone() for o in out]))
            return out

        recurrent.twa_scan = recorder
        kernels.reset_launches()
        maps = predict_videos(spy, model, [video], native, batch_size=4)[0]
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        recurrent.twa_scan = twa.twa_scan
        print(f"{name}: {V * S * CLIPS} frames in {CLIPS} clips, launches {launches}")
        want = {"twa_scan": CLIPS if bf16 else 0, "twa_step": 0 if bf16 else S * CLIPS,
                "dwblock": k2_launches}
        if launches != want:
            fail(f"{name}: launched {launches}, expected {want}")
        if maps.shape != (NATIVE_H, NATIVE_W, 1, V * S * CLIPS) or maps.dtype != np.uint8:
            fail(f"{name}: postprocessed output has shape {maps.shape} dtype {maps.dtype}")
        if len(seen) != CLIPS:
            fail(f"{name}: expected {CLIPS} serving steps, saw {len(seen)}")
        for k, (out, st_in, st_out) in enumerate(seen):
            if out.shape != (V, S, OUT_H, OUT_W, 1) or not torch.isfinite(out).all():
                fail(f"{name} clip {k}: saliency of shape {tuple(out.shape)} is not finite")
            if out.min().item() < 0 or out.max().item() > 1:
                fail(f"{name} clip {k}: saliency outside [0, 1]")
            if not torch.isfinite(st_out).all() or torch.equal(st_in, st_out):
                fail(f"{name} clip {k}: the carried state did not change or is not finite")
        if len(taken) != CLIPS:
            fail(f"{name}: ConvTWA called K1 {len(taken)} times in {CLIPS} clips")
        if bf16:
            check_k1_served(torch, twa, name, taken)
        graphed = drive_graphed(name, model, step, want, seen, maps)
        return launches, graphed, torch.cat([o[0, :, :, :, 0] for o, _, _ in seen]).double()

    def drive_graphed(name, model, step, want, seen, maps):
        """The main path as a user runs it: `predict_videos` with the step
        replayed from a CUDA graph (`graph_step`), after one warm-up clip
        that captures it, under the profiler. The kernels that ran on the
        card, counted from the trace, must be the eager run's launches; the
        wrappers must count none (a replay runs without them), and the
        step's own per-replay tally must agree. Its maps must be the eager
        run's bits, and over the same 3 carried clips its saliency and
        state the eager step's bits."""
        from torch.profiler import ProfilerActivity, profile

        graphed = graph_step(step)
        predict_videos(graphed, model, [video[:S]], native, batch_size=4)  # capture
        torch.cuda.synchronize()
        kernels.reset_launches()
        tally = dict(graphed.replayed)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graphed_maps = predict_videos(graphed, model, [video], native, batch_size=4)[0]
            torch.cuda.synchronize()
        traced = kernels.traced_launches(prof)
        counted = dict(kernels.launches)
        tally = {k: n - tally[k] for k, n in graphed.replayed.items()}
        if traced != want:
            fail(f"{name}, graphed: the trace shows {traced} kernel launches, expected {want}")
        if any(counted.values()) or tally != want:
            fail(f"{name}, graphed: the wrappers counted {counted} (expected none) and the "
                 f"replays' tally is {tally} (expected {want})")
        replayed = []

        def keep(x, state):  # the replayed step's outputs, kept before the next replay
            out, new_state = graphed(x, state)
            replayed.append((out.clone(), new_state.float().clone()))
            return out, new_state

        predict_videos(keep, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        sal_diff = max((g.float() - e.float()).abs().max().item()
                       for (g, _), (e, _, _) in zip(replayed, seen))
        state_diff = max((g - e).abs().max().item() for (_, g), (_, _, e) in zip(replayed, seen))
        same_maps = np.array_equal(graphed_maps, maps)
        print(f"{name}, graphed: kernels in the trace {traced}, the replays' tally {tally}; "
              f"against the eager step over {CLIPS} "
              f"carried clips: saliency max abs diff {sal_diff:.3g}, state max abs diff "
              f"{state_diff:.3g}; uint8 maps equal: {same_maps}")
        if len(replayed) != CLIPS or sal_diff != 0 or state_diff != 0 or not same_maps:
            fail(f"{name}: the graphed path does not give the eager step's bits")
        return graphed

    def compare(name, a, b):
        cc = frame_cc(torch, a, b)
        print(f"{name}: CC per frame min {cc.min().item():.6f} mean {cc.mean().item():.6f}, "
              f"max abs diff {(a - b).abs().max().item():.3g}")
        if not cc.min().item() >= CC_MIN:
            fail(f"{name}: min CC {cc.min().item()} < {CC_MIN}")

    # the blocks K2's gate admits at these shapes, from the blocks' own facts,
    # and K2 against its plain version at each of them
    first_clip = torch.from_numpy(video[None, :S]).cuda()
    model16k, step16k, spy16k, seen16k = serve(torch.bfloat16, True)
    print("K2 bf16 at the admitted blocks of one serving step:")
    admitted, taken16k = check_k2_admitted(torch, dwblock, DWBlock, model16k, step16k,
                                           first_clip,
                                           model16k.init_state(IN_H, IN_W, V, device="cuda"))
    needed = {"st_layer.0.stconv_sp.spconv", "st_layer.1.stconv_sp.spconv", "fust_layer.0",
              "fucbst_layer.0"}
    if not needed <= {name for name, _ in admitted}:
        fail(f"the flagship blocks {sorted(needed)} are not all admitted")

    model16, step16, spy16, seen16 = serve(torch.bfloat16, False)
    launches_off, graphed16, sal16 = drive("main path, K2 off (bf16)", model16, step16, spy16,
                                           seen16, True, 0)
    launches_on, graphed16k, sal16k = drive("main path, K2 on (bf16)", model16k, step16k,
                                            spy16k, seen16k, True, len(admitted) * CLIPS)
    model32, step32, spy32, seen32 = serve(None, False)
    launches_f32, _, sal32 = drive("main path, K2 off (f32)", model32, step32, spy32, seen32,
                                   False, 0)
    model32k, step32k, spy32k, seen32k = serve(None, True)
    print("K2 f32 at the admitted blocks of one serving step:")
    if check_k2_admitted(torch, dwblock, DWBlock, model32k, step32k, first_clip,
                         model32k.init_state(IN_H, IN_W, V, device="cuda"))[0] != admitted:
        fail("the gate admits other blocks in f32 than in bf16")
    _, _, sal32k = drive("main path, K2 on (f32)", model32k, step32k, spy32k, seen32k,
                         False, len(admitted) * CLIPS)
    del model32, model32k, step32, step32k, spy32, spy32k
    print(f"f32 map mean {sal32.mean().item():.4g} std {sal32.std().item():.4g}")
    compare("bf16 vs f32 saliency, K2 off", sal16, sal32)
    compare("bf16 K2 on vs f32 saliency", sal16k, sal32)
    compare("bf16 K2 on vs bf16 K2 off saliency", sal16k, sal16)
    compare("f32 K2 on vs f32 K2 off saliency", sal32k, sal32)
    f32_diff = (sal32k - sal32).abs().max().item()
    if not f32_diff <= TOL_F32_PATHS:
        fail(f"f32 saliency with K2 on differs from K2 off by {f32_diff} > {TOL_F32_PATHS}")

    # 4. measurements
    clip = first_clip
    state = model16.init_state(IN_H, IN_W, V, dtype=torch.bfloat16, device="cuda")
    paths = {("off", "eager"): step16, ("off", "graphed"): graphed16,
             ("on", "eager"): step16k, ("on", "graphed"): graphed16k}
    times = {key: [] for key in paths}
    for which in ("off", "on", "on", "off"):  # in turns, on one card
        for how in ("eager", "graphed"):
            step = paths[which, how]
            times[which, how].append(cuda_ms(lambda: step(clip, state), 10))
    for (which, how), (first, second) in times.items():
        print(f"serving step, K2 {which}, {how} (bf16, V={V}, S={S}, 360x640, uint8 clip on "
              f"the card): {first:.3f} and {second:.3f} ms per clip, "
              f"{V * S / first * 1e3:.1f} and {V * S / second * 1e3:.1f} FPS")
    time_host_issue(torch, paths, clip, state)
    time_runner(torch, paths, {"off": model16, "on": model16k}, video, native)
    write_profile(torch, step16, clip, state, "chip_smoke_profile.txt")
    write_profile(torch, step16k, clip, state, "chip_smoke_profile_k2.txt")

    k1_times, k1_bound_ms, k1_bound_by = time_k1(torch, F, twa, rng, 1)
    time_k1(torch, F, twa, rng, 4)
    k2_ms, k2_plain_ms, k2_library_ms, k2_bound_ms, k2_bound_by = time_k2(torch, F, dwblock, rng)
    print(f"K2 bf16 at N,H,W,C,E,Co={K2_FLAGSHIP}, residual: kernel {k2_ms * 1e3:.2f} us/launch, "
          f"plain {k2_plain_ms * 1e3:.2f}, library (three cuDNN convs) {k2_library_ms * 1e3:.2f}, "
          f"bound {k2_bound_ms * 1e3:.2f} ({k2_bound_by})")
    time_k2_admitted(torch, dwblock, taken16k)

    k1_f32 = time_k1_f32(torch, F, twa, rng)

    # 5. training
    train_launches = train_phase(torch, kernels, twa)

    print(smi)
    k1 = {"route": "cuda", "source": "iip_uavsal_saliency_tpu_torch/csrc/twa_scan.cu",
          "replaces": "iip_uavsal_saliency_tpu/ops/pallas_twa.py:147"}
    print(json.dumps({"kernels": [{
        # the persistent kernel: one launch is a clip of S frames of 1x45x80x256 bf16
        "name": "twa_scan", **k1,
        "launches": launches_off["twa_scan"],
        "max_abs_err": k1_err["twa_scan"],
        "ms": k1_times["persistent"][0],
        "plain_ms": k1_times["plain"][0],
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": k1_times["library"][0],
        "frames_per_launch": S,
        "train_step_launches": train_launches["bf16"]["twa_scan"],
    }, {
        # the per-frame kernel as the f32 paths launch it: one frame of 1x45x80x256 f32
        "name": "twa_step", **k1,
        "launches": launches_f32["twa_step"],
        "max_abs_err": k1_err["twa_step"],
        "ms": k1_f32["kernel"],
        "plain_ms": k1_f32["plain"],
        "bound_ms": k1_f32["bound"],
        "bound_by": k1_f32["bound_by"],
        "library_ms": k1_f32["library"],
        "frames_per_launch": 1,
        "train_step_launches": train_launches["f32"]["twa_step"],
    }, {
        "name": "dwblock",
        "route": "cuda",
        "source": "iip_uavsal_saliency_tpu_torch/csrc/dwblock.cu",
        "replaces": "iip_uavsal_saliency_tpu/ops/pallas_dwblock.py:162",
        "launches": launches_on["dwblock"],
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": k2_bound_by,
        "library_ms": k2_library_ms,
        "train_step_launches": train_launches["bf16 fused"]["dwblock"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def time_host_issue(torch, paths, clip, state, calls: int = 21) -> None:
    """The host's time to issue one step, eager against graphed: perf_counter
    around the call alone, no synchronize inside; the queue is drained
    before each call so that no call waits on the card. Median of `calls`
    per path, the paths in turns."""
    secs = {key: [] for key in paths}
    for rep in range(calls):
        for key in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths[key](clip, state)
            secs[key].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    for (which, how), ts in secs.items():
        print(f"host issue time of one step, K2 {which}, {how}: median "
              f"{float(np.median(ts)) * 1e3:.3f} ms, fastest {min(ts) * 1e3:.3f} ms over {calls} "
              f"calls")


def time_runner(torch, paths, models, video, native) -> None:
    """End to end through the pipelined `predict_videos` (clip building on
    the host, pinned copies, serving, postprocess to 540x960 uint8 and the
    copy back), graphed and eager, K2 off and on: host clock from the call
    to its last map on the host, ending in `synchronize()`. The four paths
    in turns (the order reversed every other round), `E2E_RUNS` rounds, over
    the 3 clips of the main path and over `LONG_CLIPS` clips (the same
    frames repeated), whose steady state the short video does not show."""
    from iip_uavsal_saliency_tpu_torch.runners.infer import predict_videos

    long_video = np.concatenate([video] * -(-LONG_CLIPS * S // len(video)))[:LONG_CLIPS * S]
    for vid in (video, long_video):
        secs = {key: [] for key in paths}
        for rep in range(E2E_RUNS):
            for key in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                predict_videos(paths[key], models[key[0]], [vid], native, batch_size=4)
                torch.cuda.synchronize()
                secs[key].append(time.perf_counter() - t0)
        n = len(vid)
        for (which, how), ts in secs.items():
            fps = ", ".join(f"{n / t:.1f}" for t in ts)
            print(f"runner end to end, K2 {which}, {how}: FPS over {n} frames ({n // S} clips), "
                  f"{E2E_RUNS} runs in turns: {fps}; median {n / float(np.median(ts)):.1f}")
    runner_costs(torch, paths[("on", "graphed")], models["on"], long_video, native)


def runner_costs(torch, graphed, model, video, native) -> None:
    """Where the runner's time goes beside the step. (1) The runner alone:
    `predict_videos` with a step that returns a saliency made beforehand
    and does no work, so what is left is building and shipping the clips,
    the postprocess on the card and the copy back, per clip, median of
    `E2E_RUNS`. (2) One graphed K2-on run over the video under the
    profiler: wall time beside the time the serving stream is busy (the
    sum of its kernels and device-to-device copies; the copies to and from
    the host run on streams of their own, beside it, and are counted
    apart); the table goes to build/chip_smoke_profile_runner.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from iip_uavsal_saliency_tpu_torch.runners.infer import predict_videos

    made = torch.rand((V, S, OUT_H, OUT_W, 1), device="cuda")

    def no_work(x, state):
        return made, state

    secs = []
    for _ in range(E2E_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_videos(no_work, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    clips = len(video) // S
    print(f"runner alone (a step that does no work), {clips} clips: "
          + ", ".join(f"{t / clips * 1e3:.3f}" for t in secs)
          + f" ms per clip; median {float(np.median(secs)) / clips * 1e3:.3f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_videos(graphed, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    h2d = sum(e.self_device_time_total for e in device if "HtoD" in e.key) / 1e3
    d2h = sum(e.self_device_time_total for e in device if "DtoH" in e.key) / 1e3
    busy = sum(e.self_device_time_total for e in device) / 1e3 - h2d - d2h
    print(f"runner under the profiler, K2 on, graphed, {clips} clips: wall {wall * 1e3:.3f} ms, "
          f"the serving stream busy {busy:.3f} ms ({busy / (wall * 1e3):.1%}; idle "
          f"{1 - busy / (wall * 1e3):.1%}); copies to the card {h2d:.3f} ms and back "
          f"{d2h:.3f} ms, each on a stream of its own")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke_profile_runner.txt"), "w") as f:
        f.write(table)


def write_profile(torch, step, clip, state, filename: str) -> None:
    """Device time by kernel for one serving step, into build/."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(clip, state)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename), "w") as f:
        f.write(table)
    print(f"profile of one serving step: build/{filename}")


if __name__ == "__main__":
    main()
