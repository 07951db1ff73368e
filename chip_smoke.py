#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the main path from `iip_uavsal_saliency_tpu_torch/csrc/` with
   nvcc for sm_90a, one nvcc per source, all started together.
2. Holds each kernel against its plain PyTorch version on the card:
   K1 (`ops/twa.py::twa_scan`) vs `twa_scan_ref` at the flagship shape
   (V=1, S=20, 45x80x256) in bf16 and f32, and at a ragged shape
   (V=2, S=3, 13x7x24) in bf16 and f32; K2 (`ops/dwblock.py::
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
   the run must launch K1 exactly 60 times. Outputs must be finite, in
   [0, 1], the state must change from clip to clip, and the bf16 saliency
   must agree with an f32 run of the port on the card (CC >= 0.99 per frame).
   The same video then goes through the fused-dwBlock path
   (`load_model_for_inference(..., fused_dwblock=True)`): every DWBlock the
   kernel's gate admits is one launch of K2, so the run must launch K1 60
   times and K2 once per admitted block and clip, exactly; its bf16 maps
   must agree with the f32 run and with the bf16 run without K2 (CC >= 0.99
   per frame), and its f32 maps with the f32 run without K2.
4. Times the serving step with K2 off and on (ms per clip, FPS), the whole
   of `predict_videos` five times per path in turns (host clock), and each
   kernel (its time per launch, its plain version's, one PyTorch call's, and
   its bound) with CUDA events after warm-up, each the median of 7 timed
   windows, and writes a profiler table of one clip of each path to
   `build/chip_smoke_profile.txt` and `build/chip_smoke_profile_k2.txt`.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Any failure exits non-zero
before that line is printed. Needs no network and starts no process that
outlives it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# K1 tolerances, max abs error against twa_scan_ref on the same inputs.
# f32: the kernel and cuDNN (TF32 off) sum 9*C products in different orders.
# bf16: the reference rounds the conv output and the gate to bf16 each step,
# the kernel keeps them in f32; the two drift apart by two bf16 ulps (0.0156)
# of values of order 1 over 20 steps.
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
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

V, S, CLIPS = 1, 20, 3
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
    return float(np.median(times))


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


def check_k1(torch, twa, rng):
    """Phase 2: K1 against twa_scan_ref. Returns the flagship bf16 error."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flagship_err = None
    for (v, s, h, w, c) in [(1, S, OUT_H, OUT_W, 256), (2, 3, 13, 7, 24)]:
        arrays = [rng.normal(0, 0.5, (v, s, h, w, c)), rng.normal(0, 0.5, (v, s, h, w, c)),
                  rng.normal(0, np.sqrt(2.0 / (9 * c)), (3, 3, c, c)),
                  rng.normal(0, 0.5, (v, h, w, c))]
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            args = [torch.tensor(a, dtype=torch.float32).to("cuda", dtype) for a in arrays]
            ys, h_last = twa.twa_scan(*args)
            torch.cuda.synchronize()
            ref, ref_last = twa.twa_scan_ref(*args)
            err = (ys.float() - ref.float()).abs().max().item()
            err_last = (h_last.float() - ref_last.float()).abs().max().item()
            name = str(dtype).replace("torch.", "")
            print(f"K1 {name} V={v} S={s} {h}x{w}x{c}: max_abs_err {err:.3g} "
                  f"(h_last {err_last:.3g}), tolerance {tol}")
            if not (err <= tol and err_last <= tol):
                fail(f"K1 disagrees with twa_scan_ref in {name} at {(v, s, h, w, c)}: {err}")
            if (v, s, c, dtype) == (1, S, 256, torch.bfloat16):
                flagship_err = err
    return flagship_err


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
    block's own packed weights. Returns the admitted (name, shape) list."""
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
        args = (x.permute(0, 2, 3, 1), *m.packed_weights(x.dtype), m.use_res)
        out = dwblock.fused_dwblock_kernel(*args)
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
    return [(name, tuple(x.shape)) for name, _, x in taken]


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
    if kernels.launches != {"twa_scan": 3, "dwblock": 1}:
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
    kernel_ms = cuda_ms(lambda: dwblock.fused_dwblock_kernel(*args, True), 10)
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
    flops = 2.0 * n * h * w * (c * e + 9 * e + e * co)
    bytes_moved = sum(t.numel() for t in args) * 2.0 + n * h * w * co * 2.0
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    bound_ms = max(bound_flops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


def frame_cc(torch, a, b):
    """Pearson CC per frame between two (T, H, W) stacks of maps."""
    a = a - a.mean(dim=(1, 2), keepdim=True)
    b = b - b.mean(dim=(1, 2), keepdim=True)
    return (a * b).sum(dim=(1, 2)) / (a.norm(dim=(1, 2)) * b.norm(dim=(1, 2)))


def time_k1(torch, F, twa, rng):
    """K1 time per frame at the flagship shape in bf16, beside its plain
    version, one PyTorch call per frame (cuDNN conv + sigmoid/lerp) and the
    bound. All in ms per frame. cuDNN picks its fastest algorithm for the
    yardstick (`cudnn.benchmark`, autotuned in the warm-up call)."""
    v, s, h, w, c = 1, S, OUT_H, OUT_W, 256
    dt = torch.bfloat16
    mk = lambda *shape, sd=0.5: torch.tensor(rng.normal(0, sd, shape), dtype=dt, device="cuda")  # noqa: E731
    x, gx, h0 = mk(v, s, h, w, c), mk(v, s, h, w, c), mk(v, h, w, c)
    w_h = mk(3, 3, c, c, sd=np.sqrt(2.0 / (9 * c)))
    kernel_ms = cuda_ms(lambda: twa.twa_scan(x, gx, w_h, h0), 20) / s
    plain_ms = cuda_ms(lambda: twa.twa_scan_ref(x, gx, w_h, h0), 10) / s

    w_oihw = w_h.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xs, gxs = x[0].permute(0, 3, 1, 2), gx[0].permute(0, 3, 1, 2)  # channels-last views
    hp = h0.permute(0, 3, 1, 2)

    def library_frames():
        hh = hp
        for t in range(s):
            g = torch.sigmoid(gxs[t:t + 1] + F.conv2d(hh, w_oihw, padding=1))
            hh = torch.lerp(hh, xs[t:t + 1], g)

    torch.backends.cudnn.benchmark = True
    library_ms = cuda_ms(library_frames, 20) / s
    torch.backends.cudnn.benchmark = False
    flops = 2.0 * v * h * w * 9 * c * c
    bytes_moved = (4.0 * v * h * w * c + 9 * c * c) * 2  # x, gx, h_{s-1}, h_s, W_h
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    bound_ms = max(bound_flops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from iip_uavsal_saliency_tpu_torch import kernels
        from iip_uavsal_saliency_tpu_torch.data.priors import get_gauss_priors
        from iip_uavsal_saliency_tpu_torch.models.convert import to_jax_variables
        from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
        from iip_uavsal_saliency_tpu_torch.ops import dwblock, twa
        from iip_uavsal_saliency_tpu_torch.ops.layers import DWBlock
        from iip_uavsal_saliency_tpu_torch.runners.infer import (
            load_model_for_inference, predict_videos)
        from iip_uavsal_saliency_tpu_torch.serving.steps import make_baked_infer_step
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
    k1_err = check_k1(torch, twa, rng)
    k2_err = check_k2(torch, dwblock, rng)
    check_gradients(torch, kernels, dwblock, twa, rng)

    # 3. the main paths at full width
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = to_jax_variables(random_state_dict(UAVSal(), rng))
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

    def drive(name, model, step, spy, seen, k2_launches):
        """One main path: warm-up clip, counts to 0, the whole video through
        `predict_videos`, counts read and held to the expected ones exactly."""
        predict_videos(step, model, [video[:S]], native, batch_size=4)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        maps = predict_videos(spy, model, [video], native, batch_size=4)[0]
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        print(f"{name}: {V * S * CLIPS} frames in {CLIPS} clips, launches {launches}")
        want = {"twa_scan": S * CLIPS, "dwblock": k2_launches}
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
        return launches, e2e_s, torch.cat([o[0, :, :, :, 0] for o, _, _ in seen]).double()

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
    admitted = check_k2_admitted(torch, dwblock, DWBlock, model16k, step16k, first_clip,
                                 model16k.init_state(IN_H, IN_W, V, device="cuda"))
    needed = {"st_layer.0.stconv_sp.spconv", "st_layer.1.stconv_sp.spconv", "fust_layer.0",
              "fucbst_layer.0"}
    if not needed <= {name for name, _ in admitted}:
        fail(f"the flagship blocks {sorted(needed)} are not all admitted")

    model16, step16, spy16, seen16 = serve(torch.bfloat16, False)
    launches_off, e2e_off, sal16 = drive("main path, K2 off (bf16)", model16, step16, spy16,
                                         seen16, 0)
    launches_on, e2e_on, sal16k = drive("main path, K2 on (bf16)", model16k, step16k, spy16k,
                                        seen16k, len(admitted) * CLIPS)
    model32, step32, spy32, seen32 = serve(None, False)
    _, _, sal32 = drive("main path, K2 off (f32)", model32, step32, spy32, seen32, 0)
    model32k, step32k, spy32k, seen32k = serve(None, True)
    print("K2 f32 at the admitted blocks of one serving step:")
    if check_k2_admitted(torch, dwblock, DWBlock, model32k, step32k, first_clip,
                         model32k.init_state(IN_H, IN_W, V, device="cuda")) != admitted:
        fail("the gate admits other blocks in f32 than in bf16")
    _, _, sal32k = drive("main path, K2 on (f32)", model32k, step32k, spy32k, seen32k,
                         len(admitted) * CLIPS)
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
    times = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):  # in turns, on one card
        step = step16 if which == "off" else step16k
        times[which].append(cuda_ms(lambda: step(clip, state), 10))
    for which, (first, second) in times.items():
        print(f"serving step, K2 {which} (bf16, V={V}, S={S}, 360x640, uint8 clip on the card): "
              f"{first:.3f} and {second:.3f} ms per clip, {V * S / first * 1e3:.1f} and "
              f"{V * S / second * 1e3:.1f} FPS")
    # the host's clock spreads from run to run: the counted runs above, then
    # four more of each path in turns
    e2e = {"off": [e2e_off], "on": [e2e_on]}
    for which in ("off", "on", "on", "off") * 2:
        model, step = (model16, step16) if which == "off" else (model16k, step16k)
        t0 = time.perf_counter()
        predict_videos(step, model, [video], native, batch_size=4)
        torch.cuda.synchronize()
        e2e[which].append(time.perf_counter() - t0)
    for which, secs in e2e.items():
        fps = ", ".join(f"{V * S * CLIPS / t:.1f}" for t in secs)
        print(f"main path end to end, K2 {which} (clip building, serving, postprocess to "
              f"540x960 uint8), FPS over {V * S * CLIPS} frames, 5 runs: {fps}; median "
              f"{V * S * CLIPS / float(np.median(secs)):.1f}")
    write_profile(torch, step16, clip, state, "chip_smoke_profile.txt")
    write_profile(torch, step16k, clip, state, "chip_smoke_profile_k2.txt")

    k1_ms, k1_plain_ms, k1_library_ms, k1_bound_ms, k1_bound_by = time_k1(torch, F, twa, rng)
    print(f"K1 bf16 at 1x{OUT_H}x{OUT_W}x256: kernel {k1_ms * 1e3:.2f} us/frame, plain "
          f"{k1_plain_ms * 1e3:.2f} us/frame, library {k1_library_ms * 1e3:.2f} us/frame, bound "
          f"{k1_bound_ms * 1e3:.2f} us/frame ({k1_bound_by})")
    k2_ms, k2_plain_ms, k2_library_ms, k2_bound_ms, k2_bound_by = time_k2(torch, F, dwblock, rng)
    print(f"K2 bf16 at N,H,W,C,E,Co={K2_FLAGSHIP}, residual: kernel {k2_ms * 1e3:.2f} us/launch, "
          f"plain {k2_plain_ms * 1e3:.2f}, library (three cuDNN convs) {k2_library_ms * 1e3:.2f}, "
          f"bound {k2_bound_ms * 1e3:.2f} ({k2_bound_by})")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "twa_scan",
        "route": "cuda",
        "source": "iip_uavsal_saliency_tpu_torch/csrc/twa_scan.cu",
        "replaces": "iip_uavsal_saliency_tpu/ops/pallas_twa.py:147",
        "launches": launches_off["twa_scan"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": k1_library_ms,
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
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


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
