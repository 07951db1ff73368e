#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   kernel of the main path from `iip_uavsal_saliency_tpu_torch/csrc/` with
   nvcc for sm_90a, one nvcc per source, all started together.
2. Holds each kernel against its plain PyTorch version on the card:
   K1 (`ops/twa.py::twa_scan`) vs `twa_scan_ref` at the flagship shape
   (V=1, S=20, 45x80x256) in bf16 and f32, and at a ragged shape
   (V=2, S=3, 13x7x24) in bf16 and f32.
3. Drives the port's main path at full width: UAVSal at 360x640 with
   seeded random weights (numpy -> JAX variable tree -> `from_jax_variables`
   -> BatchNorm folded into the convs, through `load_model_for_inference`),
   the baked bf16 serving step, and `predict_videos` over one synthetic
   uint8 video of 3 clips of S=20 frames with the state carried, postprocessed to a native
   540x960 uint8. Launch counts are reset just before and read just after;
   the run must launch K1 exactly 60 times. Outputs must be finite, in
   [0, 1], the state must change from clip to clip, and the bf16 saliency
   must agree with an f32 run of the port on the card (CC >= 0.99 per frame).
4. Times the serving step (ms per clip, FPS) and each kernel (its time per
   launch, its plain version's, one PyTorch call's, and its bound) with CUDA
   events after warm-up, each the median of 7 timed windows, and writes a
   profiler table of one clip to `build/chip_smoke_profile.txt`.

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
        from iip_uavsal_saliency_tpu_torch.ops import twa
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

    # 2. kernels against their plain versions
    rng = np.random.default_rng(SEED)
    k1_err = check_k1(torch, twa, rng)

    # 3. the main path at full width
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = to_jax_variables(random_state_dict(UAVSal(), rng))
    gauss = get_gauss_priors(OUT_H, OUT_W, 8)
    ob = rng.uniform(0.0, 1.0, (OUT_H, OUT_W, 20)).astype(np.float32)
    video = synthetic_video(rng, V * S * CLIPS)

    def serve(compute_dtype):
        model = load_model_for_inference(variables, fold_bn=True, device="cuda")
        step = make_baked_infer_step(model, gauss, ob, compute_dtype=compute_dtype)
        seen = []

        def spy(x, state):
            out, new_state = step(x, state)
            seen.append((out.clone(), state.float().clone(), new_state.float().clone()))
            return out, new_state

        return model, step, spy, seen

    model16, step16, spy16, seen16 = serve(torch.bfloat16)
    predict_videos(step16, model16, [video[:S]], [(NATIVE_H, NATIVE_W)], batch_size=4)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    maps16 = predict_videos(spy16, model16, [video], [(NATIVE_H, NATIVE_W)], batch_size=4)[0]
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"main path: {V * S * CLIPS} frames in {CLIPS} clips, launches {launches}")
    if launches.get("twa_scan") != S * CLIPS:
        fail(f"K1 launched {launches.get('twa_scan')} times on the main path, expected {S * CLIPS}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if maps16.shape != (NATIVE_H, NATIVE_W, 1, V * S * CLIPS) or maps16.dtype != np.uint8:
        fail(f"postprocessed output has shape {maps16.shape} dtype {maps16.dtype}")
    if len(seen16) != CLIPS:
        fail(f"expected {CLIPS} serving steps, saw {len(seen16)}")
    for k, (out, st_in, st_out) in enumerate(seen16):
        if out.shape != (V, S, OUT_H, OUT_W, 1) or not torch.isfinite(out).all():
            fail(f"clip {k}: saliency of shape {tuple(out.shape)} is not finite")
        if out.min().item() < 0 or out.max().item() > 1:
            fail(f"clip {k}: saliency outside [0, 1]")
        if not torch.isfinite(st_out).all() or torch.equal(st_in, st_out):
            fail(f"clip {k}: the carried state did not change or is not finite")

    model32, _, spy32, seen32 = serve(None)
    predict_videos(spy32, model32, [video], [(NATIVE_H, NATIVE_W)], batch_size=4)
    sal16 = torch.cat([o[0, :, :, :, 0] for o, _, _ in seen16]).double()
    sal32 = torch.cat([o[0, :, :, :, 0] for o, _, _ in seen32]).double()
    a = sal16 - sal16.mean(dim=(1, 2), keepdim=True)
    b = sal32 - sal32.mean(dim=(1, 2), keepdim=True)
    cc = (a * b).sum(dim=(1, 2)) / (a.norm(dim=(1, 2)) * b.norm(dim=(1, 2)))
    print(f"bf16 vs f32 saliency: CC per frame min {cc.min().item():.6f} mean "
          f"{cc.mean().item():.6f}, max abs diff {(sal16 - sal32).abs().max().item():.3g}, "
          f"f32 map mean {sal32.mean().item():.4g} std {sal32.std().item():.4g}")
    if not cc.min().item() >= CC_MIN:
        fail(f"bf16 saliency disagrees with f32: min CC {cc.min().item()} < {CC_MIN}")

    # 4. measurements
    clip = torch.from_numpy(video[None, :S]).cuda()
    state = model16.init_state(IN_H, IN_W, V, dtype=torch.bfloat16, device="cuda")
    clip_ms = cuda_ms(lambda: step16(clip, state), 10)
    print(f"serving step (bf16, V={V}, S={S}, 360x640, uint8 clip on the card): "
          f"{clip_ms:.3f} ms per clip, {V * S / clip_ms * 1e3:.1f} FPS")
    print(f"main path end to end (clip building, serving, postprocess to 540x960 uint8): "
          f"{V * S * CLIPS / e2e_s:.1f} FPS over {V * S * CLIPS} frames")
    write_profile(torch, step16, clip, state)

    k1_ms, plain_ms, library_ms, bound_ms, bound_by = time_k1(torch, F, twa, rng)
    print(f"K1 bf16 at 1x{OUT_H}x{OUT_W}x256: kernel {k1_ms * 1e3:.2f} us/frame, plain "
          f"{plain_ms * 1e3:.2f} us/frame, library {library_ms * 1e3:.2f} us/frame, bound "
          f"{bound_ms * 1e3:.2f} us/frame ({bound_by})")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "twa_scan",
        "route": "cuda",
        "source": "iip_uavsal_saliency_tpu_torch/csrc/twa_scan.cu",
        "replaces": "iip_uavsal_saliency_tpu/ops/pallas_twa.py:147",
        "launches": launches["twa_scan"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def write_profile(torch, step, clip, state) -> None:
    """Device time by kernel for one serving step, into build/."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(clip, state)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(table)
    print("profile of one serving step: build/chip_smoke_profile.txt")


if __name__ == "__main__":
    main()
