"""Where the port's ConvTWA kernel (K1) spends its time.

    python3 -m iip_uavsal_saliency_tpu_torch.tools.k1_probe [--dtype bf16|f32] [--route clip|step]

On one NVIDIA GPU, times builds of `csrc/twa_scan.cu` with parts of a
kernel compiled out; those builds give wrong results and only their times
are read: the time a part takes is the time with it less the time without
it. The builds run in turns, one `nvcc` each, all started together.

- bf16 (`--route clip`, the default): the persistent kernel at
  1x20x45x80x256 and 4x20x45x80x256 (`-DCLIP_SKIP=<bit mask>`, see `Part`
  in the source): the mma, the ldmatrix loads, the copies of h_{s-1}, the
  epilogue, the wait for other blocks, the fences, the epilogue's operand
  loads. us per frame, median and fastest of 14 windows of 10 clips.
- f32, and bf16 with `--route step`: the per-frame kernel at one
  45x80x256 frame, V = 1 and 4 (bf16 also one 90x160x256 frame, 720x1280
  serving's), (`-DSTEP_SKIP=<bit mask>`, see `StepPart`): the wgmma, the
  ring's bulk copies, the ring's mbarrier handshake (with the copies), the
  staging of h_{s-1}, the epilogue's loads and gate; f32 also A's loads and
  splits and the folds of the tensor cores' sums (the bf16 kernel's wgmma
  reads A from shared memory itself and sums all of K). us per launch,
  median and fastest of 14 windows of 20 launches.

Whether K1 is right, and its time beside its plain version, library call
and bound, is `chip_smoke.py`'s to say.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import kernels
from ..ops.twa import _SCAN_SIGNATURE, _STEP_SIGNATURE, pack_twa_weights, pack_twa_weights_bf16

SHAPES = [(1, 20, 45, 80, 256), (4, 20, 45, 80, 256)]  # V, S, H, W, C
PARTS = ["MMA", "LDSM", "STAGING", "EPILOGUE", "ORDER", "FENCE", "OPERANDS"]  # as Part
VARIANTS = [[], ["MMA"], ["MMA", "LDSM"], ["MMA", "LDSM", "STAGING"],
            ["MMA", "LDSM", "STAGING", "OPERANDS"], ["MMA", "LDSM", "STAGING", "EPILOGUE"],
            ["OPERANDS"], ["ORDER"], ["FENCE"]]
STEP_SHAPES = {"f32": [(1, 45, 80, 256), (4, 45, 80, 256)],  # V, H, W, C: one frame
               "bf16": [(1, 45, 80, 256), (4, 45, 80, 256), (1, 90, 160, 256)]}
STEP_PARTS = ["MMA", "SPLIT", "FOLD", "COPIES", "HANDSHAKE", "STAGING", "EPILOGUE"]  # as StepPart
STEP_VARIANTS = {
    "f32": ([[]] + [[p] for p in STEP_PARTS if p != "HANDSHAKE"]
            + [["COPIES", "HANDSHAKE"], ["MMA", "SPLIT"],
               ["MMA", "SPLIT", "FOLD", "COPIES", "HANDSHAKE", "STAGING"]]),
    "bf16": [[], ["MMA"], ["COPIES"], ["COPIES", "HANDSHAKE"], ["STAGING"], ["EPILOGUE"],
             ["MMA", "COPIES", "HANDSHAKE", "STAGING"]],
}


def us_windows(fn, reps=10, windows=7):
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
        times.append(start.elapsed_time(end) / reps * 1e3)
    return times


def build_variants(tmp, macro, parts, variants):
    """One library per variant, `-D<macro>=<mask of the parts left out>`."""
    procs = []
    for i, left_out in enumerate(variants):
        mask = sum(1 << parts.index(p) for p in left_out)
        lib = os.path.join(tmp, f"lib{i}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-D{macro}={mask}", "-o", lib,
               str(kernels.CSRC / "twa_scan.cu")]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib))
    libs = []
    for left_out, (proc, lib) in zip(variants, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed without {left_out}:\n{log}")
        libs.append(ctypes.CDLL(lib))
    return libs


def in_turns(libs, call, reps):
    """Each build timed in turns, forward then backward: 14 windows each."""
    times = [[] for _ in libs]
    for i in list(range(len(libs))) + list(reversed(range(len(libs)))):
        times[i] += us_windows(lambda: call(libs[i]), reps)
    return times


def probe_bf16(tmp, stream):
    libs = build_variants(tmp, "CLIP_SKIP", PARTS, VARIANTS)
    for lib in libs:
        lib.twa_scan_bf16.argtypes, lib.twa_scan_bf16.restype = _SCAN_SIGNATURE, ctypes.c_int
    for shape in SHAPES:
        v, s, h, w, c = shape
        gen = torch.Generator("cuda").manual_seed(0)
        x, gx, h0 = (torch.randn(sh, device="cuda", generator=gen).mul(0.5).bfloat16()
                     for sh in (shape, shape, (v, h, w, c)))
        w_h = torch.randn((3, 3, c, c), device="cuda", generator=gen).mul(0.03).bfloat16()
        ys = torch.empty_like(x)
        tiles = v * -(-h // libs[0].twa_clip_tile_rows(h, w, c))

        def clip(lib):
            done = torch.zeros(tiles, dtype=torch.int32, device="cuda")
            rc = lib.twa_scan_bf16(x.data_ptr(), gx.data_ptr(), h0.data_ptr(), w_h.data_ptr(),
                                   ys.data_ptr(), done.data_ptr(), v, s, h, w, c, stream)
            assert rc == 0, rc

        times = in_turns(libs, clip, 10)
        print(f"K1 persistent, bf16 at {shape}, us per frame: median (fastest window); "
              f"without ...")
        for parts, t in zip(VARIANTS, times):
            print(f"  {','.join(parts) or 'whole kernel':40s} {np.median(t) / s:7.2f} "
                  f"({min(t) / s:.2f})")


def probe_step(tmp, stream, dtype_name):
    """The per-frame kernel of `dtype_name` by part, one frame per launch."""
    variants = STEP_VARIANTS[dtype_name]
    libs = build_variants(tmp, "STEP_SKIP", STEP_PARTS, variants)
    name = f"twa_step_{dtype_name}"
    for lib in libs:
        getattr(lib, name).argtypes, getattr(lib, name).restype = _STEP_SIGNATURE, ctypes.c_int
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    pack = pack_twa_weights_bf16 if dtype_name == "bf16" else pack_twa_weights
    for v, h, w, c in STEP_SHAPES[dtype_name]:
        gen = torch.Generator("cuda").manual_seed(0)
        x, gx, hprev = (torch.randn((v, h, w, c), device="cuda", generator=gen).mul(0.5).to(dtype)
                        for _ in range(3))
        packed = pack(torch.randn((3, 3, c, c), device="cuda", generator=gen).mul(0.03)
                      .to(dtype))
        out = torch.empty_like(x)
        hwc = h * w * c

        def frame(lib):
            rc = getattr(lib, name)(x.data_ptr(), gx.data_ptr(), hprev.data_ptr(),
                                    packed.data_ptr(), out.data_ptr(), hwc, hwc, v, h, w, c,
                                    stream)
            assert rc == 0, rc

        times = in_turns(libs, frame, 20)
        full = float(np.median(times[0]))
        print(f"K1 per-frame kernel, {dtype_name} at V={v} {h}x{w}x{c}, us per launch: median "
              f"(fastest window); without ... (and what that part takes)")
        for parts, t in zip(variants, times):
            print(f"  {','.join(parts) or 'whole kernel':45s} {np.median(t):8.2f} ({min(t):.2f})"
                  f"  ({full - np.median(t):7.2f})")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    parser.add_argument("--route", choices=["clip", "step"], default=None,
                        help="the persistent kernel (bf16 only; the default for bf16) or the "
                             "per-frame kernel (the default for f32)")
    args = parser.parse_args()
    route = args.route or ("clip" if args.dtype == "bf16" else "step")
    if route == "clip" and args.dtype != "bf16":
        parser.error("the persistent kernel is bf16 only")
    if not torch.cuda.is_available():
        sys.exit("k1_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        if route == "clip":
            probe_bf16(tmp, stream)
        else:
            probe_step(tmp, stream, args.dtype)


if __name__ == "__main__":
    main()
