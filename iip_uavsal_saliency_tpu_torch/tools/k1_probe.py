"""Where a frame of the port's persistent ConvTWA kernel (K1) spends its time.

    python3 -m iip_uavsal_saliency_tpu_torch.tools.k1_probe

On one NVIDIA GPU, at 1x20x45x80x256 and 4x20x45x80x256 in bf16, times
builds of `csrc/twa_scan.cu` with parts of the persistent kernel compiled
out (`-DCLIP_SKIP=<bit mask>`, see `Part` in the source): the mma, the
ldmatrix loads, the copies of h_{s-1}, the epilogue, the wait for other
blocks, the fences, the epilogue's operand loads. Those builds give wrong
results and only their times are read (us per frame, median and fastest of
14 windows of 10 clips, the builds in turns): the time a part takes is the
time with it less the time without it. Whether K1 is right, and its time
beside its plain version, library call and bound, is `chip_smoke.py`'s to
say.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import kernels
from ..ops.twa import _SCAN_SIGNATURE

SHAPES = [(1, 20, 45, 80, 256), (4, 20, 45, 80, 256)]  # V, S, H, W, C
PARTS = ["MMA", "LDSM", "STAGING", "EPILOGUE", "ORDER", "FENCE", "OPERANDS"]  # as Part
VARIANTS = [[], ["MMA"], ["MMA", "LDSM"], ["MMA", "LDSM", "STAGING"],
            ["MMA", "LDSM", "STAGING", "OPERANDS"], ["MMA", "LDSM", "STAGING", "EPILOGUE"],
            ["OPERANDS"], ["ORDER"], ["FENCE"]]


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


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, parts in enumerate(VARIANTS):  # one nvcc per build, all started together
            mask = sum(1 << PARTS.index(p) for p in parts)
            lib = os.path.join(tmp, f"lib{i}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DCLIP_SKIP={mask}", "-o", lib,
                   str(kernels.CSRC / "twa_scan.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), lib))
        libs = []
        for parts, (proc, lib) in zip(VARIANTS, procs):
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed without {parts}:\n{log}")
            lib = ctypes.CDLL(lib)
            lib.twa_scan_bf16.argtypes, lib.twa_scan_bf16.restype = _SCAN_SIGNATURE, ctypes.c_int
            libs.append(lib)

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

            times = [[] for _ in libs]
            for i in list(range(len(libs))) + list(reversed(range(len(libs)))):
                times[i] += us_windows(lambda: clip(libs[i]))
            print(f"K1 persistent, bf16 at {shape}, us per frame: median (fastest window); "
                  f"without ...")
            for parts, t in zip(VARIANTS, times):
                print(f"  {','.join(parts) or 'whole kernel':40s} {np.median(t) / s:7.2f} "
                      f"({min(t) / s:.2f})")


if __name__ == "__main__":
    main()
