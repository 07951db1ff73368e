"""Where a launch of the port's fused dwBlock kernel (K2) spends its time.

    python3 -m iip_uavsal_saliency_tpu_torch.tools.k2_probe [--dtype bf16|f32]

On one NVIDIA GPU, at 20x45x80, C=256 -> 256, E=1536, residual, in bf16
(`dwblock_bf16_kernel`) or f32 (`dwblock_f32_kernel`, 3xTF32), times
builds of `csrc/dwblock.cu` with one part of the kernel compiled out
each (`-DDWBLOCK_SKIP=<bit mask>`, see `Part` in the source): the copies
(bf16: the bulk copies of the packed weights, W1 slices and W2 pieces; f32
also the cp.async of x's slices; their mbarriers are then completed by a
plain arrival), the expand `wgmma`, its epilogue (which also lets the
compiler drop the GEMM, whose result is then unused), the depthwise taps,
the project `wgmma`, all four compute parts together, and all five (what
is left is the skeleton: bf16 stages x, and both wait on the barriers and
mbarriers of every chunk, f32 also splits its A operands, and write the
output epilogue).
Those builds give wrong results and only their times are read: the time a
part takes is the full kernel's time less the time without it. Whether K2 is right, and its
time beside its plain version, library call and bound, is `chip_smoke.py`'s
to say.
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
from ..ops.dwblock import _SIGNATURE, pack_dwblock_weights

SHAPE = (20, 45, 80, 256, 1536, 256)  # N, H, W, C, E, Co
PARTS = ["COPIES", "EXPAND", "EXPAND_EPILOGUE", "DEPTHWISE", "PROJECT"]  # as Part
VARIANTS = [[]] + [[p] for p in PARTS] + [PARTS[1:], PARTS]


def us_per_call(fn, reps=5, windows=5):
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
    return float(np.median(times))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    dtype_name = parser.parse_args().dtype
    if not torch.cuda.is_available():
        sys.exit("k2_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    n, h, w, c, e, co = SHAPE
    shapes = [(n, h, w, c), (c, e), (e,), (3, 3, e), (e,), (e, co), (co,), (n, h, w, co)]
    gen = torch.Generator("cuda").manual_seed(0)
    x, w1, b1, wd, bd, w2, b2, out = [torch.randn(s, device="cuda", generator=gen).mul(0.1).to(dtype)
                                      for s in shapes]
    blobs = pack_dwblock_weights(w1, b1, wd, bd, w2)  # kept alive while the pointers are used
    pointers = [t.data_ptr() for t in (x, *blobs, b2, out)]
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, parts in enumerate(VARIANTS):  # one nvcc per build, all started together
            mask = sum(1 << PARTS.index(p) for p in parts)
            lib = os.path.join(tmp, f"lib{i}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DDWBLOCK_SKIP={mask}", "-o", lib,
                   str(kernels.CSRC / "dwblock.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True), lib))
        times = []
        for parts, (proc, lib) in zip(VARIANTS, procs):
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed without {parts}:\n{log}")
            fn = getattr(ctypes.CDLL(lib), f"dwblock_{dtype_name}")
            fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int

            def call():
                rc = fn(*pointers, n, h, w, c, e, co, 1, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            times.append(us_per_call(call))
    full = times[0]
    print(f"K2 {dtype_name} N,H,W,C,E,Co={SHAPE}: {full:.1f} us per launch; without ... "
          f"(and what that part takes)")
    for parts, t in zip(VARIANTS[1:], times[1:]):
        print(f"  {','.join(parts):45s} {t:8.1f} us  ({full - t:7.1f})")


if __name__ == "__main__":
    main()
