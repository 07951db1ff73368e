"""Where a launch of the port's fused dwBlock kernel (K2) spends its time.

    python3 -m iip_uavsal_saliency_tpu_torch.tools.k2_probe

On one NVIDIA GPU, at 20x45x80, C=256 -> 256, E=1536, residual, bf16, times
builds of `csrc/dwblock.cu` with one part compiled out each
(`-DDWBLOCK_SKIP=<bit mask>`, see `Part` in the source): the W1 slice
copies, the expand GEMM, its epilogue (which also removes the GEMM, whose
result is then unused), the depthwise taps, the project GEMM, the
W2/bias/tap copies, and all four compute parts together. Those builds give
wrong results and only their times are read: the time a part takes is the
full kernel's time less the time without it. Whether K2 is right, and its
time beside its plain version, library call and bound, is `chip_smoke.py`'s
to say.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import kernels
from ..ops.dwblock import _SIGNATURE

SHAPE = (20, 45, 80, 256, 1536, 256)  # N, H, W, C, E, Co
PARTS = ["W1_COPIES", "EXPAND", "EXPAND_EPILOGUE", "DEPTHWISE", "PROJECT", "W2_COPIES"]  # as Part
VARIANTS = [[]] + [[p] for p in PARTS] + [["EXPAND", "EXPAND_EPILOGUE", "DEPTHWISE", "PROJECT"]]


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
    if not torch.cuda.is_available():
        sys.exit("k2_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    n, h, w, c, e, co = SHAPE
    shapes = [(n, h, w, c), (c, e), (e,), (3, 3, e), (e,), (e, co), (co,), (n, h, w, co)]
    gen = torch.Generator("cuda").manual_seed(0)
    tensors = [torch.randn(s, device="cuda", generator=gen).mul(0.1).bfloat16() for s in shapes]
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
            fn = ctypes.CDLL(lib).dwblock_bf16
            fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int

            def call():
                rc = fn(*[t.data_ptr() for t in tensors], n, h, w, c, e, co, 1,
                        torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            times.append(us_per_call(call))
    full = times[0]
    print(f"K2 bf16 N,H,W,C,E,Co={SHAPE}: {full:.1f} us per launch; without ... "
          f"(and what that part takes)")
    for parts, t in zip(VARIANTS[1:], times[1:]):
        print(f"  {','.join(parts):45s} {t:8.1f} us  ({full - t:7.1f})")


if __name__ == "__main__":
    main()
