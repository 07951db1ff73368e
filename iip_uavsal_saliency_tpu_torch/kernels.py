"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface. It is compiled
with `nvcc` for `sm_90a` into a shared library at first use, under
`build/kernels/` at the repository root (listed in `.gitignore`), and
loaded with `ctypes`. The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is compiled or loaded when this module is imported.

`launches` counts, per kernel function, the launches its wrapper made
(`twa_scan.cu` holds two: `twa_scan`, the persistent kernel, one launch per
clip, and `twa_step`, one launch per frame); a run resets it with
`reset_launches()` and reads it afterwards to show which kernels a path
went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("twa_scan", "dwblock")
KERNELS = ("twa_scan", "twa_step", "dwblock")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: Dict[str, int] = {name: 0 for name in KERNELS}
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel that has no up-to-date library, one `nvcc`
    per source, all started together. Returns the seconds each build took
    (0.0 for a library that was already there); raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib
