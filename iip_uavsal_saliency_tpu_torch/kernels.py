"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface. It is compiled
with `nvcc` for `sm_90a` into a shared library at first use, under
`build/kernels/` at the repository root (listed in `.gitignore`), and
loaded with `ctypes`. The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is compiled or loaded when this module is imported.

`launches` counts, per kernel function, the launches its wrapper made
(`twa_scan.cu` holds two: `twa_scan`, the persistent kernel, one launch per
clip, and `twa_step`, one launch per frame, whose f32 and bf16 device
functions count together); a run resets it with
`reset_launches()` and reads it afterwards to show which kernels a path
went through. The wrappers count where they launch, and nowhere else: a
launch recorded into a CUDA graph counts once, at its capture, and the
graph's replays (`serving/steps.py::GraphedStep`) run without the wrappers
and count nothing here. `traced_launches` counts, from a profiler trace,
the launches that ran on the card, replays included; `graph_launches`
counts the kernel nodes of a captured graph, what each replay launches,
and `trace_shows_graph` holds a trace of replays to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("twa_scan", "dwblock")
KERNELS = ("twa_scan", "twa_step", "dwblock")
# the device functions behind each count, by the names a profiler gives them
SYMBOLS = {"twa_scan": ("twa_clip_kernel",),
           "twa_step": ("twa_step_f32_kernel", "twa_step_bf16_kernel"),
           "dwblock": ("dwblock_f32_kernel", "dwblock_bf16_kernel")}
# a device function's name inside a mangled symbol (after its length)
_MANGLED_SYMBOL = re.compile(r"(?<![A-Za-z_])(%s)(?![a-z0-9_])"
                             % "|".join(s for syms in SYMBOLS.values() for s in syms))
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


def traced_launches(prof) -> Dict[str, int]:
    """Per kernel, the launches of its device functions that ran on the card
    under `prof`, a finished `torch.profiler.profile` that traced CUDA: the
    count of its device events named after them, kernels replayed from a
    CUDA graph included."""
    from torch.autograd import DeviceType

    pattern = re.compile(r"\b(%s)\b" % "|".join(s for syms in SYMBOLS.values() for s in syms))
    owner = {sym: name for name, syms in SYMBOLS.items() for sym in syms}
    counts = {name: 0 for name in KERNELS}
    for event in prof.key_averages():
        found = pattern.search(event.key)
        if found and event.device_type == DeviceType.CUDA:
            counts[owner[found.group(1)]] += event.count
    return counts


def trace_shows_graph(traced: Dict[str, int], per_replay: Dict[str, int],
                      replays: int) -> bool:
    """Whether `traced_launches` of a trace over `replays` replays of one
    CUDA graph shows the graph's kernels running on the card: each kernel
    that the graph launches `n` > 0 times (`graph_launches`) at least once
    and at most `replays * n` times, and no other. The profiler can drop
    records (1 of 88 in one run, 20 of 60 in another), so how many launches
    a replay runs is read from the graph's own nodes, not from the trace."""
    return all(1 <= traced.get(k, 0) <= replays * n if n else traced.get(k, 0) == 0
               for k, n in ((k, per_replay.get(k, 0)) for k in set(traced) | set(per_replay)))


def kernel_of_symbol(symbol: str) -> Optional[str]:
    """The kernel (a name in `KERNELS`) whose device function a mangled
    symbol names, else None. In a mangled name the function's name follows
    its length and is followed by no identifier character of its own."""
    found = _MANGLED_SYMBOL.search(symbol)
    return next((name for name, syms in SYMBOLS.items() if found.group(1) in syms), None) \
        if found else None


def graph_launches(graph) -> Dict[str, int]:
    """Per kernel, the kernel nodes of a captured CUDA graph that run its
    device functions, child graphs included: the launches of one replay.
    `graph` is a `torch.cuda.CUDAGraph(keep_graph=True)` after its capture
    (`raw_cuda_graph`); the nodes and their functions' (mangled) names are
    read through `libcuda`'s graph API."""
    cuda = _libcuda()
    counts = {name: 0 for name in KERNELS}

    def check(result, what):
        if result != 0:
            raise RuntimeError(f"{what} failed with CUresult {result}")

    def walk(handle):
        n = ctypes.c_size_t(0)
        check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(cuda.cuGraphGetNodes(handle, ctypes.cast(nodes, ctypes.c_void_p),
                                   ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
            if kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
                child = ctypes.c_void_p()
                check(cuda.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                      "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
            elif kind.value == _CU_GRAPH_NODE_TYPE_KERNEL:
                params = _KernelNodeParams()
                check(cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
                      "cuGraphKernelNodeGetParams")
                name = ctypes.c_char_p()
                if params.kern:
                    check(cuda.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
                else:
                    check(cuda.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
                kernel = kernel_of_symbol((name.value or b"").decode(errors="replace"))
                if kernel:
                    counts[kernel] += 1

    walk(graph.raw_cuda_graph())
    return counts


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_GRAPH_NODE_TYPE_GRAPH = 4


def _libcuda() -> ctypes.CDLL:
    """`libcuda` with the signatures `graph_launches` calls (every
    handle a pointer: passed bare, ctypes would cut it to a C int)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    vp, out = ctypes.c_void_p, ctypes.POINTER
    for fn, args in (("cuGraphGetNodes", [vp, vp, out(ctypes.c_size_t)]),
                     ("cuGraphNodeGetType", [vp, out(ctypes.c_int)]),
                     ("cuGraphChildGraphNodeGetGraph", [vp, out(vp)]),
                     ("cuGraphKernelNodeGetParams_v2", [vp, out(_KernelNodeParams)]),
                     ("cuKernelGetName", [out(ctypes.c_char_p), vp]),
                     ("cuFuncGetName", [out(ctypes.c_char_p), vp])):
        getattr(cuda, fn).argtypes = args
        getattr(cuda, fn).restype = ctypes.c_int
    return cuda


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


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
    # the source and the headers it may include from csrc/
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
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
