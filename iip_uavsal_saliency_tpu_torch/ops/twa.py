"""The ConvTWA scan: kernel K1 and its plain PyTorch version.

`twa_scan` replaces `iip_uavsal_saliency_tpu/ops/pallas_twa.py::twa_scan_pallas`.
For each video v and each frame s in order it computes

    g   = sigmoid(gx_s + conv3x3_same(h_{s-1}, W_h))
    h_s = g * x_s + (1 - g) * h_{s-1}

and returns (ys, h_last) with ys[v, s] = h_s and h_last a copy of ys[:, -1]
(a copy, so that a carried state does not keep the whole clip alive).

On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/twa_scan.cu` once per frame, frames in order on the current stream.
Each launch is an implicit-GEMM 3x3 conv (M = H*W pixels, N = C, K = 9*C,
f32 accumulation) with the sigmoid/lerp fused into its epilogue; frame s
reads h_{s-1} from ys[:, s-1]. At the flagship 45x80x256 a frame is 4.25
GFLOP, so the kernel is compute-bound on an H100 (bound ~4.3 us/frame in
bf16); the source's header says what the design does about it. On a CPU
tensor `twa_scan` runs `twa_scan_ref`, the plain loop of
`twa_scan_xla`. Any other device raises; nothing falls back.

Layouts are the JAX package's: x, gx (V, S, H, W, C), h0 (V, H, W, C) and
W_h (3, 3, C, C) in HWIO order.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import kernels

_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def twa_scan_ref(x: torch.Tensor, gx: torch.Tensor, w_h: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch loop, computed in the input dtype (as `twa_scan_xla`)."""
    w = w_h.permute(3, 2, 0, 1)  # HWIO -> OIHW
    h = h0
    ys = []
    for s in range(x.shape[1]):
        conv = F.conv2d(h.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
        gate = torch.sigmoid(gx[:, s] + conv)
        h = gate * x[:, s] + (1.0 - gate) * h
        ys.append(h)
    return torch.stack(ys, 1), h


def twa_scan(x: torch.Tensor, gx: torch.Tensor, w_h: torch.Tensor,
             h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TWA scan: kernel K1 on a CUDA tensor, `twa_scan_ref` on a CPU one."""
    if x.device.type == "cpu":
        return twa_scan_ref(x, gx, w_h, h0)
    if x.device.type != "cuda":
        raise ValueError(f"twa_scan runs on cuda or cpu tensors, got {x.device}")
    return _twa_scan_cuda(x, gx, w_h, h0)


def _lib():
    lib = kernels.load("twa_scan")
    if lib.twa_step_bf16.argtypes is None:
        for fn in (lib.twa_step_bf16, lib.twa_step_f32):
            fn.argtypes = _SIGNATURE
            fn.restype = ctypes.c_int
        lib.twa_error_string.argtypes = [ctypes.c_int]
        lib.twa_error_string.restype = ctypes.c_char_p
    return lib


def _twa_scan_cuda(x, gx, w_h, h0):
    if x.dim() != 5:
        raise ValueError(f"x must be (V, S, H, W, C), got {tuple(x.shape)}")
    v, s, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"twa_scan kernel takes bf16 or f32, got {x.dtype}")
    if c % 8 or s == 0 or h == 0 or w == 0 or v == 0 or v > 65535:
        raise ValueError(f"twa_scan kernel needs C % 8 == 0, S, H, W >= 1 and "
                         f"1 <= V <= 65535; got x of shape {tuple(x.shape)}")
    if gx.shape != x.shape or gx.dtype != x.dtype:
        raise ValueError("gx must match x in shape and dtype")
    if tuple(w_h.shape) != (3, 3, c, c) or tuple(h0.shape) != (v, h, w, c):
        raise ValueError(f"w_h must be (3, 3, {c}, {c}) and h0 ({v}, {h}, {w}, {c})")
    # normalize at the kernel boundary, as the Pallas wrapper does: an f32
    # initial state or weight beside bf16 streams is cast to the stream dtype
    h0 = h0.to(x.dtype).contiguous()
    w_h = w_h.to(x.dtype).contiguous()
    tensors = (x, gx, w_h, h0)
    for t in tensors:
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("twa_scan kernel needs contiguous, 16-byte aligned "
                             "tensors on one device")
    lib = _lib()
    fn = lib.twa_step_bf16 if x.dtype == torch.bfloat16 else lib.twa_step_f32
    ys = torch.empty_like(x)
    hwc = h * w * c
    step = hwc * x.element_size()  # bytes from one frame to the next
    vstride = s * hwc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for t in range(s):
            if t == 0:
                hprev, hstride = h0.data_ptr(), hwc
            else:
                hprev, hstride = ys.data_ptr() + (t - 1) * step, vstride
            rc = fn(x.data_ptr() + t * step, gx.data_ptr() + t * step, hprev,
                    w_h.data_ptr(), ys.data_ptr() + t * step, vstride, hstride,
                    v, h, w, c, stream)
            if rc:
                raise RuntimeError("twa_scan kernel launch failed: "
                                   + lib.twa_error_string(rc).decode())
            kernels.launches["twa_scan"] += 1
    return ys, ys[:, -1].clone()
