"""The ConvTWA scan: kernel K1 and its plain PyTorch version.

`twa_scan` replaces `iip_uavsal_saliency_tpu/ops/pallas_twa.py::twa_scan_pallas`.
For each video v and each frame s in order it computes

    g   = sigmoid(gx_s + conv3x3_same(h_{s-1}, W_h))
    h_s = g * x_s + (1 - g) * h_{s-1}

and returns (ys, h_last) with ys[v, s] = h_s and h_last a copy of ys[:, -1]
(a copy, so that a carried state does not keep the whole clip alive).

On a CUDA tensor it launches one of the two hand-written Hopper kernels of
`csrc/twa_scan.cu`; `kernel_route` says which, from shape and dtype alone:

- `twa_scan`, the persistent kernel, ONE cooperative launch per clip, as the
  TPU kernel is one `pallas_call` per clip. It takes bf16 with C a multiple
  of 32 whenever one image row with its halo fits in shared memory beside
  the block's slice of W_h (`clip_takes`; the kernel source chooses the
  tile height and exports it as `twa_clip_tile_rows`). Each block keeps a
  32-channel slice of W_h on its SM for all S frames, stages the rows of
  h_{s-1} it needs once per tile and reads the 9 taps as shifted views of
  that copy, runs the implicit GEMM (M = H*W pixels, N = C, K = 9*C, f32
  accumulation) on `ldmatrix` + `mma.sync`, and keeps frames in order
  across blocks through per-tile counters in a scratch tensor that this
  wrapper allocates and zeroes.
- `twa_step`, one launch per frame, frames in order on the current stream:
  everything else the kernel takes. f32 runs `twa_step_f32_kernel`, the
  implicit GEMM as 3xTF32 on `wgmma` (small.big + big.small + big.big, f32
  accumulation, the tensor cores' sums folded into f32 every 96 of K), on
  W_h split into TF32 halves and packed by `pack_twa_weights`; bf16 with C
  a multiple of 8 but not of 32, or a halo tile too wide (the 90x160 state
  of 720x1280 serving), runs `twa_step_bf16_kernel`, the implicit GEMM on
  bf16 `wgmma` with f32 accumulation, on W_h packed by
  `pack_twa_weights_bf16`. Either pack is made once per call, or once at
  load by `ConvTWA` for serving.

Both fuse the sigmoid and the lerp into the GEMM's epilogue in f32 and round
once, at the store of h_s; frame s reads h_{s-1} from ys[:, s-1]. At the
flagship 45x80x256 a frame is 4.25 GFLOP, so either is compute-bound on an
H100 (bound ~4.3 us/frame in bf16, 25.7 as 3xTF32); the source's header says what each
design does about it. A video's result does not depend on which other videos
share the launch, so a split of V gives the bits of the whole (the content
of the JAX package's `twa_scan_sharded`). On a CPU tensor `twa_scan` runs
`twa_scan_ref`, the plain loop of `twa_scan_xla`. Any other device raises;
nothing falls back.

On the card (and on the CPU while `torch.export` traces) `twa_scan` is the
custom op `uavsal::twa_scan` (`torch.library`): its CUDA implementation is
the wrapper `_twa_scan_cuda`, its CPU implementation `twa_scan_ref`, and a
fake implementation gives `torch.export` the output shapes, so an exported
serving step holds the scan as one node that the card runs as K1. The op
is differentiable in x, gx, W_h and h0 (counterpart of
`pallas_twa.py::twa_scan`'s custom VJP): its registered backward recomputes
through `twa_scan_ref` in the input dtype; it is not a kernel.

Layouts are the JAX package's: x, gx (V, S, H, W, C), h0 (V, H, W, C) and
W_h (3, 3, C, C) in HWIO order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .dwblock import _ceil_to, tf32_split

_STEP_SIGNATURE = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
_SCAN_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

_SLICE = 32  # the persistent kernel's output channels per block
# The f32 per-frame kernel's packed-weight layout (`twa_f32_layout` in the
# source, which a GPU test holds these against): input channels per chunk
# (C is padded to it), output channels per block (N is padded to it),
# channels per k step and per 16-byte core-matrix row ("plane").
F32_CHUNK = 32
F32_COLUMN_BLOCK = 64
F32_K_STEP = 8
F32_PLANE = 4
# The bf16 per-frame kernel's packed-weight layout (`twa_bf16_layout` in the
# source): input channels per chunk (C is padded to it), output channels per
# block (N is padded to it), channels per 16-byte core-matrix row.
BF16_CHUNK = 64
BF16_COLUMNS = 256
BF16_PLANE = 8


def clip_takes(w: int, c: int) -> bool:
    """Whether the persistent kernel takes frames of width w with c channels:
    c a multiple of 32, and a tile of one image row fits in a block's 227 KB
    of shared memory: 64 bytes for each of the 9*c rows of its W_h slice,
    and for each of the 3*(w+2) pixels of the row with its halo 3 buffers of
    64 bytes and one int. The layout and the tile height are the kernel
    source's (`twa_clip_tile_rows`, 0 exactly where this says no: the tests
    on the card hold the two together)."""
    pixels = 3 * (w + 2)
    smem = 9 * c * 64 + 3 * 64 * (-(-pixels // 8) * 8) + 4 * (-(-pixels // 4) * 4)
    return c % _SLICE == 0 and 1 <= w <= 256 and smem <= 232448


def kernel_route(x_shape: Sequence[int], dtype: torch.dtype) -> str:
    """Which kernel `twa_scan` launches for x of this shape and dtype on a
    CUDA device: "twa_scan" (the persistent kernel, one launch per clip) or
    "twa_step" (one launch per frame). Raises on what neither takes."""
    if len(x_shape) != 5:
        raise ValueError(f"x must be (V, S, H, W, C), got {tuple(x_shape)}")
    v, s, h, w, c = x_shape
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"twa_scan kernel takes bf16 or f32, got {dtype}")
    if c % 8 or min(v, s, h, w) < 1 or h * w * c >= 2 ** 31:
        raise ValueError(f"twa_scan kernel needs C % 8 == 0, V, S, H, W >= 1 and "
                         f"H*W*C < 2^31; got x of shape {tuple(x_shape)}")
    if dtype == torch.bfloat16 and clip_takes(w, c):
        return "twa_scan"
    if v > 65535:
        raise ValueError(f"the per-frame twa_scan kernel takes V <= 65535, got {v}")
    return "twa_step"


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


def packed_twa_size(c: int) -> int:
    """Elements of the blob `pack_twa_weights` makes for C channels."""
    return 2 * 9 * _ceil_to(c, F32_CHUNK) * _ceil_to(c, F32_COLUMN_BLOCK)


def pack_twa_weights(w_h: torch.Tensor) -> torch.Tensor:
    """W_h (3, 3, C, C) f32 in HWIO order, in the byte order the f32
    per-frame kernel wants in shared memory: each weight split by
    `tf32_split` into a big and a small TF32 half, input channels padded
    with zeros to a multiple of 32 (a staged chunk) and output channels to
    a multiple of 64 (a block's columns), so the kernel needs no masks.

    One flat blob, [column block nb][chunk q][tap ky, kx][k8 step j][half
    h][plane p][64 columns n][k]: element is half h of W_h[ky, kx, 32q + 8j
    + 2k + p, 64nb + n]. Within each k8 step the rows are taken in the order
    0 2 4 6 1 3 5 7, so that a thread's two A values of a row (MMA k = t and
    t + 4) are channels 2t, 2t + 1: one 8-byte load. A block reads its
    column block from end to end, one tap of a chunk (16 KB) per bulk copy,
    planes as wgmma's K-major layout without swizzle has them."""
    if w_h.dtype != torch.float32 or w_h.dim() != 4 or w_h.shape[:2] != (3, 3) \
            or w_h.shape[2] != w_h.shape[3]:
        raise ValueError(f"pack_twa_weights takes f32 W_h of shape (3, 3, C, C), got "
                         f"{tuple(w_h.shape)} of {w_h.dtype}")
    c = w_h.shape[-1]
    cp, np_ = _ceil_to(c, F32_CHUNK), _ceil_to(c, F32_COLUMN_BLOCK)
    halves = torch.stack(tf32_split(F.pad(w_h, (0, np_ - c, 0, cp - c))))
    # (h, ky, kx, q, j, k, p, nb, n) -> (nb, q, ky, kx, j, h, p, n, k)
    blob = halves.reshape(2, 3, 3, cp // F32_CHUNK, F32_CHUNK // F32_K_STEP, F32_PLANE, 2,
                          np_ // F32_COLUMN_BLOCK, F32_COLUMN_BLOCK)
    return blob.permute(7, 3, 1, 2, 4, 0, 6, 8, 5).reshape(-1)


def packed_twa_bf16_size(c: int) -> int:
    """Elements of the blob `pack_twa_weights_bf16` makes for C channels."""
    return 9 * _ceil_to(c, BF16_CHUNK) * _ceil_to(c, BF16_COLUMNS)


def pack_twa_weights_bf16(w_h: torch.Tensor) -> torch.Tensor:
    """W_h (3, 3, C, C) bf16 in HWIO order, in the byte order the bf16
    per-frame kernel wants in shared memory: the same bits, input channels
    padded with zeros to a multiple of 64 (a staged chunk) and output
    channels to a multiple of 256 (a block's columns), so the kernel needs
    no masks.

    One flat blob, [chunk q][tap ky, kx][plane j][N columns n][k]: element
    is W_h[ky, kx, 64q + 8j + k, n]. A plane's 8 channels of a column are 16
    bytes, a core-matrix row of wgmma's K-major layout without swizzle; a
    block copies its 256 columns of each plane of a tap of a chunk into one
    slot of its ring."""
    if w_h.dtype != torch.bfloat16 or w_h.dim() != 4 or w_h.shape[:2] != (3, 3) \
            or w_h.shape[2] != w_h.shape[3]:
        raise ValueError(f"pack_twa_weights_bf16 takes bf16 W_h of shape (3, 3, C, C), got "
                         f"{tuple(w_h.shape)} of {w_h.dtype}")
    c = w_h.shape[-1]
    cp, np_ = _ceil_to(c, BF16_CHUNK), _ceil_to(c, BF16_COLUMNS)
    padded = F.pad(w_h, (0, np_ - c, 0, cp - c))
    # (ky, kx, q, j, k, n) -> (q, ky, kx, j, n, k)
    blob = padded.reshape(3, 3, cp // BF16_CHUNK, BF16_CHUNK // BF16_PLANE, BF16_PLANE, np_)
    return blob.permute(2, 0, 1, 3, 5, 4).reshape(-1)


def twa_scan(x: torch.Tensor, gx: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor,
             packed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TWA scan: kernel K1 on a CUDA tensor, `twa_scan_ref` on a CPU one
    (where autograd differentiates the plain version itself). `packed` is
    W_h packed beforehand for the per-frame kernel of x's dtype
    (`pack_twa_weights` for f32, `pack_twa_weights_bf16` for bf16), read by
    that kernel only (without it the wrapper packs once per call); the
    persistent kernel, the backward and the plain version read `w_h`.

    On the card, and on the CPU while `torch.export` traces, it is the
    custom op `uavsal::twa_scan`, so that an exported graph holds one node
    where the scan runs (the op's CPU implementation is `twa_scan_ref`)."""
    if x.device.type == "cpu" and not torch.compiler.is_compiling():
        return twa_scan_ref(x, gx, w_h, h0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"twa_scan runs on cuda or cpu tensors, got {x.device}")
    # normalize at the kernel boundary, as the Pallas wrapper does: an f32
    # initial state or weight beside bf16 streams is cast to the stream dtype
    return torch.ops.uavsal.twa_scan(x, gx, w_h.to(x.dtype), h0.to(x.dtype), packed)


@torch.library.custom_op("uavsal::twa_scan", mutates_args=(), device_types="cpu")
def _twa_scan_op(x: torch.Tensor, gx: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor,
                 packed: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain scan (`packed` is the
    per-frame kernels' alone). Its CUDA implementation is `_twa_scan_cuda`,
    registered below; any other device has none and raises."""
    return twa_scan_ref(x, gx, w_h, h0)


@_twa_scan_op.register_fake
def _twa_scan_fake(x, gx, w_h, h0, packed):
    return torch.empty_like(x), x.new_empty((x.shape[0],) + tuple(x.shape[2:]))


@_twa_scan_op.register_kernel("cuda")
def _twa_scan_op_cuda(x, gx, w_h, h0, packed):
    return _twa_scan_cuda(x, gx, w_h, h0, packed=packed)


def _twa_scan_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs[:4])


def _twa_scan_backward(ctx, grad_ys, grad_last):
    """The kernel's gradient (counterpart of `pallas_twa.py::twa_scan`'s
    custom VJP): recomputed through `twa_scan_ref` in the input dtype; it
    is not a kernel."""
    args = [t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [a for a in args if a.requires_grad]
    with torch.enable_grad():
        outs = twa_scan_ref(*args)
    grads = iter(torch.autograd.grad(outs, wanted, (grad_ys, grad_last)))
    return tuple(next(grads) if a.requires_grad else None for a in args) + (None,)


_twa_scan_op.register_autograd(_twa_scan_backward, setup_context=_twa_scan_setup)


def _lib():
    lib = kernels.load("twa_scan")
    if lib.twa_step_bf16.argtypes is None:
        for fn in (lib.twa_step_bf16, lib.twa_step_f32):
            fn.argtypes = _STEP_SIGNATURE
            fn.restype = ctypes.c_int
        lib.twa_scan_bf16.argtypes = _SCAN_SIGNATURE
        lib.twa_scan_bf16.restype = ctypes.c_int
        lib.twa_clip_tile_rows.argtypes = [ctypes.c_int] * 3
        lib.twa_clip_tile_rows.restype = ctypes.c_int
        lib.twa_error_string.argtypes = [ctypes.c_int]
        lib.twa_error_string.restype = ctypes.c_char_p
        lib.twa_f32_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.twa_f32_layout.restype = None
        lib.twa_bf16_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.twa_bf16_layout.restype = None
    return lib


def _twa_scan_cuda(x, gx, w_h, h0, route=None, packed=None):
    """Launch the kernel `kernel_route` names (`route` overrides it, for the
    checks that hold one kernel against the other) or raise. The per-frame
    kernels read `packed`, or W_h packed here, once for all frames."""
    chosen = kernel_route(x.shape, x.dtype)  # raises on what K1 does not take
    route = route or chosen
    v, s, h, w, c = x.shape
    if gx.shape != x.shape or gx.dtype != x.dtype:
        raise ValueError("gx must match x in shape and dtype")
    if tuple(w_h.shape) != (3, 3, c, c) or tuple(h0.shape) != (v, h, w, c):
        raise ValueError(f"w_h must be (3, 3, {c}, {c}) and h0 ({v}, {h}, {w}, {c})")
    h0, w_h = h0.contiguous(), w_h.contiguous()
    for t in (x, gx, w_h, h0):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("twa_scan kernel needs contiguous, 16-byte aligned "
                             "tensors on one device")
    if route == "twa_step":
        bf16 = x.dtype == torch.bfloat16
        pack = pack_twa_weights_bf16 if bf16 else pack_twa_weights
        if packed is None:
            with torch.no_grad():
                packed = pack(w_h)
        size = (packed_twa_bf16_size if bf16 else packed_twa_size)(c)
        if (packed.shape != (size,) or packed.dtype != x.dtype
                or packed.device != x.device or not packed.is_contiguous()
                or packed.data_ptr() % 16):
            raise ValueError(f"packed W_h must be a flat, contiguous, 16-byte aligned tensor "
                             f"of x's dtype and device with {size} elements ({pack.__name__})")
        w_h = packed
    lib = _lib()
    ys = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "twa_scan":
            _launch_clip(lib, x, gx, w_h, h0, ys, stream)
        else:
            _launch_frames(lib, x, gx, w_h, h0, ys, stream)
    return ys, ys[:, -1].clone()


def _check(lib, rc: int) -> None:
    if rc:
        raise RuntimeError("twa_scan kernel launch failed: "
                           + lib.twa_error_string(rc).decode())


def _launch_clip(lib, x, gx, w_h, h0, ys, stream) -> None:
    v, s, h, w, c = x.shape
    tr = lib.twa_clip_tile_rows(h, w, c)
    if x.dtype != torch.bfloat16 or not tr:
        raise ValueError(f"the persistent twa_scan kernel does not take "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    # frames done per tile, counted by the kernel's blocks
    done = torch.zeros(v * -(-h // tr), dtype=torch.int32, device=x.device)
    _check(lib, lib.twa_scan_bf16(x.data_ptr(), gx.data_ptr(), h0.data_ptr(),
                                  w_h.data_ptr(), ys.data_ptr(), done.data_ptr(),
                                  v, s, h, w, c, stream))
    kernels.launches["twa_scan"] += 1


def _launch_frames(lib, x, gx, w_h, h0, ys, stream) -> None:
    """One launch per frame; `w_h` is the packed blob."""
    v, s, h, w, c = x.shape
    fn = lib.twa_step_bf16 if x.dtype == torch.bfloat16 else lib.twa_step_f32
    hwc = h * w * c
    step = hwc * x.element_size()  # bytes from one frame to the next
    vstride = s * hwc
    for t in range(s):
        if t == 0:
            hprev, hstride = h0.data_ptr(), hwc
        else:
            hprev, hstride = ys.data_ptr() + (t - 1) * step, vstride
        _check(lib, fn(x.data_ptr() + t * step, gx.data_ptr() + t * step, hprev,
                       w_h.data_ptr(), ys.data_ptr() + t * step, vstride, hstride,
                       v, h, w, c, stream))
        kernels.launches["twa_step"] += 1
