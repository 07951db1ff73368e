"""The fused inverted-residual dwBlock: kernel K2 and its plain PyTorch version.

Counterpart of `iip_uavsal_saliency_tpu/ops/pallas_dwblock.py`. With
eval-mode BatchNorm folded into the conv weights and biases the block is

    e = relu6(x . W1 + b1)          1x1 expand,  rounded to x.dtype
    d = relu6(dw3x3_same(e) + bd)   depthwise,   rounded to x.dtype
    p = d . W2 + b2 (+ x)           1x1 project, stored as x.dtype

with every product accumulated in f32. Layouts are the JAX package's:
x (N, H, W, C), W1 (C, E), b1 (E,), Wd (3, 3, E), bd (E,), W2 (E, Co),
b2 (Co,), all of x's dtype.

- `dwblock_ref`: the plain version, with the same rounding points.
- `fused_dwblock_kernel`: on a CUDA tensor one launch of the hand-written
  Hopper kernel `csrc/dwblock.cu` (bf16 on wgmma; f32 as 3xTF32 on wgmma),
  which keeps e and d in shared memory; on a CPU tensor `dwblock_ref`. Any
  other device, and anything the kernel does not take, raises; nothing
  falls back.
- `pack_dwblock_weights`: the weights in the byte order the kernel of
  their dtype wants in shared memory (for f32 split into TF32 halves by
  `tf32_split`), made once at load (`DWBlock.pack`) or, where the caller
  has none, by the wrapper on the fly.
- `supports_fused_dwblock`: what the CUDA kernel takes.
- `fused_dwblock`: the differentiable form, the custom op `uavsal::dwblock`
  (`torch.library`, with a fake implementation for `torch.export`, so an
  exported serving step holds the block as one node that the card runs as
  K2). Forward as `fused_dwblock_kernel`; backward recomputes through
  `dwblock_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

# dwblock_bf16 and dwblock_f32: x, the two packed blobs, b2, out; N, H, W,
# C, E, Co, residual; the stream
_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

_DTYPES = (torch.bfloat16, torch.float32)
# The bf16 kernel stages a pixel tile of x with its halo in shared memory
# beside one chunk of e, d and the weights, which bounds C; the f32 kernel
# streams x and takes the same C, so one gate serves both dtypes
# (`static_assert`ed beside `BLay::smem_bytes` in csrc/dwblock.cu).
MAX_C = 352
# The kernels' packed-weight layouts (`dwblock_bf16_layout` and
# `dwblock_f32_layout` in the source, which a GPU test holds these
# against): E columns per chunk, rows of W1 per copy, channels per 16-byte
# core-matrix row ("plane"), output channels per block, and the multiple C
# is padded to (a wgmma k16 in bf16, a k8 in f32).
CHUNK = 64
SLICE_ROWS = 64
PLANE = 8
COLUMN_BLOCK = 256
K_STEP = 16
F32_SLICE_ROWS = 8
F32_PLANE = 4
F32_K_STEP = 8


def supports_fused_dwblock(x_shape: Sequence[int], dtype: torch.dtype, kernel_size: int,
                           stride: int, dilation: int, expand: float, features: int,
                           residual: bool = False) -> bool:
    """Whether the CUDA kernel takes this block: 3x3, stride 1, undilated,
    with an expand conv, bf16 or f32, C, E and Co multiples of 8 (16-byte
    loads), C == Co for a residual, and an x tile that fits shared memory
    (C <= 352). Any N, H, W >= 1."""
    if dtype not in _DTYPES:
        return False
    if kernel_size != 3 or stride != 1 or dilation != 1 or expand == 1:
        return False
    n, h, w, c = x_shape
    e = int(round(c * expand))
    if min(n, h, w, c, e, features) < 1 or c % 8 or e % 8 or features % 8:
        return False
    if residual and c != features:
        return False
    return c <= MAX_C


def dwblock_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor,
                bd: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                residual: bool) -> torch.Tensor:
    """Plain PyTorch version (and the recompute path of the backward): f32
    arithmetic on the inputs' values, e and d rounded to x.dtype, the
    residual added in f32 before the last cast. The depthwise conv is nine
    shifted multiply-adds over the zero-padded e."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    h, w = x.shape[1], x.shape[2]
    e = F.relu6(x.to(f32) @ w1.to(f32) + b1.to(f32)).to(x.dtype)
    ep = F.pad(e.to(f32), (0, 0, 1, 1, 1, 1))
    wdf = wd.to(f32)
    d = None
    for dy in range(3):
        for dx in range(3):
            tap = ep[:, dy:dy + h, dx:dx + w, :] * wdf[dy, dx]
            d = tap if d is None else d + tap
    d = F.relu6(d + bd.to(f32)).to(x.dtype)
    p = d.to(f32) @ w2.to(f32) + b2.to(f32)
    if residual:
        p = p + x.to(f32)
    return p.to(x.dtype)


def _ceil_to(a: int, b: int) -> int:
    return -(-a // b) * b


def tf32_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 `w` as big + small, both TF32 values (the low 13 of the 23
    mantissa bits zero): big is w rounded to TF32 (to nearest, ties away
    from zero, as `cvt.rna.tf32.f32`), small is w - big (exact in f32)
    rounded the same way, so |w - big - small| <= 2^-22 |w|. The f32 kernel
    sums small.big + big.small + big.big of two such operands (3xTF32)."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    big = rna(w)
    return big, rna(w - big)


def pack_dwblock_weights(w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor,
                         bd: torch.Tensor, w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights of the kernel of their dtype (bf16 or f32), laid out
    once in the byte order it wants in shared memory: wgmma's K-major layout
    without swizzle, planes of 16-byte core-matrix rows, zero-padded so that
    the kernel needs no masks on C or E; f32 goes to `_pack_f32`. From W1
    (C, E), b1 (E,), Wd (3, 3, E), bd (E,), W2 (E, Co).

    bf16, with E padded to chunks of 64 and C to a multiple of 16:

    - `w1_blob`, flat [chunk][C/8 planes][64 columns of the chunk][8]:
      element [q, p, n, k] is W1[8p + k, 64q + n]. A bulk copy brings 8
      planes (`SLICE_ROWS` rows of W1, 8 KB) at a time.
    - `w2_blob`, flat, per chunk and per block of 256 output channels: that
      block's W2 rows of the chunk as [8 planes][its columns][8] (element
      [p, n, k] is W2[64q + 8p + k, co0 + n]), then the chunk's b1, bd and
      nine rows of depthwise taps (11 x 64 values). One bulk copy a chunk.
    """
    if w1.dtype == torch.float32:
        return _pack_f32(w1, b1, wd, bd, w2)
    if w1.dtype != torch.bfloat16:
        raise TypeError(f"the dwblock kernel's weights are bf16 or f32, got {w1.dtype}")
    c, e = w1.shape
    co = w2.shape[1]
    cp, ep = _ceil_to(c, K_STEP), _ceil_to(e, CHUNK)
    nq = ep // CHUNK
    w1_blob = (F.pad(w1, (0, ep - e, 0, cp - c))
               .reshape(cp // PLANE, PLANE, nq, CHUNK).permute(2, 0, 3, 1).reshape(-1))
    w2r = F.pad(w2, (0, 0, 0, ep - e)).reshape(nq, CHUNK // PLANE, PLANE, co)
    vectors = _vectors(b1, wd, bd, ep)
    pieces = []
    for co0 in range(0, co, COLUMN_BLOCK):
        pieces += [w2r[..., co0:co0 + COLUMN_BLOCK].permute(0, 1, 3, 2).reshape(nq, -1), vectors]
    return w1_blob, torch.cat(pieces, dim=1).reshape(-1)


def _vectors(b1, wd, bd, ep):
    """Per chunk of 64: its b1, bd and nine rows of taps, (E/64, 11 x 64)."""
    e = b1.shape[0]
    vectors = F.pad(torch.cat([b1[None], bd[None], wd.reshape(9, e)]), (0, ep - e))
    return vectors.reshape(11, ep // CHUNK, CHUNK).permute(1, 0, 2).reshape(ep // CHUNK, -1)


def _pack_f32(w1, b1, wd, bd, w2):
    """f32 (`pack_dwblock_weights`), each weight of W1 and W2 split by
    `tf32_split` into a big and a small half, with C padded to a multiple
    of 8 and E to chunks of 64. Within each group of 8 rows (one k8 step) the
    rows are taken in the order 0 2 4 6 1 3 5 7: plane p of a step holds
    rows 2k + p, k = 0..3, so that the kernel reads a thread's two A values
    (MMA k = t and t + 4) as channels 2t, 2t + 1 of one row.

    - `w1_blob`, flat [chunk q][slice s of C'/8][half h][plane p][64 columns n][k]:
      element is half h of W1[8s + 2k + p, 64q + n]. One bulk copy (4 KB)
      per (chunk, slice), beside that slice of x in the kernel's ring.
    - `w2_blob`, flat, per chunk and per block of 256 output channels: that
      block's W2 rows of the chunk as [half h][16 planes][its columns n][k]
      (plane 2j + p, element half h of W2[64q + 8j + 2k + p, co0 + n]),
      then the chunk's b1, bd and nine rows of taps (11 x 64 values, in
      channel order). One bulk copy a chunk.
    """
    c, e = w1.shape
    co = w2.shape[1]
    cp, ep = _ceil_to(c, F32_K_STEP), _ceil_to(e, CHUNK)
    nq = ep // CHUNK
    w1h = torch.stack(tf32_split(F.pad(w1, (0, ep - e, 0, cp - c))))  # (2, C', E')
    w1_blob = w1h.reshape(2, cp // 8, 4, 2, nq, CHUNK).permute(4, 1, 0, 3, 5, 2).reshape(-1)
    w2h = torch.stack(tf32_split(F.pad(w2, (0, 0, 0, ep - e)))).reshape(2, nq, 8, 4, 2, co)
    vectors = _vectors(b1, wd, bd, ep)
    pieces = []
    for co0 in range(0, co, COLUMN_BLOCK):
        block = w2h[..., co0:co0 + COLUMN_BLOCK]
        pieces += [block.permute(1, 0, 2, 4, 5, 3).reshape(nq, -1), vectors]
    return w1_blob, torch.cat(pieces, dim=1).reshape(-1)


def packed_sizes(c: int, e: int, co: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """Elements of the two blobs `pack_dwblock_weights` makes for `dtype`."""
    nq = _ceil_to(e, CHUNK) // CHUNK
    blocks = _ceil_to(co, COLUMN_BLOCK) // COLUMN_BLOCK
    halves, cp = (2, _ceil_to(c, F32_K_STEP)) if dtype == torch.float32 else (1, _ceil_to(c, K_STEP))
    return (nq * halves * cp * CHUNK,
            nq * (halves * CHUNK * co + blocks * 11 * CHUNK))


def _lib():
    lib = kernels.load("dwblock")
    if lib.dwblock_bf16.argtypes is None:
        for fn in (lib.dwblock_bf16, lib.dwblock_f32):
            fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
        lib.dwblock_error_string.argtypes = [ctypes.c_int]
        lib.dwblock_error_string.restype = ctypes.c_char_p
        for fn in (lib.dwblock_bf16_layout, lib.dwblock_f32_layout):
            fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)] * 5, None
    return lib


def _dwblock_cuda(x, w1, b1, wd, bd, w2, b2, residual: bool, blobs=None) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwblock kernel takes bf16 or f32, got {x.dtype}")
    n, h, w, c = x.shape
    e, co = w1.shape[-1], w2.shape[-1]
    want = {"w1": (c, e), "b1": (e,), "wd": (3, 3, e), "bd": (e,), "w2": (e, co), "b2": (co,)}
    tensors = {"w1": w1, "b1": b1, "wd": wd, "bd": bd, "w2": w2, "b2": b2}
    for name, t in tensors.items():
        if tuple(t.shape) != want[name] or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {want[name]} of {x.dtype}, got "
                             f"{tuple(t.shape)} of {t.dtype}")
    if min(n, h, w, c, e, co) < 1 or c % 8 or e % 8 or co % 8:
        raise ValueError(f"dwblock kernel needs N, H, W >= 1 and C, E, Co multiples of 8; "
                         f"got x {tuple(x.shape)}, E={e}, Co={co}")
    if residual and c != co:
        raise ValueError(f"a residual block needs C == Co, got {c} and {co}")
    if c > MAX_C:
        raise ValueError(f"dwblock kernel stages x in shared memory, which holds at most "
                         f"C={MAX_C}; got C={c}")
    for t in (x, *tensors.values()):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dwblock kernel needs contiguous, 16-byte aligned tensors on one "
                             "device (x as NHWC, which is an NCHW tensor in channels-last "
                             "memory, permuted)")
    if blobs is None:
        blobs = pack_dwblock_weights(w1, b1, wd, bd, w2)
    sizes = packed_sizes(c, e, co, x.dtype)
    for blob, size in zip(blobs, sizes):
        if (blob.shape != (size,) or blob.dtype != x.dtype or blob.device != x.device
                or not blob.is_contiguous() or blob.data_ptr() % 16):
            raise ValueError(f"packed weights must be two flat, contiguous, 16-byte aligned "
                             f"{x.dtype} tensors of {sizes} elements (pack_dwblock_weights)")
    lib = _lib()
    launch = lib.dwblock_bf16 if x.dtype == torch.bfloat16 else lib.dwblock_f32
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), blobs[0].data_ptr(), blobs[1].data_ptr(), b2.data_ptr(),
                    out.data_ptr(), n, h, w, c, e, co, int(bool(residual)), stream)
    if rc:
        raise RuntimeError("dwblock kernel launch failed: "
                           + lib.dwblock_error_string(rc).decode())
    kernels.launches["dwblock"] += 1
    return out


def fused_dwblock_kernel(x, w1, b1, wd, bd, w2, b2, residual: bool,
                         blobs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The block in one pass: kernel K2 on a CUDA tensor, `dwblock_ref` on a
    CPU one. `blobs` are `pack_dwblock_weights` of these weights made
    beforehand (without them the wrapper packs on the fly); the plain
    version reads the weights as they are. Not differentiable; see
    `fused_dwblock`."""
    if x.device.type == "cpu":
        return dwblock_ref(x, w1, b1, wd, bd, w2, b2, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dwblock runs on cuda or cpu tensors, got {x.device}")
    return _dwblock_cuda(x, w1, b1, wd, bd, w2, b2, residual, blobs)


def fused_dwblock(x, w1, b1, wd, bd, w2, b2, residual: bool, blobs=None) -> torch.Tensor:
    """Differentiable fused dwBlock, the custom op `uavsal::dwblock`: the
    kernel forward on a CUDA tensor (`_dwblock_cuda`), the plain version on
    a CPU one, and a backward that recomputes through `dwblock_ref` from
    the plain weights (`blobs` as in `fused_dwblock_kernel`). A
    `torch.export` trace keeps it as one node, which the card runs as K2."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dwblock runs on cuda or cpu tensors, got {x.device}")
    w1_blob, w2_blob = blobs if blobs is not None else (None, None)
    return torch.ops.uavsal.dwblock(x, w1, b1, wd, bd, w2, b2, bool(residual), w1_blob, w2_blob)


@torch.library.custom_op("uavsal::dwblock", mutates_args=(), device_types="cpu")
def _dwblock_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, wd: torch.Tensor,
                bd: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, residual: bool,
                w1_blob: Optional[torch.Tensor], w2_blob: Optional[torch.Tensor]) -> torch.Tensor:
    """The op's CPU implementation: the plain version (the blobs are the
    kernel's alone). Its CUDA implementation is `_dwblock_cuda`, registered
    below; any other device has none and raises."""
    return dwblock_ref(x, w1, b1, wd, bd, w2, b2, residual)


@_dwblock_op.register_fake
def _dwblock_fake(x, w1, b1, wd, bd, w2, b2, residual, w1_blob, w2_blob):
    return x.new_empty(tuple(x.shape[:3]) + (w2.shape[-1],))


@_dwblock_op.register_kernel("cuda")
def _dwblock_op_cuda(x, w1, b1, wd, bd, w2, b2, residual, w1_blob, w2_blob):
    blobs = None if w1_blob is None or w2_blob is None else (w1_blob, w2_blob)
    return _dwblock_cuda(x, w1, b1, wd, bd, w2, b2, residual, blobs)


def _dwblock_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs[:7])
    ctx.residual = inputs[7]


def _dwblock_backward(ctx, grad):
    """The kernel's gradient (counterpart of `pallas_dwblock.py::
    fused_dwblock`'s custom VJP), recomputed through `dwblock_ref`."""
    args = [t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [a for a in args if a.requires_grad]
    with torch.enable_grad():
        out = dwblock_ref(*args, ctx.residual)
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(grads) if a.requires_grad else None for a in args) + (None, None, None)


_dwblock_op.register_autograd(_dwblock_backward, setup_context=_dwblock_setup)
