"""Checkpoints in the JAX package's `.ckpt` format, with the port's own
msgpack codec (counterpart of `iip_uavsal_saliency_tpu/training/checkpoint.py`).

A `.ckpt` is one msgpack document as `flax.serialization.msgpack_serialize`
writes it: a tree of maps with string keys whose array leaves are msgpack
extension objects. Extension code 1 holds an ndarray and code 3 a numpy
scalar, each as the msgpack array (shape, dtype name, C-order bytes). The
codec here covers what such a file holds: map, array, str, bin, int,
float, nil, bool and those two extension types. It needs no package, so a
checkpoint trained on a machine without `msgpack` is read back there.

- `load_checkpoint(path)`: the tree with numpy leaves (bf16 widened to f32).
- `save_checkpoint(path, payload)`: written through `<path>.tmp` and
  `os.replace`, so a crash never leaves a torn file. torch tensors and
  numpy arrays become ndarray extensions, numpy scalars scalar extensions.
- `latest_checkpoint(model_dir, prefix)`: the newest epoch checkpoint.

The `_best`/`_final` files the trainer writes hold `{params, batch_stats}`
in the JAX tree (`models/convert.py::to_jax_variables`), which the JAX
package's `load_checkpoint` reads too.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Optional

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, data: bytes, ext_hook=None):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack document")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        if b in _SCALAR_FORMATS:
            return self.unpack(_SCALAR_FORMATS[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(_LEN_FORMATS[b])))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(_LEN_FORMATS[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(_LEN_FORMATS[b]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(_LEN_FORMATS[b]))
        if b in _FIXEXT_SIZES:
            return self.ext(_FIXEXT_SIZES[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(_LEN_FORMATS[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not part of the checkpoint format")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack extension type {code} inside an extension")
        return self.ext_hook(code, data)


_SCALAR_FORMATS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN_FORMATS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
                0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
                0xDF: ">I"}
_FIXEXT_SIZES = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(data: bytes, ext_hook=None) -> Any:
    """One msgpack document -> Python objects (str keys, bytes for bin)."""
    reader = _Reader(data, ext_hook)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def _array(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # numpy has no bf16: widen the bits to f32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


# ---------------------------------------------------------------- encoding


def _int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"{v} does not fit in msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"{v} does not fit in msgpack's int64")


def _sized(out: list, n: int, fix_base: Optional[int], fix_max: int, codes) -> None:
    """The header of a str/bin/array/map of n items: its fix form when it
    has one and n fits, else the first of (code, format, max) that holds n."""
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack(">B", fix_base | n))
        return
    for code, fmt, top in codes:
        if n <= top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack object of {n} items or bytes is too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _ext(out: list, code: int, data: bytes) -> None:
    sizes = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in sizes:
        out.append(struct.pack(">B", sizes[len(data)]))
    else:
        _sized(out, len(data), None, 0, _EXT)
    out.append(struct.pack(">b", code) + data)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"arrays of dtype {a.dtype} have no checkpoint encoding")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(out: list, v: Any) -> None:
    # numpy types first: np.float64 is also a Python float, and flax packs
    # every numpy scalar as an extension
    if isinstance(v, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _sized(out, len(raw), 0xA0, 31, _STR)
        out.append(raw)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        _sized(out, len(raw), None, 0, _BIN)
        out.append(raw)
    elif isinstance(v, dict):
        _sized(out, len(v), 0x80, 15, _MAP)
        for k, item in v.items():
            _pack(out, k)
            _pack(out, item)
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), 0x90, 15, _ARR)
        for item in v:
            _pack(out, item)
    elif hasattr(v, "detach") and hasattr(v, "cpu"):  # a torch tensor
        _pack(out, v.detach().cpu().numpy())
    else:
        raise TypeError(f"{type(v).__name__} has no checkpoint encoding")


def packb(obj: Any) -> bytes:
    """Python objects -> one msgpack document (the types listed above)."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


# ---------------------------------------------------------------- files


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array(data)
    if code == _EXT_NPSCALAR:
        return _array(data)[()]
    raise ValueError(f"msgpack extension type {code} is not part of the checkpoint format")


def load_checkpoint(path: str) -> dict:
    """The checkpoint at `path` as a tree of dicts with numpy leaves."""
    with open(path, "rb") as f:
        return unpackb(f.read(), _ext_hook)


def save_checkpoint(path: str, payload: dict) -> None:
    """Write `payload` (a tree of dicts with array, tensor and scalar
    leaves) to `path`, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def latest_checkpoint(model_dir: str, prefix: str) -> Optional[str]:
    """The `<prefix>_<epoch>_<loss>.ckpt` of the highest epoch, or None."""
    if not os.path.isdir(model_dir):
        return None
    pat = re.compile(re.escape(prefix) + r"_(\d+)_(-?(?:[\d.]+|inf|nan))\.ckpt$")
    best = None
    for f in os.listdir(model_dir):
        m = pat.match(f)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), f)
    return os.path.join(model_dir, best[1]) if best else None
