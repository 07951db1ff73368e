"""Reader of the JAX package's `.ckpt` files (its own copy of the format).

A `.ckpt` is one msgpack document (flax's `msgpack_serialize`): a tree of
dicts whose array leaves are msgpack extension objects. Extension code 1
holds an ndarray and code 3 a numpy scalar, each as the msgpack triple
(shape, dtype name, C-order bytes). `msgpack` is imported inside the
reader: serving from a variables tree does not need it.
"""

from __future__ import annotations

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _array(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # numpy has no bf16: widen the bits to f32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def load_checkpoint(path: str) -> dict:
    """The checkpoint at `path` as a tree of dicts with numpy leaves."""
    import msgpack

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _array(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _array(msgpack, data)[()]
        raise ValueError(f"{path}: msgpack extension type {code} is not part of the checkpoint format")

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
