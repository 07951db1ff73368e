"""MATLAB `.mat` files (own copy of `iip_uavsal_saliency_tpu/data/matio.py`).

v7.3 files are HDF5 with a 512-byte MATLAB userblock, arrays stored
axis-reversed (column-major) with a `MATLAB_class` attribute, gzip at level
4 for arrays of 16 KiB or more, and dicts as MATLAB structs: the layout of
hdf5storage, in which the reference writes its results and ground truth.
`loadmat` reverses the axes back, so a (H, W, 1, T) `salmap` round-trips,
and reads v5 files (scipy) when the file is not HDF5.

`h5py` is imported inside the functions: importing this module needs it
not, and a machine without it can still serve (it cannot write `.mat`).
"""

from __future__ import annotations

import struct
import time
from typing import Any, Mapping, Optional

import numpy as np

_MATLAB_CLASS = {
    np.dtype(np.uint8): b"uint8",
    np.dtype(np.int8): b"int8",
    np.dtype(np.uint16): b"uint16",
    np.dtype(np.int16): b"int16",
    np.dtype(np.uint32): b"uint32",
    np.dtype(np.int32): b"int32",
    np.dtype(np.uint64): b"uint64",
    np.dtype(np.int64): b"int64",
    np.dtype(np.float32): b"single",
    np.dtype(np.float64): b"double",
    np.dtype(np.bool_): b"logical",
}

# arrays of at least this many bytes are gzip-compressed, as hdf5storage does
_COMPRESS_BYTES = 16384


def _userblock() -> bytes:
    text = ("MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: "
            + time.strftime("%a %b %d %H:%M:%S %Y") + " HDF5 schema 1.00 .").encode("ascii")
    header = text[:116].ljust(116, b" ")
    header += b"\x00" * 8  # subsystem data offset
    header += struct.pack("<H", 0x0200)  # version
    header += b"IM"  # little-endian indicator
    return header.ljust(512, b"\x00")


def _write_h5(group, key: str, value) -> None:
    if isinstance(value, Mapping):  # a MATLAB scalar struct: a group of fields
        g = group.create_group(key)
        g.attrs["MATLAB_class"] = np.bytes_(b"struct")
        for k, v in value.items():
            _write_h5(g, k, v)
        return
    arr = np.asarray(value)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
        mat_class = b"logical"
    else:
        mat_class = _MATLAB_CLASS.get(arr.dtype)
        if mat_class is None:
            raise TypeError(f"unsupported dtype for .mat: {arr.dtype}")
    kw = (dict(compression="gzip", compression_opts=4, chunks=True)
          if arr.ndim and arr.nbytes >= _COMPRESS_BYTES else {})
    ds = group.create_dataset(key, data=arr.T if arr.ndim else arr, **kw)
    ds.attrs["MATLAB_class"] = np.bytes_(mat_class)
    if mat_class == b"logical":
        ds.attrs["MATLAB_int_decode"] = np.int32(1)


def savemat(path: str, data: Mapping[str, Any]) -> None:
    """Write a MATLAB v7.3 (HDF5) file: arrays axis-reversed with their
    MATLAB class, dict values as structs."""
    import h5py

    with h5py.File(path, "w", userblock_size=512) as f:
        for key, value in data.items():
            _write_h5(f, key, value)
    with open(path, "r+b") as f:
        f.write(_userblock())


def loadmat(path: str, key: Optional[str] = None) -> Any:
    """Read a MATLAB file (v7.3 with h5py, v5 with scipy): the dict of its
    variables, or the one variable `key`."""
    import h5py

    try:
        with h5py.File(path, "r") as f:
            if key is not None:
                return _read_h5(f[key])
            return {k: _read_h5(f[k]) for k in f.keys() if not k.startswith("#")}
    except OSError:  # not HDF5: a v5 file
        import scipy.io

        md = scipy.io.loadmat(path)
        if key is not None:
            return md[key]
        return {k: v for k, v in md.items() if not k.startswith("__")}


def _read_h5(ds):
    import h5py

    if isinstance(ds, h5py.Group):  # MATLAB struct -> dict of fields
        return {k: _read_h5(ds[k]) for k in ds.keys()}
    arr = np.asarray(ds)
    return arr.T if arr.ndim > 1 else arr
