"""The reference's binary NDArray list format (``.params`` files).

The port's copy of the reference package's ``ndarray/legacy_format.py``
(a module without jax, copied so that the port imports nothing of the
reference), byte for byte the layout of MXNet's ``NDArray::Save``:

* file header: uint64 ``0x112`` magic, uint64 reserved 0
* uint64 array count, then per array:
  - uint32 ``0xF993FAC8`` (NDARRAY_V1_MAGIC, int64-dim shape) followed
    by uint32 ndim + int64 dims; OR the legacy V0 form where the first
    uint32 *is* ndim followed by uint32 dims
  - int32 dev_type, int32 dev_id (ignored on load; saved as the CPU)
  - int32 mshadow type flag, then the raw little-endian buffer
* uint64 name count, then per name uint64 length + utf-8 bytes

A file either package writes in this format loads in the other.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np

__all__ = ["LIST_MAGIC", "NDARRAY_V1_MAGIC", "is_legacy_params",
           "load_bytes", "save_bytes", "strip_arg_aux"]

LIST_MAGIC = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8

# mshadow type flags (mshadow/base.h kFloat32..kInt64, re-exported via
# include/mxnet/tensor_blob.h)
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_TO_FLAG = {np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}


def is_legacy_params(head: bytes) -> bool:
    """True when the first bytes carry the reference list magic."""
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == LIST_MAGIC


class _Reader(object):
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated .params file")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.u32()
    if magic == NDARRAY_V1_MAGIC:
        ndim = r.u32()
        shape = struct.unpack("<%dq" % ndim, r.take(8 * ndim)) \
            if ndim else ()
    else:
        # legacy V0: the magic slot is ndim, dims are uint32
        ndim = magic
        if ndim > 32:
            raise ValueError("corrupt .params: implausible ndim %d" % ndim)
        shape = struct.unpack("<%dI" % ndim, r.take(4 * ndim)) \
            if ndim else ()
    if ndim == 0:
        return np.zeros((), np.float32)   # is_none() placeholder
    r.i32()                               # dev_type (load always to host)
    r.i32()                               # dev_id
    flag = r.i32()
    if flag not in _FLAG_TO_DTYPE:
        raise ValueError("unknown mshadow type flag %d" % flag)
    dtype = np.dtype(_FLAG_TO_DTYPE[flag])
    count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
    data = np.frombuffer(r.take(dtype.itemsize * count),
                         dtype=dtype.newbyteorder("<"))
    return data.reshape(shape).astype(dtype, copy=True)


def load_bytes(buf: bytes) -> Union[List[np.ndarray],
                                    Dict[str, np.ndarray]]:
    """Parse a reference ``.params`` blob. Named saves return a dict (in
    file order), anonymous saves a list — mirroring ``mx.nd.load``."""
    r = _Reader(buf)
    if r.u64() != LIST_MAGIC:
        raise ValueError("not a reference NDArray list file")
    r.u64()                               # reserved
    n = r.u64()
    arrays = [_read_ndarray(r) for _ in range(n)]
    n_names = r.u64()
    if n_names == 0:
        return arrays
    if n_names != n:
        raise ValueError("corrupt .params: %d names for %d arrays"
                         % (n_names, n))
    names = [r.take(r.u64()).decode("utf-8") for _ in range(n_names)]
    return dict(zip(names, arrays))


def strip_arg_aux(data: Dict) -> Dict:
    """Drop ``arg:``/``aux:`` prefixes from module-checkpoint keys,
    leaving unprefixed keys alone (the model zoo's ``pretrained=``)."""
    return {k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k: v
            for k, v in data.items()}


def _write_ndarray(parts: List[bytes], arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    flag = _DTYPE_TO_FLAG.get(arr.dtype)
    if flag is None:
        # the reference format has exactly 7 type flags; silently casting
        # (e.g. uint64 ids or bf16) would corrupt values on a round trip
        raise ValueError(
            "dtype %s has no mshadow type flag in the reference .params "
            "format (supported: %s); cast explicitly before saving"
            % (arr.dtype, sorted(str(np.dtype(d))
                                 for d in _DTYPE_TO_FLAG)))
    parts.append(struct.pack("<I", NDARRAY_V1_MAGIC))
    parts.append(struct.pack("<I", arr.ndim))
    parts.append(struct.pack("<%dq" % arr.ndim, *arr.shape)
                 if arr.ndim else b"")
    parts.append(struct.pack("<ii", 1, 0))   # Context: kCPU, device 0
    parts.append(struct.pack("<i", flag))
    parts.append(arr.astype(arr.dtype.newbyteorder("<")).tobytes())


def save_bytes(data: Union[List[np.ndarray], Dict[str, np.ndarray]]
               ) -> bytes:
    """Serialize to the reference binary layout (readable by any MXNet
    0.8+ ``mx.nd.load``)."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    parts = [struct.pack("<QQ", LIST_MAGIC, 0),
             struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_ndarray(parts, np.asarray(a))
    parts.append(struct.pack("<Q", len(names)))
    for nm in names:
        b = nm.encode("utf-8")
        parts.append(struct.pack("<Q", len(b)))
        parts.append(b)
    return b"".join(parts)
