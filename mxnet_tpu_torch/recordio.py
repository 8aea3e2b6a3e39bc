"""RecordIO — the dataset container format.

Reference: ``python/mxnet/recordio.py`` (MXRecordIO:36, MXIndexedRecordIO,
IRHeader, pack/unpack/pack_img/unpack_img) over dmlc-core's RecordIO codec
(SURVEY.md §2.8, §2.11; design doc docs/architecture/note_data_loading.md).

Binary layout (dmlc recordio): per record a uint32 magic ``0xced7230a``, a
uint32 ``lrecord`` whose upper 3 bits are a continuation flag and lower 29
bits the payload length, then the payload padded to 4-byte alignment.
Payloads that fit 29 bits are written as single cflag=0 records; larger
ones are chained as cflag 1/2/3 parts (dmlc-core writer behavior), and the
reader reassembles either form.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple
from typing import List, Optional

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a


class MXRecordIO(object):
    """Sequential record file reader/writer (reference: recordio.py:36)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        from . import filesystem as _fs
        if self.flag not in ("r", "w"):   # before staging: no temp leak
            raise ValueError("Invalid flag %s" % self.flag)
        path = self.uri
        self._staged = None
        if _fs.scheme_of(self.uri):
            # remote URI (s3://, hdfs://, ...): stage through a local file
            # the way dmlc::Stream wraps remote filesystems (SURVEY §2.11)
            self._staged = _fs.open_uri(
                self.uri, "r" if self.flag == "r" else "w")
            path = self._staged.__enter__()
        if self.flag == "w":
            self.handle = open(path, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(path, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None
            if getattr(self, "_staged", None) is not None:
                self._staged.__exit__(None, None, None)  # uploads on write
                self._staged = None

    def reset(self):
        """(reference: recordio.py reset — reopen for reading)."""
        self.close()
        self.open()

    def write(self, buf: bytes):
        """(reference: recordio.py write).

        Payloads >= 2**29 bytes don't fit the 29-bit length field and are
        split into a cflag 1/2/3 multi-part chain, mirroring dmlc-core's
        writer; ``read`` already reassembles such chains.
        """
        assert self.writable
        _max = (1 << 29) - 1
        chunks = [buf[i:i + _max] for i in range(0, len(buf), _max)] or [b""]
        for i, chunk in enumerate(chunks):
            if len(chunks) == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == len(chunks) - 1:
                cflag = 3
            else:
                cflag = 2
            length = len(chunk)
            self.handle.write(
                struct.pack("<II", _kMagic, (cflag << 29) | length))
            self.handle.write(chunk)
            pad = (-length) % 4
            if pad:
                self.handle.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        """(reference: recordio.py read). Returns None at EOF."""
        assert not self.writable
        parts = []
        while True:
            offset = self.handle.tell()
            header = self.handle.read(8)
            if len(header) < 8:
                if parts:  # EOF mid-chain: a truncated multi-part record
                    raise IOError(
                        "truncated multi-part record at EOF in %s" % self.uri)
                return None
            magic, lrec = struct.unpack("<II", header)
            if magic != _kMagic:
                raise IOError(
                    "Invalid magic number 0x%08x at offset %d of record "
                    "file %s (expected 0x%08x — a corrupt file, or a "
                    "seek to a non-record boundary)"
                    % (magic, offset, self.uri, _kMagic))
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            data = self.handle.read(length)
            if len(data) < length:
                # a short payload read used to flow downstream and die
                # as an opaque struct.unpack error — name the truncation
                raise IOError(
                    "truncated record at offset %d of %s: header "
                    "promises %d payload bytes, file ends after %d"
                    % (offset, self.uri, length, len(data)))
            pad = (-length) % 4
            if pad:
                self.handle.read(pad)
            parts.append(data)
            # cflag: 0 = whole record; 1 = begin; 2 = middle; 3 = end
            if cflag in (0, 3):
                return b"".join(parts)

    def tell(self) -> int:
        return self.handle.tell()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file keyed by an index sidecar (reference:
    recordio.py MXIndexedRecordIO; idx file = "key\\toffset" lines).

    Index entries are VALIDATED against the record file at load: an
    offset past (or too near) EOF cannot hold a record header, so it is
    rejected here with the index key named — instead of surfacing later
    as an opaque ``struct.unpack``/magic error from whatever
    ``read_idx`` call happens to hit it first. ``read_idx`` wraps the
    remaining in-file corruption shapes (bad magic at a valid offset,
    truncated payload) the same way: every error names the index key
    and the files involved (tamper tests: tests/test_io.py).
    """

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys: List = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            # a record needs at least its 8-byte header before EOF; an
            # offset beyond that bound indexes nothing
            self.handle.seek(0, 2)
            fsize = self.handle.tell()
            self.handle.seek(0)
            with open(idx_path) as fin:
                for lineno, raw in enumerate(fin, 1):
                    raw = raw.strip()
                    if not raw:
                        continue
                    fields = raw.split("\t")
                    try:
                        key = key_type(fields[0])
                        offset = int(fields[1])
                    except (IndexError, ValueError) as exc:
                        raise IOError(
                            "malformed index entry at %s:%d (%r): %s"
                            % (idx_path, lineno, raw, exc))
                    if offset < 0 or offset + 8 > fsize:
                        raise IOError(
                            "index key %r at %s:%d points at offset %d "
                            "but %s holds only %d bytes — the index does "
                            "not match this record file (stale or "
                            "corrupt .idx)"
                            % (key, idx_path, lineno, offset, uri, fsize))
                    self.idx[key] = offset
                    self.keys.append(key)

    def close(self):
        if self.handle is not None and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def seek(self, idx):
        """(reference: recordio.py seek)."""
        assert not self.writable
        if idx not in self.idx:
            raise KeyError(
                "key %r not in index %s (%d keys)"
                % (idx, self.idx_path, len(self.idx)))
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx) -> bytes:
        self.seek(idx)
        try:
            buf = self.read()
        except (IOError, OSError, struct.error) as exc:
            raise IOError(
                "reading index key %r (offset %d) of %s failed: %s"
                % (idx, self.idx[idx], self.uri, exc))
        if buf is None:
            raise IOError(
                "index key %r points at offset %d of %s, which is EOF — "
                "the index does not match this record file"
                % (idx, self.idx[idx], self.uri))
        return buf

    def write_idx(self, idx, buf: bytes):
        """(reference: recordio.py write_idx)."""
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a (header, payload) into a record string (reference:
    recordio.py pack). Multi-label: header.label is an array and header.flag
    its length."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        buf = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        buf = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
        buf += label.tobytes()
    return buf + s


def unpack(s: bytes):
    """(reference: recordio.py unpack). Returns (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[: header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """Encode image + pack (reference: recordio.py pack_img, OpenCV path)."""
    import cv2
    encode_params = None
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s: bytes, iscolor: int = -1):
    """(reference: recordio.py unpack_img). Returns (IRHeader, BGR ndarray)."""
    import cv2
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    img = cv2.imdecode(img, iscolor)
    return header, img
