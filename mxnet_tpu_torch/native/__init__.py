"""Native data-path library: build + ctypes binding.

The C++ sources in this directory (``recordio.cc``, ``image.cc``,
``pipeline.cc``, ``mxnative.h``; the reference package's, copied) hold
the host-side IO hot loop: the RecordIO codec, JPEG/PNG decode through
libjpeg and libpng, and the threaded decode → augment → batch pipeline
(the counterpart of dmlc-core RecordIO and
``src/io/iter_image_recordio_2.cc``). At first use ``g++`` compiles them
into ``build/native/libmxnative-<hash>.so``, the hash taken over the
sources and the compiler command (as ``_build.py`` names its CUDA
libraries), and ctypes loads the library.

Unlike the reference, which falls back to cv2 when the build fails, a
failed build or load raises :class:`MXNetError` with the compiler's or
the loader's output: a host without libjpeg must not quietly run another
decoder. Only ``MXNET_USE_NATIVE_IO=0`` selects the Python path
(:func:`enabled`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..base import MXNetError

__all__ = ["lib", "enabled", "build", "decode", "resize", "MXPipeConfig"]

SRC_DIR = Path(__file__).resolve().parent
OUT_DIR = SRC_DIR.parent.parent / "build" / "native"
SOURCES = ("recordio.cc", "image.cc", "pipeline.cc")
HEADERS = ("mxnative.h",)
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib = None


class MXPipeConfig(ctypes.Structure):
    _fields_ = [
        ("batch_size", ctypes.c_int),
        ("target_h", ctypes.c_int),
        ("target_w", ctypes.c_int),
        ("target_c", ctypes.c_int),
        ("label_width", ctypes.c_int),
        ("resize", ctypes.c_int),
        ("rand_crop", ctypes.c_int),
        ("rand_mirror", ctypes.c_int),
        ("mean", ctypes.c_float * 3),
        ("std_", ctypes.c_float * 3),
        ("scale", ctypes.c_float),
        ("seed", ctypes.c_uint64),
        ("num_threads", ctypes.c_int),
        ("queue_depth", ctypes.c_int),
        ("round_batch", ctypes.c_int),
    ]


def enabled() -> bool:
    """False only when ``MXNET_USE_NATIVE_IO=0`` asks for the Python
    path."""
    from .. import config as _config
    return bool(_config.get("MXNET_USE_NATIVE_IO"))


def build(src_dir=SRC_DIR, out_dir=OUT_DIR, cxx: str = "g++") -> Path:
    """Compile the library from ``src_dir`` into ``out_dir`` unless an
    up-to-date one is there; returns its path. The compiler writes a
    process-unique temporary file that is renamed into place, so
    concurrent builders (pytest workers, loader processes) never load
    half a file. Raises :class:`MXNetError` with the compiler's output
    when it fails."""
    src_dir, out_dir = Path(src_dir), Path(out_dir)
    cmd = [cxx, *CXX_FLAGS]
    h = hashlib.sha256(" ".join(cmd + list(LIBS)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((src_dir / name).read_bytes())
    out = out_dir / ("libmxnative-%s.so" % h.hexdigest()[:16])
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    cmd += ["-o", str(tmp)] + [str(src_dir / s) for s in SOURCES] \
        + list(LIBS)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise MXNetError("native data library: %s failed to run: %s"
                         % (cxx, exc)) from exc
    # the build in the compile ring, under the caller's open scope
    # (imported here, so a build before anything imported obs lands)
    from ..obs import compiles
    compiles.record((time.perf_counter() - t0) * 1e3, source="g++")
    if proc.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise MXNetError(
            "native data library build failed (%s exit %d; it needs the "
            "libjpeg and libpng headers and libraries, or "
            "MXNET_USE_NATIVE_IO=0 for the Python path):\n%s\n%s"
            % (cxx, proc.returncode, " ".join(cmd), proc.stdout[-6000:]))
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mxrio_open.restype = ctypes.c_void_p
    lib.mxrio_open.argtypes = [ctypes.c_char_p]
    lib.mxrio_count.restype = ctypes.c_int64
    lib.mxrio_count.argtypes = [ctypes.c_void_p]
    lib.mxrio_offset.restype = ctypes.c_int64
    lib.mxrio_offset.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mxrio_index_of.restype = ctypes.c_int64
    lib.mxrio_index_of.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mxrio_get.restype = ctypes.c_int64
    lib.mxrio_get.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.POINTER(u8p)]
    lib.mxrio_close.restype = None
    lib.mxrio_close.argtypes = [ctypes.c_void_p]
    lib.mxrio_writer_open.restype = ctypes.c_void_p
    lib.mxrio_writer_open.argtypes = [ctypes.c_char_p]
    lib.mxrio_writer_write.restype = ctypes.c_int64
    lib.mxrio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64]
    lib.mxrio_writer_close.restype = ctypes.c_int
    lib.mxrio_writer_close.argtypes = [ctypes.c_void_p]

    lib.mximg_decode.restype = ctypes.c_int
    lib.mximg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.POINTER(u8p),
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.mximg_free.restype = None
    lib.mximg_free.argtypes = [u8p]
    lib.mximg_resize.restype = None
    lib.mximg_resize.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, u8p, ctypes.c_int,
                                 ctypes.c_int]

    lib.mxpipe_create.restype = ctypes.c_void_p
    lib.mxpipe_create.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(MXPipeConfig)]
    lib.mxpipe_start_epoch.restype = None
    lib.mxpipe_start_epoch.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64),
                                       ctypes.c_int64]
    lib.mxpipe_next.restype = ctypes.c_int
    lib.mxpipe_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int)]
    lib.mxpipe_error.restype = ctypes.c_char_p
    lib.mxpipe_error.argtypes = [ctypes.c_void_p]
    lib.mxpipe_close.restype = None
    lib.mxpipe_close.argtypes = [ctypes.c_void_p]
    return lib


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises
    :class:`MXNetError` when it cannot be built or loaded; callers that
    honour ``MXNET_USE_NATIVE_IO=0`` check :func:`enabled` first."""
    global _lib
    if _lib is not None:
        # no lock on this path: a forked loader worker must not wait on
        # a lock some parent thread held at the fork
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as exc:
                raise MXNetError("native data library %s failed to load: %s"
                                 % (path, exc)) from exc
        return _lib


def decode(buf: bytes, channels: int = 3) -> np.ndarray:
    """Decode a JPEG or PNG buffer with libjpeg / libpng into an HWC
    uint8 array (``channels`` 3: RGB, 1: gray, 0: as stored)."""
    lib_ = lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib_.mximg_decode(bytes(buf), len(buf), int(channels),
                           ctypes.byref(out), ctypes.byref(h),
                           ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise ValueError("native decode failed (%s)"
                         % ("not a JPEG or PNG" if rc == -2 else
                            "corrupt image"))
    try:
        n = h.value * w.value * c.value
        img = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib_.mximg_free(out)
    return img.reshape(h.value, w.value, c.value)


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of an HWC uint8 array with half-pixel centres (the
    pipeline's own resize, within one level of cv2's INTER_LINEAR)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    out = np.empty((int(height), int(width), img.shape[2]), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib().mximg_resize(img.ctypes.data_as(u8p), img.shape[0], img.shape[1],
                       img.shape[2], out.ctypes.data_as(u8p), out.shape[0],
                       out.shape[1])
    return out
