"""The CUDA driver API entry points that ``rtc`` needs, over ``ctypes``.

``libcuda.so.1`` is loaded at the first call, never at import, so the
module imports on a machine without a GPU. Every entry point returns a
``CUresult``; :func:`check` turns any non-zero one into
:class:`MXNetError` with the driver's own message.

The driver API acts on the context that is current on the calling
thread. PyTorch works in each device's primary context, so before a
module is loaded or a kernel launched, :func:`make_current` makes that
primary context current: on the threads PyTorch already used it is, and
on the others (a server's worker threads) it is retained once and set
with ``cuDevicePrimaryCtxRetain`` + ``cuCtxSetCurrent``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence

from .base import MXNetError

__all__ = ["check", "make_current", "load_module", "get_function",
           "set_max_dynamic_shared", "launch"]

CUDA_ERROR_NOT_FOUND = 500
CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_P, _U, _I = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int
_SIGNATURES = {
    "cuInit": [_U],
    "cuGetErrorString": [_I, ctypes.POINTER(ctypes.c_char_p)],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [ctypes.POINTER(_P), _I],
    "cuCtxGetCurrent": [ctypes.POINTER(_P)],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [ctypes.POINTER(_P), _P],
    "cuModuleGetFunction": [ctypes.POINTER(_P), _P, ctypes.c_char_p],
    "cuFuncSetAttribute": [_P, _I, _I],
    # function, grid x y z, block x y z, shared bytes, stream, params, extra
    "cuLaunchKernel": [_P] + [_U] * 7 + [_P, ctypes.POINTER(_P),
                                          ctypes.POINTER(_P)],
}

_lock = threading.Lock()
_lib = None
_primary: Dict[int, int] = {}       # device index -> its primary CUcontext


def _load() -> ctypes.CDLL:
    # once loaded, without the lock: check() reaches here from inside
    # make_current's locked section
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as exc:
                raise MXNetError("the CUDA driver (libcuda.so.1) cannot be "
                                 "loaded: %s" % exc) from None
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            code = lib.cuInit(0)
            if code:
                raise MXNetError("cuInit failed: CUresult %d" % code)
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    msg = ctypes.c_char_p()
    if _load().cuGetErrorString(code, ctypes.byref(msg)) or not msg.value:
        return "unknown CUresult"
    return msg.value.decode()


def check(code: int, what: str) -> None:
    """Raise :class:`MXNetError` naming ``what`` when ``code`` is not
    ``CUDA_SUCCESS``."""
    if code:
        raise MXNetError("%s failed: %s (CUresult %d)"
                         % (what, error_string(code), code))


def make_current(device_index: int) -> None:
    """Make device ``device_index``'s primary context (PyTorch's) current
    on this thread."""
    lib = _load()
    ctx = _primary.get(device_index)
    if ctx is None:
        with _lock:
            ctx = _primary.get(device_index)
            if ctx is None:
                dev, handle = _I(), _P()
                check(lib.cuDeviceGet(ctypes.byref(dev), device_index),
                      "cuDeviceGet(%d)" % device_index)
                check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(handle), dev),
                      "cuDevicePrimaryCtxRetain(%d)" % device_index)
                ctx = _primary[device_index] = handle.value
    cur = _P()
    check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx:
        check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_module(image: bytes) -> int:
    """Load a cubin into the current context; returns the CUmodule."""
    module = _P()
    buf = ctypes.create_string_buffer(image, len(image))
    check(_load().cuModuleLoadData(ctypes.byref(module), buf),
          "cuModuleLoadData")
    return module.value


def get_function(module: int, name: str) -> int:
    """The CUfunction ``name`` of a loaded module."""
    fn = _P()
    code = _load().cuModuleGetFunction(ctypes.byref(fn), module,
                                       name.encode())
    if code == CUDA_ERROR_NOT_FOUND:
        raise MXNetError(
            "kernel %r is not in the compiled module: declare it "
            "extern \"C\" __global__ so that its name is not mangled" % name)
    check(code, "cuModuleGetFunction(%r)" % name)
    return fn.value


def set_max_dynamic_shared(function: int, nbytes: int) -> None:
    """Allow ``nbytes`` of dynamic shared memory (needed above 48 KB)."""
    check(_load().cuFuncSetAttribute(
        function, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
        int(nbytes)), "cuFuncSetAttribute(max dynamic shared %d)" % nbytes)


def launch(function: int, grid: Sequence[int], block: Sequence[int],
           shared_mem: int, stream: int, params) -> None:
    """``cuLaunchKernel`` on ``stream`` with the packed ``void**``
    argument array ``params``. The launch is asynchronous: a fault while
    the kernel runs shows at the next synchronisation."""
    check(_load().cuLaunchKernel(function, *grid, *block, int(shared_mem),
                                 stream, params, None), "cuLaunchKernel")
