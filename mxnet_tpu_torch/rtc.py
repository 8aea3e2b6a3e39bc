"""Runtime user kernels — the port's counterpart of ``mxnet_tpu/rtc.py``.

The reference MXNet compiles CUDA C strings at run time and launches
them on GPU data (``mx.rtc.CudaModule``); the JAX package does the same
with Pallas (``PallasKernel``) and keeps ``CudaModule`` as a shim that
raises. Here ``CudaModule`` has its reference meaning again, on Hopper:

* :class:`CudaModule` compiles a source string with ``nvcc`` for
  ``sm_90a`` into a cubin under ``build/rtc/`` (``_build.build_cubin``)
  and loads it through the CUDA driver API (``_cuda_driver``) into
  PyTorch's context of the device it first runs on;
* :class:`CudaKernel` (``CudaModule.get_kernel(name, signature)``) is
  one ``extern "C" __global__`` function of it. ``launch`` checks each
  argument against the signature (a string such as ``"const float *x,
  float *y, int n"``: a tensor of the pointee's dtype, contiguous and on
  the launch device, for each pointer; a Python number for each scalar),
  packs the ``void**`` argument array and launches on PyTorch's current
  stream of that device;
* :class:`UserKernel` is the counterpart of ``PallasKernel``: a kernel
  with fixed outputs (``out_shape``, one ``(shape, dtype)`` pair or a
  list of them), callable on NDArrays or tensors, and registrable as a
  framework op (``nd.<op>``, ``sym.<op>``) with one or more outputs.

Where the work runs follows the data, as ``resolve_interpret`` does in
the reference: CUDA inputs always launch the compiled kernel (counted in
``UserKernel.launches``), and nothing catches a failed build or launch
to carry on in another way; CPU inputs run ``plain``, the user's PyTorch
version of the kernel, which is to this tier what Pallas's interpret
mode is to the reference's. Without ``plain``, CPU inputs raise.
"""
from __future__ import annotations

import ctypes
import numbers
import re
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from . import _build, _cuda_driver
from .base import MXNetError
from .ndarray.ndarray import NDArray, to_torch_dtype

__all__ = ["CudaModule", "CudaKernel", "UserKernel", "Param",
           "parse_signature", "parse_out_shape", "pack_args"]

# C type -> (the dtype a pointer to it takes, the ctypes type of a scalar)
_C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, None),
    "half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "nv_bfloat16": (torch.bfloat16, None),
    "bool": (torch.bool, ctypes.c_bool),
    "char": (torch.int8, ctypes.c_byte),
    "signed char": (torch.int8, ctypes.c_byte),
    "int8_t": (torch.int8, ctypes.c_int8),
    "unsigned char": (torch.uint8, ctypes.c_ubyte),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "short": (torch.int16, ctypes.c_short),
    "int16_t": (torch.int16, ctypes.c_int16),
    "int": (torch.int32, ctypes.c_int),
    "int32_t": (torch.int32, ctypes.c_int32),
    "unsigned": (None, ctypes.c_uint),
    "unsigned int": (None, ctypes.c_uint),
    "uint32_t": (None, ctypes.c_uint32),
    "long long": (torch.int64, ctypes.c_longlong),
    "long long int": (torch.int64, ctypes.c_longlong),
    "int64_t": (torch.int64, ctypes.c_int64),
    "unsigned long long": (None, ctypes.c_ulonglong),
    "uint64_t": (None, ctypes.c_uint64),
    "size_t": (None, ctypes.c_size_t),
    "void": (None, None),
}
_STATIC_SMEM_LIMIT = 48 * 1024


class Param(NamedTuple):
    """One kernel parameter: its C type, whether it is a pointer (and to
    const data), its name if the signature gave one, the dtype a pointer
    argument must have (None: any) and the ctypes type of a scalar."""
    ctype: str
    pointer: bool
    const: bool
    name: Optional[str]
    dtype: Optional[torch.dtype]
    scalar: Optional[type]


def parse_signature(signature: str) -> List[Param]:
    """Parse a kernel signature, ``"const float *x, float *y, int n"``
    (parameter names optional), into :class:`Param`\\ s."""
    params = []
    for part in signature.split(","):
        words = re.findall(r"[A-Za-z_]\w*|\*", part)
        pointer = words.count("*")
        if pointer > 1:
            raise MXNetError("kernel signature %r: %r is a pointer to a "
                             "pointer" % (signature, part.strip()))
        const = "const" in words
        words = [w for w in words if w not in ("*", "const", "__restrict__")]
        name = None
        ctype = " ".join(words)
        if ctype not in _C_TYPES and len(words) > 1:
            ctype, name = " ".join(words[:-1]), words[-1]
        if ctype not in _C_TYPES:
            raise MXNetError("kernel signature %r: unknown type in %r (known: "
                             "%s)" % (signature, part.strip(),
                                      ", ".join(sorted(_C_TYPES))))
        dtype, scalar = _C_TYPES[ctype]
        if not pointer and scalar is None:
            raise MXNetError("kernel signature %r: a %s scalar cannot be "
                             "passed from Python" % (signature, ctype))
        params.append(Param(ctype, bool(pointer), const, name, dtype, scalar))
    return params


def parse_out_shape(out_shape):
    """``(outputs, multi)``: ``out_shape`` as a list of ``(shape tuple,
    torch dtype)`` and whether the kernel has a list of outputs, by the
    reference's rule (``mxnet_tpu/rtc.py``): a pair is a shape and a
    dtype that is not a sequence; a list or tuple of any other length,
    or whose second item is a sequence, is a list of pairs."""
    def pair(spec):
        shape, dtype = spec
        return tuple(int(d) for d in shape), to_torch_dtype(dtype)

    if isinstance(out_shape, (list, tuple)) and out_shape and \
            (len(out_shape) != 2 or isinstance(out_shape[1], (list, tuple))):
        return [pair(s) for s in out_shape], True
    return [pair(out_shape)], False


def pack_args(params: Sequence[Param], args: Sequence, device=None):
    """Check ``args`` against ``params`` and pack them for
    ``cuLaunchKernel``: returns ``(values, void_pp)``, the ctypes values
    (keep them alive until the launch is issued) and the ``void*`` array
    of their addresses. A pointer takes a contiguous tensor (or NDArray)
    of its dtype on ``device``; a scalar a Python number that its C type
    holds."""
    if len(args) != len(params):
        raise MXNetError("the kernel takes %d arguments (%s), got %d"
                         % (len(params), ", ".join(p.ctype + "*" * p.pointer
                                                   for p in params),
                            len(args)))
    values = []
    for i, (p, a) in enumerate(zip(params, args)):
        what = "argument %d (%s%s%s)" % (i, p.ctype, "*" * p.pointer,
                                         " " + p.name if p.name else "")
        if isinstance(a, NDArray):
            a = a.data
        if p.pointer:
            if not isinstance(a, torch.Tensor):
                raise MXNetError("%s takes a tensor, got %s"
                                 % (what, type(a).__name__))
            if p.dtype is not None and a.dtype != p.dtype:
                raise MXNetError("%s takes %s, got %s" % (what, p.dtype,
                                                          a.dtype))
            if not a.is_contiguous():
                raise MXNetError("%s must be contiguous" % what)
            if device is not None and a.device != device:
                raise MXNetError("%s lies on %s, the kernel launches on %s"
                                 % (what, a.device, device))
            values.append(ctypes.c_void_p(a.data_ptr()))
        else:
            if isinstance(a, torch.Tensor) or \
                    not isinstance(a, numbers.Number):
                raise MXNetError("%s takes a Python number, got %s"
                                 % (what, type(a).__name__))
            if p.scalar in (ctypes.c_float, ctypes.c_double):
                v = p.scalar(float(a))
            elif isinstance(a, numbers.Integral):
                v = p.scalar(int(a))
                if v.value != int(a):
                    raise MXNetError("%s: %d does not fit a %s"
                                     % (what, a, p.ctype))
            else:
                raise MXNetError("%s takes an integer, got %r" % (what, a))
            values.append(v)
    void_pp = (ctypes.c_void_p * len(values))(
        *[ctypes.addressof(v) for v in values])
    return values, void_pp


def _dims(dims, what) -> tuple:
    dims = (int(dims),) if isinstance(dims, int) else tuple(int(d)
                                                            for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise MXNetError("%s must be 1 to 3 positive ints, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def _cuda_index(device) -> int:
    dev = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if dev.type != "cuda":
        raise MXNetError("a CUDA kernel launches on a CUDA device, not %s"
                         % (dev,))
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


class CudaModule:
    """CUDA C++ source compiled at run time for ``sm_90a`` (the reference
    MXNet's ``mx.rtc.CudaModule``). Kernels to be looked up by name are
    declared ``extern "C"``; ``options`` are extra ``nvcc`` flags;
    ``exports`` names kernels that must exist, checked when the module
    is first loaded. Compiles on construction (``build/rtc/``, cached by
    content); raises :class:`MXNetError` without ``nvcc`` or on a
    compile error."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self.cubin = _build.build_cubin(source, self.options)
        self._handles: Dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def build_log(self) -> str:
        """The compiler's report (``-Xptxas -v``: registers, shared
        memory and spills of each kernel)."""
        log = self.cubin.with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def function(self, name: str, device_index: int) -> int:
        """The CUfunction ``name`` in device ``device_index``'s context,
        loading the module there first if needed."""
        _cuda_driver.make_current(device_index)
        with self._lock:
            handle = self._handles.get(device_index)
            if handle is None:
                handle = _cuda_driver.load_module(self.cubin.read_bytes())
                for export in self.exports:
                    _cuda_driver.get_function(handle, export)
                self._handles[device_index] = handle
        return _cuda_driver.get_function(handle, name)

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with its parameters as ``signature``
        states them. Resolved on the current CUDA device now, so a
        kernel missing from the module raises here."""
        kernel = CudaKernel(self, name, signature)
        kernel.function(torch.cuda.current_device())
        return kernel


class CudaKernel:
    """One kernel of a :class:`CudaModule`."""

    def __init__(self, module: CudaModule, name: str, signature):
        self.module = module
        self.name = name
        self.params = parse_signature(signature) \
            if isinstance(signature, str) else list(signature)
        self._functions: Dict[int, int] = {}
        self._shared_limit: Dict[int, int] = {}

    def function(self, device_index: int) -> int:
        fn = self._functions.get(device_index)
        if fn is None:
            fn = self._functions[device_index] = self.module.function(
                self.name, device_index)
        return fn

    def launch(self, args: Sequence, device, grid_dims, block_dims,
               shared_mem: int = 0) -> None:
        """Launch on ``device``'s current stream (asynchronously). ``args``
        follow the signature; ``shared_mem`` bytes of dynamic shared
        memory (above 48 KB the kernel's limit is raised first)."""
        index = _cuda_index(device)
        values, void_pp = pack_args(self.params, args,
                                    torch.device("cuda", index))
        grid, block = _dims(grid_dims, "grid"), _dims(block_dims, "block")
        with torch.cuda.device(index):
            stream = torch.cuda.current_stream(index).cuda_stream
            _cuda_driver.make_current(index)
            fn = self.function(index)
            if shared_mem > self._shared_limit.get(index, _STATIC_SMEM_LIMIT):
                _cuda_driver.set_max_dynamic_shared(fn, shared_mem)
                self._shared_limit[index] = shared_mem
            _cuda_driver.launch(fn, grid, block, shared_mem, stream, void_pp)
        del values

    def __repr__(self):
        return "CudaKernel(%s)" % self.name


class UserKernel:
    """A hand-written CUDA kernel callable on NDArrays — the counterpart
    of the reference's ``PallasKernel``.

    ``source`` holds the kernel ``name`` (``extern "C" __global__``),
    whose parameters, as ``signature`` states them, are one pointer per
    input, one per output, then the scalars ``scalars`` gives (a tuple,
    or a function of the input shapes). ``out_shape`` is one ``(shape,
    dtype)`` pair or a list of them; ``grid`` and ``block`` are tuples or
    functions of the input shapes; ``shared_mem`` bytes of dynamic shared
    memory; ``plain`` is the PyTorch version that CPU inputs run;
    ``options`` extra ``nvcc`` flags. Nothing is compiled until the first
    call on CUDA inputs; ``launches`` counts the kernel's launches.
    """

    def __init__(self, source: str, name: str, signature: str, out_shape,
                 grid, block, shared_mem: int = 0,
                 plain: Optional[Callable] = None,
                 options: Sequence[str] = (), scalars=()):
        self.source = source
        self.name = name
        self.params = parse_signature(signature)
        self.out_shape, self.multi = parse_out_shape(out_shape)
        self.grid, self.block = grid, block
        self.shared_mem = int(shared_mem)
        self.plain = plain
        self.options = tuple(options)
        self.scalars = scalars
        self.launches = 0
        n_ptr = sum(p.pointer for p in self.params)
        if any(p.pointer for p in self.params[n_ptr:]):
            raise MXNetError("%s: the signature must list the pointers "
                             "(inputs, then outputs) before the scalars"
                             % name)
        self.num_inputs = n_ptr - len(self.out_shape)
        if self.num_inputs < 1:
            raise MXNetError("%s: the signature has %d pointers for %d "
                             "outputs and at least one input" % (
                                 name, n_ptr, len(self.out_shape)))
        self._kernel: Optional[CudaKernel] = None
        self._lock = threading.Lock()

    @property
    def kernel(self) -> CudaKernel:
        """The compiled kernel (built and loaded at first use)."""
        with self._lock:
            if self._kernel is None:
                module = CudaModule(self.source, self.options,
                                    exports=(self.name,))
                self._kernel = module.get_kernel(self.name, self.params)
            return self._kernel

    def run(self, tensors: Sequence[torch.Tensor]):
        """The kernel on tensors: one output tensor, or a tuple."""
        tensors = [t.data if isinstance(t, NDArray) else t for t in tensors]
        if len(tensors) != self.num_inputs or not all(
                isinstance(t, torch.Tensor) for t in tensors):
            raise MXNetError("%s takes %d tensors, got %s" % (
                self.name, self.num_inputs,
                [type(t).__name__ for t in tensors]))
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise MXNetError("%s: inputs lie on several devices %s"
                             % (self.name, sorted(map(str, devices))))
        dev = devices.pop()
        if dev.type == "cuda":
            outs = self._launch(tensors, dev)
        elif dev.type == "cpu":
            outs = self._plain(tensors)
        else:
            raise MXNetError("%s: unsupported device %s (cpu or cuda)"
                             % (self.name, dev))
        return tuple(outs) if self.multi else outs[0]

    def _launch(self, tensors, dev) -> List[torch.Tensor]:
        tensors = [t.contiguous() for t in tensors]
        shapes = [tuple(t.shape) for t in tensors]

        def resolve(spec):
            return spec(*shapes) if callable(spec) else spec

        outs = [torch.empty(s, dtype=dt, device=dev)
                for s, dt in self.out_shape]
        self.kernel.launch([*tensors, *outs, *resolve(self.scalars)], dev,
                           resolve(self.grid), resolve(self.block),
                           self.shared_mem)
        self.launches += 1
        return outs

    def _plain(self, tensors) -> List[torch.Tensor]:
        if self.plain is None:
            raise MXNetError(
                "%s: CPU inputs run the kernel's plain PyTorch version, and "
                "none was given (UserKernel(..., plain=fn)); move the "
                "inputs to a CUDA device to launch the kernel" % self.name)
        outs = self.plain(*tensors)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        got = [(tuple(o.shape), o.dtype) for o in outs]
        if got != self.out_shape:
            raise MXNetError("%s: the plain version returned %s, out_shape "
                             "declares %s" % (self.name, got, self.out_shape))
        return outs

    def __call__(self, *args):
        """Run on NDArrays (or tensors); returns NDArray(s)."""
        out = self.run(args)
        return tuple(NDArray(o) for o in out) if self.multi else NDArray(out)

    def register(self, op_name: str, num_inputs: Optional[int] = None):
        """Expose the kernel as a framework op: ``nd.<op_name>`` and
        ``sym.<op_name>``, with ``num_outputs`` and a ``meta_fn`` (for
        ``infer_shape``) from ``out_shape``."""
        from .ops.registry import register as reg_op
        out_shape, multi = self.out_shape, self.multi

        def meta_fn(*arrays, **attrs):
            outs = tuple(torch.empty(s, dtype=dt, device="meta")
                         for s, dt in out_shape)
            return outs if multi else outs[0]

        @reg_op(op_name, num_inputs=num_inputs, num_outputs=len(out_shape),
                meta_fn=meta_fn)
        def _kernel_op(*arrays):
            return self.run(arrays)

        _kernel_op.__doc__ = _kernel_op.fn.__doc__ = \
            "CUDA kernel %r (registered via rtc.UserKernel.register)" \
            % self.name
        return _kernel_op

    def __repr__(self):
        return "UserKernel(%s)" % self.name
