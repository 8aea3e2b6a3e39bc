"""A minimal NDArray over a torch tensor.

The port's counterpart of the reference's ``ndarray/ndarray.py``, as far
as the ported paths need it: ``DataBatch`` payloads, an executor's
``arg_dict``/``grad_dict``/``outputs``, ``Module.get_params``, the
arrays a custom op's ``forward``/``backward`` receive (with ``+ - * /``)
and :func:`imperative_invoke`, behind every ``nd.<op>``; and
:func:`save` / :func:`load` of named arrays in the reference's two
containers (its npz archive and MXNet's binary ``.params`` format). The
reference's arrays are immutable jax values that an assignment replaces;
here an assignment writes into the tensor in place (``arr[:] = x`` is a
``copy_``), so a tensor bound into an executor sees every update.

An array made from host data with no ``ctx`` lands on the current
device (``context.current_device``): the innermost ``device_scope``,
else ``cuda:0``, and without a GPU the call raises. An array over a
tensor stays on that tensor's device.
"""
from __future__ import annotations

import io
from typing import Union

import numpy as np
import torch

from ..base import MXNetError, atomic_write
from ..context import DeviceLike, resolve_device
from . import legacy_format

__all__ = ["NDArray", "array", "zeros", "imperative_invoke", "save", "load",
           "to_torch_dtype", "to_numpy_dtype"]

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a numpy dtype, its name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def to_numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks,
    stays the torch dtype."""
    return _TORCH_TO_NP.get(dtype, dtype)


def _device(ctx: DeviceLike) -> torch.device:
    if ctx is None:
        return resolve_device(None)
    return torch.device(ctx) if not isinstance(ctx, torch.device) else ctx


class NDArray:
    """An n-dimensional array on one device (a torch tensor)."""

    __slots__ = ("_data",)

    def __init__(self, data, ctx: DeviceLike = None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            t = data
            if ctx is not None:
                t = t.to(_device(ctx))
        else:
            # a copy: the caller's numpy buffer must not alias the array
            t = torch.from_numpy(np.array(data)).to(_device(ctx))
        if dtype is not None:
            t = t.to(to_torch_dtype(dtype))
        self._data = t

    # ------------------------------------------------------------ views
    @property
    def data(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return to_numpy_dtype(self._data.dtype)

    @property
    def context(self) -> torch.device:
        return self._data.device

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    # ------------------------------------------------------------ transfer
    def asnumpy(self) -> np.ndarray:
        """A numpy copy (never a view of the array's memory)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == "cpu" else arr

    def copyto(self, other: Union["NDArray", DeviceLike]) -> "NDArray":
        """Copy into ``other`` (an NDArray: its device and dtype win), or
        to a new array on device ``other``."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        return NDArray(self._data.detach().to(_device(other), copy=True))

    # ------------------------------------------------------------ indexing
    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor) and not np.isscalar(value):
            value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                self._data[key] = value.to(self._data.device,
                                           self._data.dtype)
            else:
                self._data[key] = value

    # ------------------------------------------------------------ arithmetic
    def _operand(self, other):
        if isinstance(other, NDArray):
            return other._data
        if isinstance(other, torch.Tensor) or np.isscalar(other):
            return other
        return torch.as_tensor(np.asarray(other), device=self._data.device)

    def __add__(self, other):
        return NDArray(self._data + self._operand(other))

    __radd__ = __add__

    def __sub__(self, other):
        return NDArray(self._data - self._operand(other))

    def __rsub__(self, other):
        return NDArray(self._operand(other) - self._data)

    def __mul__(self, other):
        return NDArray(self._data * self._operand(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return NDArray(self._data / self._operand(other))

    def __rtruediv__(self, other):
        return NDArray(self._operand(other) / self._data)

    def __neg__(self):
        return NDArray(-self._data)


def imperative_invoke(op, *args, out=None, ctx: DeviceLike = None, **attrs):
    """Run a registered op eagerly: NDArrays are unwrapped to their
    tensors, the op's function runs on them, and each output comes back
    as an NDArray (a tuple for an op with several outputs). An op with no
    array input creates its result on ``ctx`` (None: the current
    device). ``out`` (an NDArray or a list) receives the results in
    place. An op with aux state writes the new values into the aux
    arrays it was given and returns its visible outputs (BatchNorm's
    mean and variance too under ``output_mean_var``)."""
    tensors = [a._data if isinstance(a, NDArray) else a for a in args]
    attrs.pop("name", None)     # a symbol-layer attribute
    if op.num_inputs == 0 and not any(isinstance(t, torch.Tensor)
                                      for t in tensors):
        attrs["_device"] = resolve_device(ctx)
    outputs = op.fn(*tensors, **attrs)
    if op.num_aux:
        k = op.num_aux
        with torch.no_grad():
            for old, new in zip(tensors[-k:], outputs[-k:]):
                if new is not old:
                    old.copy_(new)
        outputs = outputs[:-k]
        if not attrs.get("output_mean_var"):
            outputs = outputs[:len(outputs) - op.num_hidden_outputs]
        if len(outputs) == 1:
            outputs = outputs[0]
    single = not isinstance(outputs, tuple)
    results = [NDArray(o) for o in ((outputs,) if single else outputs)]
    if out is not None:
        dsts = list(out) if isinstance(out, (list, tuple)) else [out]
        if len(dsts) != len(results):
            raise MXNetError("%s: %d outputs, out= has %d"
                             % (op.name, len(results), len(dsts)))
        for dst, src in zip(dsts, results):
            dst[:] = src
        results = dsts
    return results[0] if single else tuple(results)


def array(source_array, ctx: DeviceLike = None, dtype=None) -> NDArray:
    """An NDArray from any array-like; float32 unless ``dtype`` says
    otherwise (the reference's default, whatever the source's dtype)."""
    if isinstance(source_array, NDArray):
        return NDArray(source_array._data, ctx=ctx, dtype=dtype)
    if isinstance(source_array, torch.Tensor):
        return NDArray(source_array, ctx=ctx,
                       dtype=dtype if dtype is not None else torch.float32)
    arr = np.asarray(source_array,
                     dtype=dtype if dtype is not None else np.float32)
    return NDArray(arr, ctx=ctx)


def zeros(shape, ctx: DeviceLike = None, dtype="float32") -> NDArray:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=to_torch_dtype(dtype),
                               device=_device(ctx)))


def save(fname: str, data, format: str = "npz") -> None:
    """Save an NDArray, a list of them or a dict of them by name, as the
    reference's ``nd.save`` does: by default its npz archive (each array
    plus a ``__manifest__`` of the kind and the order), or with
    ``format="mxnet"`` MXNet's binary ``.params`` layout. Either file
    loads in the reference; the write is atomic."""
    if isinstance(data, NDArray):
        data = [data]
    named = isinstance(data, dict)
    keys = list(data) if named else \
        ["__arr_%d__" % i for i in range(len(data))]
    arrays = [np.asarray(a.asnumpy()) for a in
              (data.values() if named else data)]
    if format == "mxnet":
        blob = legacy_format.save_bytes(dict(zip(keys, arrays)) if named
                                        else arrays)
    elif format == "npz":
        manifest = np.array(["dict" if named else "list"] + keys,
                            dtype=np.str_)
        buf = io.BytesIO()
        np.savez(buf, __manifest__=manifest, **dict(zip(keys, arrays)))
        blob = buf.getvalue()
    else:
        raise ValueError("unknown save format %r" % format)
    atomic_write(fname, blob)


def load(fname: str, ctx: DeviceLike = None):
    """Load what :func:`save` (here or in the reference) wrote, in
    either container (told apart by the binary format's magic): a dict
    by name or a list, of NDArrays in the stored dtypes on ``ctx``
    (None: the current device)."""
    dev = resolve_device(ctx)
    with open(fname, "rb") as f:
        blob = f.read()
    if legacy_format.is_legacy_params(blob[:8]):
        out = legacy_format.load_bytes(blob)
        if isinstance(out, list):
            return [NDArray(a, ctx=dev) for a in out]
        return {k: NDArray(a, ctx=dev) for k, a in out.items()}
    with np.load(io.BytesIO(blob), allow_pickle=False) as zf:
        manifest = [str(x) for x in zf["__manifest__"]]
        kind, keys = manifest[0], manifest[1:]
        out = {k: NDArray(zf[k], ctx=dev) for k in keys}
    return [out[k] for k in keys] if kind == "list" else out
