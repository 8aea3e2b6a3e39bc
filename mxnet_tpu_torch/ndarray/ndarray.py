"""The NDArray over a torch tensor, and imperative dispatch.

The port's counterpart of the reference's ``ndarray/ndarray.py``:
``DataBatch`` payloads, an executor's ``arg_dict``/``grad_dict``/
``outputs``, ``Module.get_params``, the arrays a custom op's
``forward``/``backward`` receive, Gluon's parameters and activations,
and :func:`imperative_invoke`, behind every ``nd.<op>``; and
:func:`save` / :func:`load` of named arrays in the reference's two
containers (its npz archive and MXNet's binary ``.params`` format).

Autograd (``autograd.py``): ``attach_grad`` marks an array for a
gradient, ``backward`` and ``grad`` read it. Every op that
:func:`imperative_invoke` or the arithmetic operators run goes through
:func:`_run`, which enables torch's grad mode while ``autograd.record()``
is on and, outside it, turns it off for ops on marked arrays and on
recorded results, so no graph grows from them.

Writes. The reference's arrays are immutable jax values that an
assignment replaces. Here an assignment (``arr[:] = x``, ``arr += y``,
``out=``, an aux-state commit) writes into the tensor in place, so that
a tensor bound into an executor sees every update, except where
autograd may hold the old value: while recording, on an array that a
recorded op consumed (``_in_graph``) and on a marked array's tensor.
There the array is rebound to a new tensor (:meth:`NDArray._set_data`)
and the saved one stays as it was; a marked array's new tensor becomes
a new leaf, and gradients reach every version of the array.

An array made from host data with no ``ctx`` lands on the current
device (``context.current_device``): the innermost ``device_scope``,
else ``cuda:0``, and without a GPU the call raises. An array over a
tensor stays on that tensor's device.
"""
from __future__ import annotations

import io
import weakref
from typing import Union

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, atomic_write
from ..context import Context, DeviceLike, resolve_device
from . import legacy_format

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "waitall",
           "moveaxis", "onehot_encode", "imperative_invoke", "save", "load",
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
    if isinstance(ctx, Context):
        return resolve_device(ctx)
    return torch.device(ctx) if not isinstance(ctx, torch.device) else ctx


def _run(fn, arrays, *args, **kwargs):
    """``fn(*args, **kwargs)`` under autograd's recording flag: while it
    records, with torch's grad mode on, ``arrays`` (the NDArray inputs)
    marked as taking part in a graph and the result tagged with the
    marked arrays it came from (``autograd.tag``); outside ``record()``,
    with grad mode off if an input is a marked array or a recorded
    result, so that no graph grows from them. Other inputs leave torch's
    mode as it is: a tensor a caller made to require grad keeps
    differentiating through ``torch.autograd``."""
    if autograd.is_recording():
        for a in arrays:
            a._in_graph = True
        reach = autograd.reach_of(arrays)
        if torch.is_grad_enabled():
            return autograd.tag(fn(*args, **kwargs), reach)
        with torch.enable_grad():
            return autograd.tag(fn(*args, **kwargs), reach)
    if torch.is_grad_enabled() and any(
            a._leaves is not None or a._data.grad_fn is not None
            for a in arrays):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


class NDArray:
    """An n-dimensional array on one device (a torch tensor)."""

    __slots__ = ("_data", "_grad", "_grad_req", "_leaves", "_in_graph",
                 "__weakref__")

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
        self._grad = None
        self._grad_req = "write"
        self._leaves = None         # weakrefs to a marked array's leaves
        self._in_graph = False      # a recorded op consumed this array

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
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        """The array's device as a :class:`~..context.Context`
        (``cpu(0)``, ``gpu(0)``); it equals the tensor's
        ``torch.device``."""
        return Context(self._data.device)

    ctx = context

    @property
    def grad(self):
        """The gradient buffer attached by :meth:`attach_grad` (None
        without one)."""
        return self._grad

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def __len__(self) -> int:
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    # ------------------------------------------------------------ transfer
    def asnumpy(self) -> np.ndarray:
        """A numpy copy (never a view of the array's memory)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return arr.copy() if t.device.type == "cpu" else arr

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def wait_to_read(self) -> None:
        """Block until the work that produces this array has finished."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def copyto(self, other: Union["NDArray", DeviceLike]) -> "NDArray":
        """Copy into ``other`` (an NDArray: its device and dtype win), or
        to a new array on device ``other``."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            other[:] = self
            return other
        return NDArray(self._data.detach().to(_device(other), copy=True))

    def copy(self) -> "NDArray":
        """A copy outside any graph."""
        return NDArray(self._data.detach().clone())

    def as_in_context(self, ctx: DeviceLike) -> "NDArray":
        dev = _device(ctx)
        if dev == self._data.device:
            return self
        return NDArray(_run(self._data.to, [self], dev))

    def astype(self, dtype) -> "NDArray":
        from ..ops import get_op
        return imperative_invoke(get_op("Cast"), self, dtype=dtype)

    def detach(self) -> "NDArray":
        """The same values (and storage) outside any graph."""
        return NDArray(self._data.detach())

    # ------------------------------------------------------------ autograd
    def attach_grad(self, grad_req: str = "write") -> None:
        """Attach a zero gradient buffer and mark the array for
        :func:`autograd.backward`."""
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data.detach()))],
            grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------ writes
    def _rebinds(self) -> bool:
        """Whether a write must rebind the array to a new tensor: the
        old one may be held by autograd."""
        return (self._in_graph or self._data.requires_grad or
                autograd.is_recording())

    def _set_data(self, t: torch.Tensor) -> None:
        """Rebind to ``t``. A marked array's tensor that no recorded op
        produced becomes a new leaf; the old leaves stay reachable by
        ``backward`` while a graph holds them."""
        if self._leaves is not None and not t.requires_grad:
            t = t.detach().requires_grad_(True)
            self._leaves = [r for r in self._leaves if r() is not None]
            self._leaves.append(weakref.ref(t))
        self._data = t

    def _commit(self, t: torch.Tensor) -> None:
        """Make ``t`` this array's value: in place where nothing can hold
        the old tensor, else by rebinding."""
        if self._rebinds():
            self._set_data(t)
        else:
            with torch.no_grad():
                self._data.copy_(t)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor) and not np.isscalar(value):
            value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        if isinstance(value, torch.Tensor):
            value = value.detach().to(self._data.device, self._data.dtype)
        if isinstance(key, NDArray):
            key = key._data.long()
        with torch.no_grad():
            if not self._rebinds():
                self._data[key] = value
                return
            # an unrecorded write: a new tensor, never the saved one
            if isinstance(key, slice) and key == slice(None):
                t = torch.empty_like(self._data.detach())
                t[...] = value
            else:
                t = self._data.detach().clone()
                t[key] = value
        self._set_data(t)

    def __getitem__(self, key) -> "NDArray":
        """A copy of the selected elements (never a view: writing into
        it leaves this array as it is, as in the reference)."""
        if isinstance(key, NDArray):
            key = key._data.long()
        t = _run(self._data.__getitem__, [self], key)
        return NDArray(t.clone() if t._is_view() else t)

    # ------------------------------------------------------------ arithmetic
    def _operand(self, other):
        if isinstance(other, NDArray):
            return other._data
        if isinstance(other, torch.Tensor) or np.isscalar(other):
            return other
        return torch.as_tensor(np.asarray(other), device=self._data.device)

    def _binary(self, other, fn, reverse=False):
        o = self._operand(other)
        arrays = [self, other] if isinstance(other, NDArray) else [self]
        args = (o, self._data) if reverse else (self._data, o)
        return NDArray(_run(fn, arrays, *args))

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, torch.sub, reverse=True)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, torch.div)

    def __rtruediv__(self, other):
        return self._binary(other, torch.div, reverse=True)

    def __pow__(self, other):
        return self._binary(other, torch.pow)

    def __rpow__(self, other):
        return self._binary(other, torch.pow, reverse=True)

    def __mod__(self, other):
        return self._binary(other, torch.remainder)

    def __neg__(self):
        return NDArray(_run(torch.neg, [self], self._data))

    def __abs__(self):
        return NDArray(_run(torch.abs, [self], self._data))

    def _inplace(self, other, fn):
        """``self op= other``: recorded like ``self = self op other``
        while recording; in place where nothing can hold the tensor."""
        if self._rebinds():
            self._set_data(self._binary(other, fn)._data)
        else:
            with torch.no_grad():
                self._data.copy_(fn(self._data, self._operand(other)))
        return self

    def __iadd__(self, other):
        return self._inplace(other, torch.add)

    def __isub__(self, other):
        return self._inplace(other, torch.sub)

    def __imul__(self, other):
        return self._inplace(other, torch.mul)

    def __itruediv__(self, other):
        return self._inplace(other, torch.div)

    def _compare(self, other, fn):
        """1 where the comparison holds, else 0, in this array's dtype
        (the reference's ``broadcast_*`` logic ops)."""
        dtype = self._data.dtype
        return self._binary(other, lambda a, b: fn(a, b).to(dtype))

    def __eq__(self, other):
        return self._compare(other, torch.eq)

    def __ne__(self, other):
        return self._compare(other, torch.ne)

    def __gt__(self, other):
        return self._compare(other, torch.gt)

    def __ge__(self, other):
        return self._compare(other, torch.ge)

    def __lt__(self, other):
        return self._compare(other, torch.lt)

    def __le__(self, other):
        return self._compare(other, torch.le)

    # ------------------------------------------------------------ op methods
    def reshape(self, *shape, **kwargs) -> "NDArray":
        """Reshape with MXNet's special codes (0, -1, -2, -3, -4)."""
        if not shape:
            shape = kwargs.pop("shape")
        elif len(shape) == 1 and not isinstance(shape[0], int):
            shape = shape[0]
        from ..ops import get_op
        return imperative_invoke(get_op("Reshape"), self, shape=tuple(shape),
                                 **kwargs)


def _op_method(name):
    def method(self, *args, **kwargs):
        from ..ops import get_op
        return imperative_invoke(get_op(name), self, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = "``nd.%s`` of this array." % name
    return method


# the reference's op methods on NDArray (its autogenerated tail)
for _name in ("sum", "mean", "max", "min", "prod", "argmax", "argmin",
              "clip", "abs", "sign", "round", "floor", "ceil", "sqrt",
              "square", "exp", "log", "sigmoid", "tanh", "relu", "softmax",
              "log_softmax", "transpose", "swapaxes", "flatten",
              "expand_dims", "repeat", "tile", "flip", "sort", "argsort",
              "topk", "pick", "take", "one_hot", "broadcast_to",
              "slice_axis", "squeeze", "norm", "split", "slice"):
    setattr(NDArray, _name, _op_method(_name))


def imperative_invoke(op, *args, out=None, ctx: DeviceLike = None, **attrs):
    """Run a registered op eagerly: NDArrays are unwrapped to their
    tensors, the op's function runs on them (recorded under
    ``autograd.record()``), and each output comes back as an NDArray (a
    tuple for an op with several outputs). An op that takes
    ``_is_train`` is told ``autograd.is_training()``. An op with no
    array input creates its result on ``ctx`` (None: the current
    device). ``out`` (an NDArray or a list) receives the results. An op
    with aux state commits the new values into the aux arrays it was
    given and returns its visible outputs (BatchNorm's mean and variance
    too under ``output_mean_var``)."""
    arrays = [a for a in args if isinstance(a, NDArray)]
    tensors = [a._data if isinstance(a, NDArray) else a for a in args]
    attrs.pop("name", None)     # a symbol-layer attribute
    if op.takes_is_train:
        attrs.setdefault("_is_train", autograd.is_training())
    if op.num_inputs == 0 and not arrays:
        attrs["_device"] = resolve_device(ctx)
    if op.is_random:
        # a sampler is not recorded: its result is a constant to the tape
        with torch.no_grad():
            outputs = op.fn(*tensors, **attrs)
    else:
        outputs = _run(op.fn, arrays, *tensors, **attrs)
    if op.num_aux:
        k = op.num_aux
        for old, new in zip(args[-k:], outputs[-k:]):
            if isinstance(old, NDArray):
                if new is not old._data:
                    old._commit(new.detach())
            elif new is not old:
                with torch.no_grad():
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
            dst._commit(src._data.to(dst._data.dtype))
        results = dsts
    return results[0] if single else tuple(results)


def concatenate(arrays, axis: int = 0, always_copy: bool = True) -> NDArray:
    """Join ``arrays`` along ``axis`` (``Concat``)."""
    from ..ops import get_op
    return imperative_invoke(get_op("Concat"), *arrays, dim=axis)


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


def ones(shape, ctx: DeviceLike = None, dtype="float32") -> NDArray:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.ones(shape, dtype=to_torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx: DeviceLike = None, dtype="float32") -> NDArray:
    """A new array of ``shape`` (zeros, as the reference's)."""
    return zeros(tuple(np.atleast_1d(shape)), ctx=ctx, dtype=dtype)


def waitall() -> None:
    """Block until the work queued on every visible GPU has finished."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def moveaxis(tensor: NDArray, source: int, destination: int) -> NDArray:
    """The array with axis ``source`` moved to ``destination``."""
    return NDArray(_run(torch.movedim, [tensor], tensor._data, source,
                        destination))


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """Write the one-hot rows of ``indices`` (of ``out``'s width) into
    ``out`` and return it."""
    from ..ops import get_op
    res = imperative_invoke(get_op("one_hot"), indices, depth=out.shape[1])
    out._commit(res._data.to(out._data.dtype))
    return out


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
