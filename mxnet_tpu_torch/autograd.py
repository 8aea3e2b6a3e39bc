"""Imperative autograd: ``record()``, ``backward()``, ``Function``.

The port's counterpart of the reference's ``autograd.py``. The reference
records a tape of the ops run inside ``record()`` and differentiates it
with ``jax.vjp``; here the engine is ``torch.autograd`` and there is no
tape of that kind: recording means running the ops with grad enabled on
tensors whose leaves require grad.

* :func:`mark_variables` (``NDArray.attach_grad``) makes an array's
  tensor a leaf that requires grad and attaches a gradient buffer. The
  dispatch points (``imperative_invoke`` and ``NDArray``'s arithmetic,
  ``ndarray._run``) enable grad mode inside ``record()`` and disable it
  outside for ops on marked arrays or recorded results, so outside
  ``record()`` nothing builds a graph, even on such leaves. (A raw
  tensor that its caller made require grad is left to torch's mode.)
* An array mutated outside the graph (``x[:] = v``, an aux-state
  commit) gets a new tensor instead of a write into the old one, which
  a recorded op may have saved: a marked array gets a new leaf and keeps
  the old ones while anything references them, so gradients are taken
  at the values the forward consumed and the gradients of every version
  of an array are summed into its buffer, as the reference's versioned
  tape does (``NDArray._set_data``).
* :func:`backward` runs ``torch.autograd.grad`` from the heads to every
  live leaf of every marked array and writes each buffer per its
  ``grad_req`` (``write``, ``add``, ``null``); ``retain_graph`` keeps the
  graph for another pass. Each backward consumes only its own graph.
* Every marked array that a recorded op consumed on the way to the
  heads gets a gradient, as in the reference's tape, also when no
  differentiable op connects them (``argmax``, a comparison,
  ``BlockGrad``): zero, written under ``write`` and leaving the buffer
  as it is under ``add``. torch's graph does not see such a path, so
  each tensor a recorded op returns carries the ids of the marked
  arrays it was computed from (``_REACH``, set by :func:`tag`).
* Recording and training are separate flags: ``record(train_mode=False)``
  records in predict mode, ``pause(train_mode=True)`` trains without
  recording. Ops that take ``_is_train`` (BatchNorm, Dropout,
  LeakyReLU ``rrelu``, Custom) are told :func:`is_training`.
* :class:`Function` runs a user's forward and backward over NDArrays as
  a ``torch.autograd.Function``.

The executor's graph function keeps its own ``torch.enable_grad()``
(``executor.py``) and custom-op bodies run as before: the gate belongs
to imperative dispatch only.
"""
from __future__ import annotations

import threading
import weakref
from typing import List, Optional

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_state = threading.local()

# every array marked for a gradient, by id; an entry leaves with its array
_MARKED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()

# the attribute of a recorded op's output tensor that holds the ids of
# the marked arrays it was computed from
_REACH = "_mx_reach"


def reach_of(arrays) -> frozenset:
    """The ids of the marked arrays that ``arrays`` (NDArrays) are or
    were computed from by recorded ops."""
    ids = set()
    for a in arrays:
        if a._leaves is not None:
            ids.add(id(a))
        ids.update(getattr(a._data, _REACH, ()))
    return frozenset(ids)


def tag(outputs, reach: frozenset):
    """Mark each tensor of ``outputs`` (one or a tuple) as computed from
    the marked arrays ``reach``; returns ``outputs``."""
    if reach:
        for t in (outputs if isinstance(outputs, tuple) else (outputs,)):
            if isinstance(t, torch.Tensor):
                setattr(t, _REACH, reach | getattr(t, _REACH, frozenset()))
    return outputs


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_recording(is_record: bool) -> bool:
    """Set the recording flag of this thread; returns the previous one."""
    prev = is_recording()
    _state.recording = bool(is_record)
    return prev


def set_training(train: bool) -> bool:
    """Set the training flag of this thread; returns the previous one."""
    prev = is_training()
    _state.training = bool(train)
    return prev


class _RecordingStateScope:
    """Sets the recording and training flags for a ``with`` block
    (None leaves a flag as it is) and restores them after."""

    def __init__(self, is_record: Optional[bool], train: Optional[bool]):
        self._rec, self._train = is_record, train
        self._prev_rec = self._prev_train = None

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True):
    """``with autograd.record():`` — record for :func:`backward`, in
    training mode unless ``train_mode`` is False."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """``with autograd.pause():`` — stop recording inside a ``record()``
    block (predict mode unless ``train_mode``)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """Training mode without touching the recording flag."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """Predict mode without touching the recording flag."""
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Attach gradient buffers to arrays: each array's tensor becomes a
    leaf that requires grad (its storage is kept), ``gradients[i]``
    receives its gradient per ``grad_reqs[i]`` (``write``, ``add`` or
    ``null``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, got %r"
                             % (req,))
        if not var._data.is_floating_point():
            raise ValueError("cannot attach a gradient to an array of %s"
                             % var._data.dtype)
        t = var._data
        if not (t.is_leaf and t.requires_grad):
            t = t.detach().requires_grad_(True)
        var._data = t
        var._leaves = [weakref.ref(t)]
        var._grad = g
        var._grad_req = req
        _MARKED[id(var)] = var


def _heads(heads, head_grads):
    """The head arrays, their tensors and their gradients (ones where
    none is given)."""
    from .ndarray.ndarray import NDArray
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    tensors = [h._data for h in heads]
    outs = []
    for i, t in enumerate(tensors):
        g = head_grads[i] if head_grads is not None else None
        if g is None:
            outs.append(torch.ones_like(t))
        else:
            g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
            outs.append(g.to(t.device, t.dtype))
    return list(heads), tensors, outs


_NO_REACH = ("backward: no marked variables reach the heads — call "
             "mark_variables/attach_grad and compute inside "
             "autograd.record()")


def _grad(tensors, grad_outputs, leaves, retain_graph, create_graph):
    try:
        return torch.autograd.grad(tensors, leaves, grad_outputs,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as exc:
        if "second time" not in str(exc):
            raise
        raise ValueError(
            "backward: the graph of these heads was already consumed by "
            "an earlier backward (pass retain_graph=True to keep it)") \
            from None


def _live_leaves(var):
    leaves = [r() for r in var._leaves]
    return [t for t in leaves if t is not None]


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Gradients of ``heads`` with respect to every marked array that a
    recorded op consumed on the way to them, written into the arrays'
    buffers per their ``grad_req``; an array that reaches the heads only
    through ops without a gradient gets zeros. ``head_grads`` default to
    ones. Raises ``ValueError`` when no marked array reaches the
    heads."""
    arrays, tensors, grad_outputs = _heads(heads, head_grads)
    live = [i for i, t in enumerate(tensors) if t.requires_grad]
    pairs = [(var, t) for var in list(_MARKED.values())
             for t in _live_leaves(var)]
    grads = _grad([tensors[i] for i in live],
                  [grad_outputs[i] for i in live], [t for _, t in pairs],
                  retain_graph, False) if pairs and live else ()
    acc = {}
    for (var, _), g in zip(pairs, grads):
        if g is None:
            continue
        k = id(var)
        acc[k] = (var, g if k not in acc else acc[k][1] + g)
    for k in reach_of(arrays):
        var = _MARKED.get(k)
        if var is not None and k not in acc:
            acc[k] = (var, None)
    if not acc:
        raise ValueError(_NO_REACH)
    writes, adds, zeros = ([], []), ([], []), []
    for var, g in acc.values():
        buf = var._grad
        if var._grad_req == "null" or buf is None:
            continue
        if g is None:
            if var._grad_req == "write":
                zeros.append(buf._data)
            continue
        dst = adds if var._grad_req == "add" else writes
        dst[0].append(buf._data)
        dst[1].append(g.to(buf._data.dtype))
    with torch.no_grad():
        if writes[0]:
            torch._foreach_copy_(*writes)
        if adds[0]:
            torch._foreach_add_(*adds)
        if zeros:
            torch._foreach_zero_(zeros)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (marked
    arrays), returned as new arrays; the attached buffers are left
    untouched. ``retain_graph`` defaults to True, as in the reference;
    ``create_graph`` records the gradient computation for a higher-order
    pass."""
    from .ndarray.ndarray import NDArray
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    for v in variables:
        if id(v) not in _MARKED:
            raise ValueError("grad: a variable is not marked (call "
                             "attach_grad or mark_variables first)")
    _, tensors, grad_outputs = _heads(heads, head_grads)
    if not all(t.requires_grad for t in tensors):
        raise ValueError(_NO_REACH)
    spans, leaves = [], []
    for v in variables:
        ls = _live_leaves(v)
        spans.append((len(leaves), len(leaves) + len(ls)))
        leaves.extend(ls)
    with torch.set_grad_enabled(create_graph):
        gs = _grad(tensors, grad_outputs, leaves,
                   True if retain_graph is None else retain_graph,
                   create_graph)
        outs = []
        for v, (a, b) in zip(variables, spans):
            got = [g for g in gs[a:b] if g is not None]
            total = sum(got[1:], got[0]) if got else \
                torch.zeros_like(v._data.detach())
            outs.append(NDArray(total))
    if all(g is None for g in gs):
        raise ValueError("grad: no variable reaches the heads")
    return outs[0] if single else outs


class _FunctionBridge(torch.autograd.Function):
    """A :class:`Function`'s forward and backward over NDArrays."""

    @staticmethod
    def forward(ctx, fn, *xs):
        from .ndarray.ndarray import NDArray
        with pause():
            outs = fn.forward(*[NDArray(x) for x in xs])
        single = not isinstance(outs, (list, tuple))
        ctx.fn, ctx.n_in, ctx.single = fn, len(xs), single
        return tuple(o._data for o in ([outs] if single else outs))

    @staticmethod
    def backward(ctx, *gs):
        from .ndarray.ndarray import NDArray
        with pause():
            igrads = ctx.fn.backward(*[NDArray(g) for g in gs])
        igrads = [igrads] if not isinstance(igrads, (list, tuple)) \
            else list(igrads)
        if len(igrads) != ctx.n_in:
            raise ValueError("Function.backward returned %d gradients for "
                             "%d inputs" % (len(igrads), ctx.n_in))
        return (None,) + tuple(g._data for g in igrads)


class Function:
    """A differentiable function with a user-defined gradient.

    Subclass and override :meth:`forward` (over NDArrays; it may save
    arrays on ``self``) and :meth:`backward` (output gradients to one
    gradient per input). Both run with recording paused; under
    ``record()`` the call is a ``torch.autograd.Function`` whose backward
    is :meth:`backward`."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        for a in inputs:
            a._in_graph = True
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[a._data for a in inputs])
        outs = [NDArray(o) for o in tag(outs, reach_of(inputs))]
        return outs[0] if len(outs) == 1 else outs
