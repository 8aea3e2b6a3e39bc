"""Custom operators written in Python — the user escape hatch.

The port's counterpart of ``mxnet_tpu/operator.py`` (reference MXNet:
``python/mxnet/operator.py`` ``CustomOp``, ``CustomOpProp``,
``register``): user code defines forward and backward, a Prop class
declares the arguments, outputs and shapes, and ``register("op_type")``
makes ``nd.Custom`` / ``sym.Custom`` dispatch to it by ``op_type``.
``Custom`` is an ordinary registry op, so it works in Symbol graphs,
``Module``'s training step and ``torch.autograd``.

Two paths, as in the reference:

* the **host path** (a Prop whose ``create_operator`` returns a
  :class:`CustomOp`): ``forward`` and ``backward`` run over NDArrays in
  a ``torch.autograd.Function``. The reference needs a host callback out
  of the compiled XLA program for this; eager PyTorch calls the Python
  directly, on the inputs' device, inside a ``device_scope`` of that
  device so that arrays the user makes land beside them;
* the **traced path** (a Prop that overrides ``forward_traced``, and
  optionally ``backward_traced``): functions over tensors, which may
  call hand-written kernels (``rtc.UserKernel``). With
  ``backward_traced`` the op is a ``torch.autograd.Function`` whose
  backward it is; without, autograd differentiates ``forward_traced``.
  A Prop with ``need_top_grad=False`` (a loss head) must override
  ``backward_traced``, whose incoming gradient it may ignore.

The reference's legacy ``PythonOp`` / ``NumpyOp`` / ``NDArrayOp``
classes are not ported yet (ROADMAP.md queue A10).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from .context import device_scope
from .ndarray.ndarray import NDArray, to_numpy_dtype, to_torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_class"]

_PROP_REGISTRY: Dict[str, type] = {}


class CustomOp(object):
    """Base class of a custom operator's implementation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs from ``in_data`` into ``out_data`` via
        :meth:`assign`."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients into ``in_grad`` via :meth:`assign`."""
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request ``req`` says."""
        if req == "null":
            return
        elif req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("invalid req %r" % req)


class CustomOpProp(object):
    """Declares a custom op's interface. Subclass and override
    ``list_arguments`` / ``list_outputs`` / ``infer_shape`` and either
    ``create_operator`` (host path) or ``forward_traced`` (traced path).
    ``need_top_grad`` says whether backward consumes the head gradient
    (False for a loss head)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        """Default: every input and output shaped as ``in_shape[0]``."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def need_top_grad(self) -> bool:
        return self.need_top_grad_

    def forward_traced(self, in_data, is_train):
        """OPTIONAL: the outputs, as a tuple of tensors, computed from the
        input tensors by PyTorch code or kernels. Overriding it commits
        the op to the traced path; gradients come from autograd of this
        function unless :meth:`backward_traced` is overridden too."""
        raise NotImplementedError

    def backward_traced(self, out_grad, in_data, out_data):
        """OPTIONAL: the gradient of each input (a tuple, one per input;
        those of integer inputs are dropped) from the output gradients,
        inputs and outputs. With ``need_top_grad=False`` the incoming
        ``out_grad`` may be ignored (loss-op semantics)."""
        raise NotImplementedError

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name: str):
    """Class decorator: ``@mt.operator.register("my_op")`` on a
    :class:`CustomOpProp` subclass."""

    def _reg(prop_cls):
        if not (isinstance(prop_cls, type) and
                issubclass(prop_cls, CustomOpProp)):
            raise TypeError("register() expects a CustomOpProp subclass")
        _PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return _reg


def get_prop_class(op_type: str) -> type:
    try:
        return _PROP_REGISTRY[op_type]
    except KeyError:
        raise KeyError(
            "custom op type %r not registered — decorate its CustomOpProp "
            "with @mt.operator.register(%r)" % (op_type, op_type)) from None


def _make_prop(op_type: str, attrs: Dict[str, Any]) -> CustomOpProp:
    """Instantiate the Prop with the user's attributes (the reference
    passes every attribute as a keyword)."""
    kwargs = {k: v for k, v in attrs.items()
              if not k.startswith("_") and k != "op_type"}
    return get_prop_class(op_type)(**kwargs)


def _out_specs(prop: CustomOpProp, arrays) -> List[Tuple[tuple, torch.dtype]]:
    """``(shape, dtype)`` of each output from the Prop's rules."""
    _, oshapes, _ = prop.infer_shape([list(a.shape) for a in arrays])
    _, otypes, _ = prop.infer_type([to_numpy_dtype(a.dtype) for a in arrays])
    return [(tuple(int(d) for d in s), to_torch_dtype(t))
            for s, t in zip(oshapes, otypes)]


def _checked(outs, specs, op_type: str) -> Tuple[torch.Tensor, ...]:
    outs = tuple(outs)
    got = [(tuple(o.shape), o.dtype) for o in outs]
    if got != specs:
        raise ValueError("forward_traced of %r returned %s, but infer_shape/"
                         "infer_type declare %s" % (op_type, got, specs))
    return outs


class _TracedCustom(torch.autograd.Function):
    """``forward_traced`` with ``backward_traced`` as its gradient."""

    @staticmethod
    def forward(ctx, prop, op_type, is_train, specs, *xs):
        outs = _checked(prop.forward_traced(list(xs), is_train), specs,
                        op_type)
        ctx.save_for_backward(*xs, *outs)
        ctx.prop, ctx.op_type, ctx.n_in = prop, op_type, len(xs)
        return outs

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        gs = ctx.prop.backward_traced(list(cts), list(xs), list(outs))
        if gs is None or len(gs) != len(xs):
            raise ValueError("backward_traced of %r must return one gradient "
                             "per input (%d); leave it un-overridden to use "
                             "autograd" % (ctx.op_type, len(xs)))
        return (None, None, None, None) + tuple(
            g.to(x.dtype) if g is not None and x.is_floating_point() else None
            for g, x in zip(gs, xs))


class _HostCustom(torch.autograd.Function):
    """A :class:`CustomOp`'s ``forward``/``backward`` over NDArrays."""

    @staticmethod
    def forward(ctx, op_inst, prop, is_train, specs, *xs):
        dev = xs[0].device
        out_data = [NDArray(torch.zeros(s, dtype=t, device=dev))
                    for s, t in specs]
        with device_scope(dev):
            op_inst.forward(is_train=is_train, req=["write"] * len(specs),
                            in_data=[NDArray(x) for x in xs],
                            out_data=out_data, aux=[])
        outs = tuple(o.data for o in out_data)
        ctx.save_for_backward(*xs, *outs)
        ctx.op_inst, ctx.prop, ctx.n_in = op_inst, prop, len(xs)
        return outs

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grad = [NDArray(torch.zeros_like(x)) for x in xs]
        with device_scope(xs[0].device):
            ctx.op_inst.backward(
                req=["write"] * len(xs),
                out_grad=[NDArray(c) for c in cts]
                if ctx.prop.need_top_grad() else [],
                in_data=[NDArray(x) for x in xs],
                out_data=[NDArray(o) for o in outs], in_grad=in_grad, aux=[])
        return (None, None, None, None) + tuple(
            g.data if x.is_floating_point() else None
            for g, x in zip(in_grad, xs))


def _custom_impl(arrays: Sequence[torch.Tensor], op_type: str,
                 attrs: Dict[str, Any], is_train: bool):
    prop = _make_prop(op_type, attrs)
    arg_names = prop.list_arguments()
    if prop.list_auxiliary_states():
        raise NotImplementedError(
            "auxiliary states on custom ops are not supported yet")
    if len(arrays) != len(arg_names):
        raise ValueError("custom op %r expects %d inputs %s, got %d"
                         % (op_type, len(arg_names), arg_names, len(arrays)))
    specs = _out_specs(prop, arrays)
    cls = type(prop)
    if cls.forward_traced is not CustomOpProp.forward_traced:
        if cls.backward_traced is CustomOpProp.backward_traced:
            if not prop.need_top_grad():
                # autograd would multiply by the head gradient that a loss
                # op promises to ignore: the op would train on ~zero grads
                raise ValueError(
                    "custom op %r declares need_top_grad=False (loss-op "
                    "semantics) but overrides only forward_traced; "
                    "autograd would consume the head gradient it promises "
                    "to ignore — override backward_traced too" % op_type)
            outs = _checked(prop.forward_traced(list(arrays), is_train),
                            specs, op_type)
        else:
            outs = _TracedCustom.apply(prop, op_type, is_train, specs,
                                       *arrays)
    else:
        op_inst = prop.create_operator(
            arrays[0].device, [list(a.shape) for a in arrays],
            [to_numpy_dtype(a.dtype) for a in arrays])
        outs = _HostCustom.apply(op_inst, prop, is_train, specs, *arrays)
    return outs[0] if len(outs) == 1 else tuple(outs)


def _register_custom_op():
    from .ops.registry import register as reg_op

    def _prop_of(attrs):
        if "op_type" not in attrs:
            raise ValueError("Custom op needs op_type=")
        return _make_prop(attrs["op_type"], attrs)

    def meta_fn(*arrays, **attrs):
        outs = tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in _out_specs(_prop_of(attrs), arrays))
        return outs[0] if len(outs) == 1 else outs

    @reg_op("Custom", num_inputs=None,
            num_outputs=lambda attrs: len(_prop_of(attrs).list_outputs()),
            meta_fn=meta_fn)
    def custom(*arrays, op_type=None, _is_train=False, **attrs):
        """Dispatch to the CustomOpProp registered as ``op_type``."""
        if op_type is None:
            raise ValueError("Custom op needs op_type=")
        return _custom_impl(arrays, op_type, attrs, bool(_is_train))

    custom.input_names_fn = lambda attrs: list(
        _prop_of(attrs).list_arguments())


_register_custom_op()
