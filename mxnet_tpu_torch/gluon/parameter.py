"""Gluon ``Parameter`` and ``ParameterDict``.

The port's counterpart of the reference's ``gluon/parameter.py``: a
``Parameter`` holds one value and one gradient on one device, with
deferred initialization for shapes that the first forward resolves;
a ``ParameterDict`` is a prefix-scoped registry shared across blocks.

One device per parameter: ``initialize(ctx=[a, b])`` with more than one
device raises (several devices are ROADMAP A9). A parameter that asks
for a gradient is marked for autograd (``autograd.mark_variables``): its
tensor is a leaf that requires grad, and ``backward`` writes its buffer.

Initial weights come from the initializer's numpy draws in the order
parameters are materialised: at ``initialize`` for known shapes, else
at the first forward, layer by layer, as in the reference, so a seeded
initializer (``set_rng``) gives both packages the same weights.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context, cpu, current_device, resolve_device
from ..initializer import InitDesc
from ..ndarray.ndarray import to_torch_dtype

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter was accessed before its shape was known."""


def _one_device(ctx) -> torch.device:
    """The device of ``ctx`` (None: the current device); a list of more
    than one device raises."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                "Parameters on %d devices: the port keeps each parameter "
                "on one device (several devices are ROADMAP.md queue A9)"
                % len(ctx))
        ctx = ctx[0]
    return resolve_device(ctx)


def _initializer(init):
    return init_mod.create(init) if isinstance(init, str) else init


class Parameter(object):
    """A Block's parameter: a value, a gradient buffer per ``grad_req``,
    and its lr / wd multipliers."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        if not differentiable:
            grad_req = "null"
        self._grad_req = grad_req
        self._data: Optional[nd.NDArray] = None
        self._grad: Optional[nd.NDArray] = None
        self._deferred_init = ()    # (init, device, default_init)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, np.dtype(self.dtype).name)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, got %r"
                             % (req,))
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
        elif self._data is not None:
            self._init_grad()

    # ------------------------------------------------------------- init
    def _shape_known(self) -> bool:
        return self.shape is not None and not any(s == 0
                                                  for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize now if the shape is known, else at the first
        forward (``allow_deferred_init``). ``ctx`` is one device (None:
        the current device)."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        dev = _one_device(ctx)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, dev, default_init)
                return
            raise ValueError(
                "Cannot initialize Parameter %s because it has invalid "
                "shape: %s." % (self.name, str(self.shape)))
        self._finish_init(init, dev, default_init)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, dev, default_init = self._deferred_init
        self._deferred_init = ()
        if not self._shape_known():
            raise DeferredInitializationError(
                "deferred init of %s failed: shape still unknown (%s)"
                % (self.name, self.shape))
        self._finish_init(init, dev, default_init)

    def _finish_init(self, init, dev, default_init):
        data = nd.zeros(self.shape, dtype=self.dtype, ctx=dev)
        initializer = init if init is not None else \
            (self.init if self.init is not None else default_init)
        _initializer(initializer)(InitDesc(self.name, {"__init__": ""}),
                                  data)
        self._data = data
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = nd.NDArray(torch.zeros_like(self._data.data.detach()))
        autograd.mark_variables([self._data], [self._grad],
                                grad_reqs=self._grad_req)

    def _load_init(self, data, ctx=None):
        """Take a checkpoint's value: onto ``ctx`` if given, else the
        device the parameter is on or was to be initialized on, else the
        current device."""
        if self._shape_known() and tuple(data.shape) != tuple(self.shape):
            raise ValueError(
                "Failed loading Parameter %s from saved params: shape "
                "mismatch %s vs %s" % (self.name, data.shape, self.shape))
        if ctx is not None:
            dev = _one_device(ctx)
        elif self._data is not None:
            dev = self._data.data.device
        elif self._deferred_init:
            dev = self._deferred_init[1]
        else:
            dev = current_device()
        self.shape = tuple(data.shape)
        self._deferred_init = ()
        self._data = nd.NDArray(data.data.detach().to(
            dev, to_torch_dtype(self.dtype), copy=True))
        if self._grad_req != "null":
            self._init_grad()

    # ------------------------------------------------------------- access
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise MXNetError(
            "Parameter %s has not been initialized. You should initialize "
            "parameters with Block.collect_params().initialize(...)"
            % self.name)

    def data(self, ctx=None) -> nd.NDArray:
        """The value (an NDArray whose tensor is an autograd leaf when the
        parameter asks for a gradient)."""
        self._check_initialized()
        return self._data

    def list_data(self) -> List[nd.NDArray]:
        return [self.data()]

    def grad(self, ctx=None) -> nd.NDArray:
        self._check_initialized()
        if self._grad is None:
            raise MXNetError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        return self._grad

    def list_grad(self) -> List[nd.NDArray]:
        return [self.grad()]

    def list_ctx(self) -> List[Context]:
        if self._data is None and self._deferred_init:
            return [Context(self._deferred_init[1])]
        self._check_initialized()
        return [self._data.context]

    def set_data(self, data):
        """Overwrite the value (an NDArray or an array-like)."""
        self._check_initialized()
        if not isinstance(data, nd.NDArray):
            data = nd.array(data, ctx=self._data.context, dtype=self.dtype)
        self._data[:] = data

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def var(self):
        """A Symbol variable for this parameter."""
        from .. import symbol as sym
        return sym.Variable(self.name, shape=self.shape,
                            lr_mult=self.lr_mult, wd_mult=self.wd_mult)

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            self._data = nd.NDArray(self._data.data.detach().to(
                to_torch_dtype(dtype)))
            if self._grad_req != "null":
                self._init_grad()

    def reset_ctx(self, ctx):
        """Move the value (and a fresh gradient) to device ``ctx``."""
        if self._data is not None:
            self._data = nd.NDArray(self._data.data.detach().to(
                _one_device(ctx), copy=True))
            if self._grad_req != "null":
                self._init_grad()
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, _one_device(ctx), default_init)


class ParameterDict(object):
    """A prefix-scoped, ordered dict of Parameters, shared between blocks
    through ``shared``."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "%s(\n%s\n)" % (self._prefix or "ParameterDict",
                               "\n".join("  " + repr(p)
                                         for p in self._params.values()))

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs) -> Parameter:
        """Create or retrieve ``self.prefix + name``; unknown (0) dims of
        an existing parameter's shape merge with the requested ones."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is not None and v is not None:
                if k == "shape" and len(v) == len(existing):
                    param.shape = tuple(a if a != 0 else b
                                        for a, b in zip(v, existing))
                    continue
                if str(existing) != str(v) and k != "init":
                    raise MXNetError(
                        "Parameter %s already exists with a different %s "
                        "(%s, not %s)" % (name, k, existing, v))
            else:
                setattr(param, k if k != "grad_req" else "_grad_req", v)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise MXNetError("Cannot update because keys have "
                                     "different values (%s)" % k)
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter with ``init`` as the default (a
        parameter's own ``init`` wins), on one device ``ctx`` (None: the
        current device, which raises without a GPU)."""
        if init is None:
            init = init_mod.Uniform()
        init = _initializer(init)
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every value by name (``nd.save``'s npz container, which
        the reference loads too)."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix %s is to be stripped before saving, but "
                    "Parameter %s does not start with %s"
                    % (strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = \
                param.data().copyto(cpu())
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load values by name from a file either package saved (npz or
        binary ``.params``)."""
        arg_dict = nd.load(filename, ctx=cpu())
        if restore_prefix:
            arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter %s is missing in file %s"
                                     % (name, filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError(
                        "Parameter %s loaded from file %s is not present in "
                        "ParameterDict" % (name, filename))
                continue
            self[name]._load_init(value, ctx)
