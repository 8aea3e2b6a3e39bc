"""Gluon ``Block``, ``HybridBlock`` and ``SymbolBlock``.

The port's counterpart of the reference's ``gluon/block.py``: name
scopes and prefixes (``_BlockScope`` and the global per-hint counters),
``collect_params`` (with a regex ``select``), ``save_params`` /
``load_params``, deferred shape inference and ``hybridize``.

``hybridize``. The reference compiles one program per input signature
(shapes, dtypes, the training flag) and records it as one composite
tape op. Here the per-signature cache is kept with the same observable
behaviour — deferred parameters are materialised at the first call of a
signature, outputs and gradients equal the eager path's, BatchNorm's
running statistics are committed once per call, and a hybridized child
inside a hybridized parent runs inline — while the body runs eagerly:
compiling a cached entry (``torch.compile`` or a CUDA graph) belongs to
ROADMAP A4d / A8b, which a benchmark with cells must judge.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, List

from .. import autograd
from .. import ndarray as nd
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope(object):
    """The name manager of a Block: children created inside ``with
    block.name_scope():`` get the block's prefix and a per-block counter
    per hint; top-level blocks count globally."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_prefix(hint)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old_scope


_GLOBAL_NAME_COUNTS: Dict[str, int] = {}


def _name_prefix(hint):
    count = _GLOBAL_NAME_COUNTS.get(hint, 0)
    _GLOBAL_NAME_COUNTS[hint] = count + 1
    return "%s%d_" % (hint, count)


def _flatten(args):
    """Flatten nested lists / tuples: (flat list, format)."""
    if isinstance(args, NDArray):
        return [args], 0
    if isinstance(args, (list, tuple)):
        flat, fmts = [], []
        for a in args:
            f, fmt = _flatten(a)
            flat.extend(f)
            fmts.append(fmt)
        return flat, fmts
    return [args], -1


class Block(object):
    """The base building block: holds child blocks and parameters."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children: List[Block] = []
        self._reg_params: Dict[str, Parameter] = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  ({key}): {block}".format(
            key=i, block=repr(b).replace("\n", "\n  "))
            for i, b in enumerate(self._children))
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value)
        elif isinstance(value, Parameter):
            if name in self._reg_params and \
                    self._reg_params[name] is not value:
                raise ValueError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """``with self.name_scope():`` — children made inside get this
        block's prefix."""
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's Parameters; ``select`` (a
        regex) keeps the names that match it."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children:
            ret.update(child.collect_params(select))
        return ret

    def save_params(self, filename):
        """Save every parameter by its full name."""
        self.collect_params().save(filename)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Load parameters by full name from a file either package
        wrote, onto ``ctx`` (None: where each parameter is)."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra)

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (see ``ParameterDict.initialize``)."""
        from .. import initializer as init_mod
        self.collect_params().initialize(
            init or init_mod.Uniform(), ctx, verbose,
            force_reinit=force_reinit)

    def hybridize(self, active=True):
        """Turn the per-signature cache of child HybridBlocks on or off."""
        for child in self._children:
            child.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


_inline = threading.local()


@contextlib.contextmanager
def _inlined():
    """Hybridized blocks called inside run their body directly, as the
    reference runs a child inside its parent's trace."""
    _inline.depth = getattr(_inline, "depth", 0) + 1
    try:
        yield
    finally:
        _inline.depth -= 1


class HybridBlock(Block):
    """A Block whose forward is ``hybrid_forward(F, x, ...)`` over the
    ``nd`` namespace, with a per-signature cache when hybridized."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        # input signature -> calls served; a compiled program per entry
        # would live here (ROADMAP A4d / A8b)
        self._cached_op: Dict[tuple, int] = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def hybridize(self, active=True):
        self._active = active
        self._clear_cached_op()
        super().hybridize(active)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_op = {}

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s." % (str(block), str(type(block))))
        super().register_child(block)
        self._clear_cached_op()

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from ``args``."""
        self._deferred_infer_shape(*args)

    def _deferred_infer_shape(self, *args):
        """Resolve 0-dims in child parameters by running the forward once
        with recording off, in predict mode, hybridized children inline
        (the reference walks its symbolic graph; the probe materialises
        the parameters in the same order)."""
        with autograd.pause(train_mode=False), _inlined():
            self.forward(*args)

    def __call__(self, *args):
        if self._active:
            return self._call_cached_op(*args)
        return self.forward(*args)

    def _call_cached_op(self, *args):
        flat_args, _ = _flatten(args)
        if getattr(_inline, "depth", 0) or \
                not all(isinstance(a, NDArray) for a in flat_args):
            # inside a hybridized parent's call, or non-array inputs
            return self.forward(*args)
        sig = tuple((a.shape, str(a.dtype)) for a in flat_args) + \
            (autograd.is_training(),)
        if sig not in self._cached_op:
            params = [p for _, p in sorted(self.collect_params().items())]
            if any(p._data is None for p in params):
                self._deferred_infer_shape(*args)
            for p in params:
                p._finish_deferred_init()
        self._cached_op[sig] = self._cached_op.get(sig, 0) + 1
        with _inlined():
            return self.forward(*args)

    def forward(self, x, *args):
        """Gather the registered parameters' values and call
        ``hybrid_forward(nd, x, *args, **params)``; deferred shapes are
        resolved from ``x`` first (``shape_update``)."""
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.shape_update(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def shape_update(self, x, *args):
        """Layers with deferred parameters set their shapes from the
        input here."""
        raise DeferredInitializationError(
            "%s has uninitialized parameters and does not implement "
            "shape inference" % type(self).__name__)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path):
        raise NotImplementedError(
            "export needs the symbolic tracing frontend; save the "
            "parameters with save_params, or use Module checkpoints")


class SymbolBlock(HybridBlock):
    """A Symbol as a Block: its arguments other than ``inputs`` become
    parameters under their own names (no prefix, as in MXNet; allocated
    by deferred init or ``load_params``), its aux states parameters
    without gradient; the graph runs through the executor's
    ``graph_function``, recorded when autograd records, and a training
    call commits the new aux states."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        from .. import symbol as sym_mod
        # the graph's own names, unprefixed (MXNet's SymbolBlock)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        self._in_names = [i.name for i in inputs]
        self._symbol = outputs
        for name in outputs.list_arguments():
            if name not in self._in_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(name, grad_req="null", allow_deferred_init=True)
        self._fn = None

    def forward(self, *args):
        from ..executor import graph_function
        if self._fn is None:
            self._fn = graph_function(self._symbol)
        named = dict(zip(self._in_names, args))
        arrays = {}
        for n in self._symbol.list_arguments():
            a = named[n] if n in named else self.params[n].data()
            arrays[n] = a if isinstance(a, NDArray) else nd.array(a)
        aux = {n: self.params[n].data()
               for n in self._symbol.list_auxiliary_states()}
        train = autograd.is_training()
        dev = next(iter(arrays.values())).context
        outs, new_aux = nd.ndarray._run(
            self._fn, list(arrays.values()) + list(aux.values()),
            {n: a.data for n, a in arrays.items()},
            {n: a.data for n, a in aux.items()}, train, dev)
        if train:
            for n, v in new_aux.items():
                if v is not aux[n].data:
                    aux[n]._commit(v.detach())
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs
