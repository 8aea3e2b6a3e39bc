"""``sym`` — the port's Symbol namespace: ``Variable`` (``var``),
``Group``, ``load_json``, one function per registered op
(``sym.FullyConnected``, ``sym.reshape``, ``sym.FlashAttention``, ...)
and ``sym.random`` (the samplers, as ``nd.random``). Ops registered
after import (``rtc.UserKernel.register``, ``operator``'s ``Custom``)
resolve on first use through the module's ``__getattr__`` (PEP 562), as
in the reference. Common ops are also Symbol methods (``s.sum()``,
``s.reshape((2, 3))``), attached as the reference attaches them."""
from __future__ import annotations

from ..ops import OP_REGISTRY, get_op
from .symbol import Group, NameManager, Symbol, Variable, load, load_json
from .symbol import _create, _install_op_functions, make_symbol_function
from .symbol import var

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager"]
__all__ += _install_op_functions(globals())

# the reference's list (mxnet_tpu/symbol/__init__.py); a name attaches
# when it is a registered op and not already a Symbol attribute
# (``astype`` is registered in neither package)
_METHOD_NAMES = (
    "sum", "mean", "max", "min", "prod", "argmax", "argmin", "clip",
    "abs", "sign", "round", "floor", "ceil", "sqrt", "square", "exp",
    "log", "sigmoid", "tanh", "relu", "softmax", "log_softmax",
    "transpose", "swapaxes", "flatten", "expand_dims", "repeat", "tile",
    "flip", "sort", "argsort", "topk", "take", "one_hot",
    "broadcast_to", "slice_axis", "squeeze", "norm", "split", "slice",
    "reshape", "dot", "astype",
)


def _symbol_method(nm: str):
    def method(self, *args, **kwargs):
        """``op(self, *args, **kwargs)``: Symbol arguments are further
        inputs; other positional arguments fill the op's parameters
        after its first, in order."""
        op = get_op(nm)
        syms = [self] + [a for a in args if isinstance(a, Symbol)]
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol)}
        pos_attrs = [a for a in args if not isinstance(a, Symbol)]
        attrs.update(zip(op.param_names[1:], pos_attrs))
        return _create(op, syms, attrs, attrs.pop("name", None))

    method.__name__ = nm
    return method


for _nm in _METHOD_NAMES:
    if _nm in OP_REGISTRY and not hasattr(Symbol, _nm):
        setattr(Symbol, _nm, _symbol_method(_nm))

# the samplers under their later names: sym.random.uniform, ...
from ..ndarray import _RandomNamespace  # noqa: E402

random = _RandomNamespace(make_symbol_function)

# the later reference's alias: sym.contrib.<name> for the _contrib_<name>
# ops (their canonical home is contrib.sym)
from ..contrib import symbol as contrib  # noqa: E402


def __getattr__(name):
    """Ops registered after import resolve here (PEP 562)."""
    if name in OP_REGISTRY:
        fn = make_symbol_function(OP_REGISTRY[name])
        globals()[name] = fn
        return fn
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
