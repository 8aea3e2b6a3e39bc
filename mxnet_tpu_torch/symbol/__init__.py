"""``sym`` — the port's Symbol namespace: ``Variable``, ``Group``,
``load_json`` and one function per registered op (``sym.FullyConnected``,
``sym.reshape``, ``sym.FlashAttention``, ...). Ops registered after
import (``rtc.UserKernel.register``, ``operator``'s ``Custom``) resolve
on first use through the module's ``__getattr__`` (PEP 562), as in the
reference."""
from __future__ import annotations

from ..ops import OP_REGISTRY
from .symbol import Group, NameManager, Symbol, Variable, load, load_json
from .symbol import _install_op_functions, make_symbol_function

__all__ = ["Symbol", "Variable", "Group", "load", "load_json",
           "NameManager"]
__all__ += _install_op_functions(globals())

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
