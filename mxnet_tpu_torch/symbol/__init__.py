"""``sym`` — the port's Symbol namespace: ``Variable``, ``load_json``
and one function per registered op (``sym.FullyConnected``,
``sym.reshape``, ``sym.FlashAttention``, ...)."""
from __future__ import annotations

from .symbol import NameManager, Symbol, Variable, load_json
from .symbol import _install_op_functions

__all__ = ["Symbol", "Variable", "load_json", "NameManager"]
__all__ += _install_op_functions(globals())
