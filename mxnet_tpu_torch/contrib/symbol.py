"""``contrib.sym`` — symbolic wrappers for the ``_contrib_*`` registry
ops (the port's copy of the reference's ``contrib/symbol.py``)."""
from __future__ import annotations

from ..ops.registry import OP_REGISTRY


def __getattr__(name):
    op = OP_REGISTRY.get("_contrib_" + name)
    if op is None:
        raise AttributeError(
            "module %r has no attribute %r (no registry op named "
            "'_contrib_%s')" % (__name__, name, name))
    from ..symbol.symbol import make_symbol_function

    fn = make_symbol_function(op)
    globals()[name] = fn
    return fn


def __dir__():
    return sorted(set(globals()) | {
        n[len("_contrib_"):] for n in OP_REGISTRY if n.startswith("_contrib_")})
