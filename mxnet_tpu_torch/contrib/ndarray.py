"""``contrib.nd`` — imperative wrappers for the ``_contrib_*`` registry
ops (the port's copy of the reference's ``contrib/ndarray.py``)."""
from __future__ import annotations

from ..ops.registry import OP_REGISTRY


def __getattr__(name):
    op = OP_REGISTRY.get("_contrib_" + name)
    if op is None:
        raise AttributeError(
            "module %r has no attribute %r (no registry op named "
            "'_contrib_%s')" % (__name__, name, name))
    from ..ndarray.ndarray import imperative_invoke

    def wrapper(*args, **kwargs):
        return imperative_invoke(op, *args, **kwargs)

    wrapper.__name__ = name
    wrapper.__doc__ = op.__doc__
    globals()[name] = wrapper
    return wrapper


def __dir__():
    return sorted(set(globals()) | {
        n[len("_contrib_"):] for n in OP_REGISTRY if n.startswith("_contrib_")})
