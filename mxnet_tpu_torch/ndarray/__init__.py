"""``nd`` — the port's imperative array namespace.

Every registered op gets a wrapper, ``nd.<op>``, that runs it through
:func:`imperative_invoke`, as the reference builds ``mx.nd.*`` from its
op registry at import. Ops registered later (a user kernel's
``rtc.UserKernel.register``, ``operator``'s ``Custom``) resolve on first
use through the module's ``__getattr__`` (PEP 562). So do the built-in
ops registered after this module is first imported: ``ops`` itself
imports it.
"""
from __future__ import annotations

import sys as _sys

from ..ops.registry import OP_REGISTRY
from .ndarray import (NDArray, array, concatenate, imperative_invoke, load,
                      ones, save, zeros)

__all__ = ["NDArray", "array", "concatenate", "zeros", "ones",
           "imperative_invoke", "save", "load"]


def _make_wrapper(op):
    def wrapper(*args, **kwargs):
        return imperative_invoke(op, *args, **kwargs)
    wrapper.__name__ = op.name
    wrapper.__doc__ = op.__doc__
    return wrapper


_mod = _sys.modules[__name__]
for _name, _op in list(OP_REGISTRY.items()):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_wrapper(_op))
        __all__.append(_name)

# the later reference's alias: nd.contrib.<name> for the _contrib_<name>
# ops (their canonical home is contrib.nd)
from ..contrib import ndarray as contrib  # noqa: E402


def __dir__():
    return sorted(set(globals()) | set(OP_REGISTRY))


def __getattr__(name):
    """Ops registered after this module (``ops`` imports it while it
    registers its own) resolve here (PEP 562)."""
    if name in OP_REGISTRY:
        wrapper = _make_wrapper(OP_REGISTRY[name])
        setattr(_mod, name, wrapper)
        return wrapper
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
