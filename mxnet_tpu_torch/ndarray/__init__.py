"""``nd`` — the port's imperative array namespace.

Every registered op gets a wrapper, ``nd.<op>``, that runs it through
:func:`imperative_invoke`, as the reference builds ``mx.nd.*`` from its
op registry at import; ``nd.random`` holds the samplers under their
later names (``nd.random.uniform``, ...). Ops registered later (a user
kernel's ``rtc.UserKernel.register``, ``operator``'s ``Custom``) resolve
on first use through the module's ``__getattr__`` (PEP 562). So do the
built-in ops registered after this module is first imported: ``ops``
itself imports it.
"""
from __future__ import annotations

import sys as _sys

from ..ops.registry import OP_REGISTRY, get_op
from .ndarray import (NDArray, array, concatenate, empty, imperative_invoke,
                      load, moveaxis, onehot_encode, ones, save, waitall,
                      zeros)

__all__ = ["NDArray", "array", "concatenate", "zeros", "ones", "empty",
           "waitall", "moveaxis", "onehot_encode", "imperative_invoke",
           "save", "load", "get_op"]


def _make_wrapper(op):
    def wrapper(*args, **kwargs):
        return imperative_invoke(op, *args, **kwargs)
    wrapper.__name__ = op.name
    wrapper.__doc__ = op.__doc__
    return wrapper


_this_module = _sys.modules[__name__]
for _name, _op in list(OP_REGISTRY.items()):
    if not hasattr(_this_module, _name):
        setattr(_this_module, _name, _make_wrapper(_op))
        __all__.append(_name)

# the samplers' names in the later reference: nd.random.uniform, ...
RANDOM_NAMES = {"uniform": "_random_uniform", "normal": "_random_normal",
                "gamma": "_random_gamma",
                "exponential": "_random_exponential",
                "poisson": "_random_poisson",
                "negative_binomial": "_random_negative_binomial",
                "generalized_negative_binomial":
                    "_random_generalized_negative_binomial",
                "multinomial": "_sample_multinomial", "shuffle": "shuffle"}


class _RandomNamespace:
    """``nd.random``: one attribute per sampler, made on first use (the
    samplers register after this module is first imported)."""

    def __init__(self, make):
        self._make = make

    def __dir__(self):
        return sorted(RANDOM_NAMES)

    def __getattr__(self, name):
        if name not in RANDOM_NAMES:
            raise AttributeError("random has no sampler %r" % name)
        fn = self._make(OP_REGISTRY[RANDOM_NAMES[name]])
        setattr(self, name, fn)
        return fn


random = _RandomNamespace(_make_wrapper)

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
        setattr(_this_module, name, wrapper)
        return wrapper
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
