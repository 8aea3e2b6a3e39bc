"""Reductions: ``sum``, ``mean``, ``prod``, ``max``, ``min``, ``argmax``,
``argmin`` and ``norm``.

The port's counterpart of the reference's ``ops/reduce.py``, with its
``axis`` / ``keepdims`` / ``exclude`` attributes: no axis (None or
``()``) reduces every axis, ``exclude`` reduces every axis but the
listed ones (so ``exclude`` with no axis reduces none), and ``argmax``
/ ``argmin`` return float32 indices, as the reference does.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _axes(axis, ndim, exclude=False):
    """The axes to reduce, as a tuple (``()``: none)."""
    if axis is None or axis == ():
        return () if exclude else tuple(range(ndim))
    ax = (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)
    ax = tuple(a % ndim for a in ax)
    if exclude:
        ax = tuple(a for a in range(ndim) if a not in ax)
    return ax


def _make_reduce(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def _op(data, axis=None, keepdims=False, exclude=False):
        ax = _axes(axis, data.dim(), exclude)
        if not ax:
            return data
        return fn(data, ax, bool(keepdims))
    _op.__doc__ = "Reduce-%s over ``axis`` (all axes by default)." % name
    return _op


def _prod(x, ax, keepdims):
    for a in sorted(ax, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_make_reduce("sum", lambda x, ax, k: torch.sum(x, dim=ax, keepdim=k),
             aliases=("sum_axis",))
_make_reduce("mean", lambda x, ax, k: torch.mean(x, dim=ax, keepdim=k))
_make_reduce("prod", _prod)
_make_reduce("max", lambda x, ax, k: torch.amax(x, dim=ax, keepdim=k),
             aliases=("max_axis",))
_make_reduce("min", lambda x, ax, k: torch.amin(x, dim=ax, keepdim=k),
             aliases=("min_axis",))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    """Index of the largest element along ``axis`` (of the flattened
    array without one), as float32."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    """Index of the smallest element along ``axis``, as float32."""
    return _arg(torch.argmin, data, axis, keepdims)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """The L2 norm (``ord=1``: the L1 norm) over ``axis`` (all axes by
    default)."""
    ax = _axes(axis, data.dim())
    if ord == 1:
        return torch.sum(data.abs(), dim=ax, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(data * data, dim=ax, keepdim=bool(keepdims)))
