"""Elementwise binary, scalar and comparison ops of the training path.

The port's counterpart of the reference's ``ops/elemwise.py``: the
same-shape ``elemwise_*`` ops and their broadcasting ``broadcast_*``
aliases share one broadcasting function, as in the reference, and the
Symbol operators (``x + h``, ``future * -1e9``) lower to these.
"""
from __future__ import annotations

from .registry import register

__all__ = []


@register("elemwise_add", num_inputs=2,
          aliases=("_plus", "_Plus", "broadcast_add", "broadcast_plus"))
def elemwise_add(lhs, rhs):
    return lhs + rhs


@register("elemwise_sub", num_inputs=2,
          aliases=("_minus", "_Minus", "broadcast_sub", "broadcast_minus"))
def elemwise_sub(lhs, rhs):
    return lhs - rhs


@register("elemwise_mul", num_inputs=2,
          aliases=("_mul", "_Mul", "broadcast_mul"))
def elemwise_mul(lhs, rhs):
    return lhs * rhs


@register("elemwise_div", num_inputs=2,
          aliases=("_div", "_Div", "broadcast_div"))
def elemwise_div(lhs, rhs):
    return lhs / rhs


@register("broadcast_greater", num_inputs=2, aliases=("_greater",))
def broadcast_greater(lhs, rhs):
    """1 where lhs > rhs, else 0, in lhs's dtype."""
    return (lhs > rhs).to(lhs.dtype)


@register("_plus_scalar", aliases=("_PlusScalar",))
def _plus_scalar(data, scalar=0.0):
    return data + scalar


@register("_minus_scalar", aliases=("_MinusScalar",))
def _minus_scalar(data, scalar=0.0):
    return data - scalar


@register("_rminus_scalar", aliases=("_RMinusScalar",))
def _rminus_scalar(data, scalar=0.0):
    return scalar - data


@register("_mul_scalar", aliases=("_MulScalar",))
def _mul_scalar(data, scalar=1.0):
    return data * scalar


@register("_div_scalar", aliases=("_DivScalar",))
def _div_scalar(data, scalar=1.0):
    return data / scalar


@register("_rdiv_scalar", aliases=("_RDivScalar",))
def _rdiv_scalar(data, scalar=1.0):
    return scalar / data


@register("negative")
def negative(data):
    return -data
