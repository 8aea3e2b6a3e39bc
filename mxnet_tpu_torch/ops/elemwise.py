"""Elementwise binary, scalar, comparison and unary ops.

The port's counterpart of the reference's ``ops/elemwise.py``: the
same-shape ``elemwise_*`` ops and their broadcasting ``broadcast_*``
aliases share one broadcasting function, as in the reference, and the
Symbol operators (``x + h``, ``future * -1e9``) lower to these. The
unary family (``exp``, ``log``, ``abs``, ``square``, ``sqrt``, ...),
``clip``, ``Cast`` and ``BlockGrad`` are the ones Gluon's layers and
losses call.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import to_torch_dtype
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


@register("broadcast_maximum", num_inputs=2, aliases=("_maximum", "maximum"))
def broadcast_maximum(lhs, rhs):
    return torch.maximum(lhs, rhs)


# the reference's unary family (its elemwise_unary_op functors)
_UNARY = {
    "reciprocal": torch.reciprocal,
    "abs": torch.abs,
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
    "rcbrt": lambda x: 1.0 / (torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.arcsin,
    "arccos": torch.arccos,
    "arctan": torch.arctan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.arcsinh,
    "arccosh": torch.arccosh,
    "arctanh": torch.arctanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "softsign": lambda x: x / (1 + torch.abs(x)),
}


def _make_unary(name, fn):
    @register(name, aliases=("tgamma",) if name == "gamma" else ())
    def _op(data):
        return fn(data)
    _op.__doc__ = "Elementwise %s." % name
    return _op


for _name, _fn in _UNARY.items():
    _make_unary(_name, _fn)


@register("clip")
def clip(data, a_min=0.0, a_max=1.0):
    """Values clipped to ``[a_min, a_max]``."""
    return torch.clamp(data, a_min, a_max)


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    """The array in ``dtype``."""
    return data.to(to_torch_dtype(dtype))


@register("BlockGrad", aliases=("stop_gradient", "block_grad"))
def block_grad(data):
    """Identity forward, no gradient."""
    return data.detach()
