"""SGD update ops, per tensor and over a list of tensors.

The port's counterpart of the reference's ``ops/optimizer_op.py``
``sgd_update`` / ``sgd_mom_update``:

    g = clip(rescale_grad * grad) + wd * weight
    sgd:      weight -= lr * g
    momentum: mom = momentum * mom - lr * g;  weight += mom

The per-tensor ops return new tensors. The ``*_multi`` forms update a
list of weights (and momenta) in place with ``torch._foreach_*``: one
multi-tensor launch per step of the formula for the whole list, which is
the port's form of the reference's fused whole-model update.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .registry import register

__all__ = ["sgd_update_multi", "sgd_mom_update_multi"]


def _clip_arg(c):
    """None or a non-positive threshold: no clipping."""
    if c is None or c <= 0:
        return None
    return c


def _grad_prep(weight, grad, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    c = _clip_arg(clip_gradient)
    if c is not None:
        g = torch.clamp(g, -c, c)
    return g + wd * weight


@register("sgd_update", num_inputs=2)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight - lr * (clip(rescale * grad) + wd * weight)."""
    return weight - lr * _grad_prep(weight, grad, rescale_grad,
                                    clip_gradient, wd)


@register("sgd_mom_update", num_inputs=3)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(weight, mom)`` after one momentum step."""
    g = _grad_prep(weight, grad, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def _grad_prep_multi(weights: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor], rescale_grad: float,
                     clip_gradient: Optional[float],
                     wd: float) -> List[torch.Tensor]:
    gs = torch._foreach_mul(list(grads), rescale_grad)
    c = _clip_arg(clip_gradient)
    if c is not None:
        torch._foreach_clamp_min_(gs, -c)
        torch._foreach_clamp_max_(gs, c)
    if wd:
        torch._foreach_add_(gs, list(weights), alpha=wd)
    return gs


@torch.no_grad()
def sgd_update_multi(weights: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor], lr: float, wd: float = 0.0,
                     rescale_grad: float = 1.0,
                     clip_gradient: Optional[float] = None) -> None:
    """``sgd_update`` on every (weight, grad) pair, in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    torch._foreach_add_(list(weights), gs, alpha=-lr)


@torch.no_grad()
def sgd_mom_update_multi(weights: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor],
                         moms: Sequence[torch.Tensor], lr: float,
                         momentum: float, wd: float = 0.0,
                         rescale_grad: float = 1.0,
                         clip_gradient: Optional[float] = None) -> None:
    """``sgd_mom_update`` on every (weight, grad, mom), in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    moms = list(moms)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, gs, alpha=-lr)
    torch._foreach_add_(list(weights), moms)
