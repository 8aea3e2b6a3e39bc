"""Optimizer update ops, per tensor and over a list of tensors.

The port's counterpart of the reference's ``ops/optimizer_op.py``: the
same op names and formulas (``sgd_update``, ``sgd_mom_update``,
``nag_mom_update``, ``adam_update``, ``rmsprop_update``,
``rmspropalex_update``, ``adagrad_update``, ``adadelta_update``,
``ftrl_update``, ``adamax_update``, ``sgld_update``). Every op but
AdaGrad's, AdaDelta's and Ftrl's starts from

    g = clip(rescale_grad * grad) + wd * weight

(those three take ``wd`` in their own place, as the reference's do), and
a non-positive or absent ``clip_gradient`` means no clipping. Adam's
and Adamax's ``lr`` arrives bias-corrected from the optimizer, so
Adam's ``epsilon`` stays outside the correction:
``w -= lr·sqrt(1-β₂ᵗ)/(1-β₁ᵗ) · m / (sqrt(v) + ε)``. That is not
``torch.optim.Adam``'s function, which is why these ops exist.

Each ``*_multi`` form updates lists of weights and states in place with
``torch._foreach_*``: one multi-tensor launch per step of the formula
for the whole list, the port's form of the reference's fused
whole-model update (``FusedUpdater``). The lists of one call share
``lr`` and ``wd``; the optimizer groups its parameters by them. The
per-tensor ops return new tensors and are the grouped forms over one
tensor, so the two compute the same arithmetic (on the card too, where
a fused multiply-add would otherwise part them by a rounding that
Adam's normalized step can magnify). SGLD has no ``_multi`` form: its
noise is drawn per tensor (:func:`random.torch_generator`), and the
reference keeps it off the fused path too.

The ``*_multi`` forms take each hyperparameter (``lr``, ``wd``,
``rescale_grad``, ``clip_gradient``) either as a Python number, the
eager grouped update's form, or as a 0-d tensor, the compiled update's
(``_fused.FusedUpdater``). A Python number becomes a
constant of a compiled program, which would recompile at every new
value; a tensor is an input. The helpers below (:func:`_axpy_`, :func:`_axpy`,
:func:`_addcdiv_`, :func:`_mul`, :func:`_clip_`) run the same torch
call as before for a number and the same formula over tensor operands
otherwise, so both routes share one sequence of steps.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from .registry import register

__all__ = ["sgd_update_multi", "sgd_mom_update_multi",
           "nag_mom_update_multi", "adam_update_multi",
           "rmsprop_update_multi", "rmspropalex_update_multi",
           "adagrad_update_multi", "adadelta_update_multi",
           "ftrl_update_multi", "adamax_update_multi"]

Tensors = Sequence[torch.Tensor]


def _clip_arg(c):
    """None or a non-positive threshold: no clipping. A tensor threshold
    is the compiled update's, which passes one only when clipping is on
    (its presence is part of the program's structure)."""
    if isinstance(c, torch.Tensor):
        return c
    if c is None or c <= 0:
        return None
    return c


def _mul(xs, a) -> List[torch.Tensor]:
    """``x · a`` for every x."""
    return torch._foreach_mul(list(xs), a)


def _axpy_(xs, ys, a, skip_zero=False) -> None:
    """``x += a · y`` in place; a number goes in as ``alpha`` (and, with
    ``skip_zero``, 0 skips the step), a tensor as a product."""
    if isinstance(a, torch.Tensor):
        torch._foreach_add_(xs, _mul(ys, a))
    elif a or not skip_zero:
        torch._foreach_add_(xs, ys, alpha=a)


def _axpy(xs, ys, a) -> List[torch.Tensor]:
    """``x + a · y`` for every pair, out of place."""
    if isinstance(a, torch.Tensor):
        return torch._foreach_add(list(xs), _mul(ys, a))
    return torch._foreach_add(list(xs), list(ys), alpha=a)


def _addcdiv_(xs, num, den, a) -> None:
    """``x += a · num / den`` in place."""
    if isinstance(a, torch.Tensor):
        torch._foreach_add_(xs, _mul(torch._foreach_div(num, den), a))
    else:
        torch._foreach_addcdiv_(xs, num, den, value=a)


def _clip_(gs, c) -> None:
    """``clip(g, -c, c)`` in place."""
    if isinstance(c, torch.Tensor):
        lo, hi = [-c] * len(gs), [c] * len(gs)
        torch._foreach_clamp_min_(gs, lo)
        torch._foreach_clamp_max_(gs, hi)
    else:
        torch._foreach_clamp_min_(gs, -c)
        torch._foreach_clamp_max_(gs, c)


def _grad_prep(weight, grad, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    c = _clip_arg(clip_gradient)
    if c is not None:
        g = torch.clamp(g, -c, c)
    return g + wd * weight


def _one(multi, weight, grad, states=(), **kw):
    """A per-tensor op: the grouped form over one tensor, on copies, so
    that both forms compute the same arithmetic."""
    w = weight.clone()
    ss = [s.clone() for s in states]
    multi([w], [grad], *[[s] for s in ss], **kw)
    return (w, *ss) if ss else w


@register("sgd_update", num_inputs=2)
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight - lr * (clip(rescale * grad) + wd * weight)."""
    return _one(sgd_update_multi, weight, grad, lr=lr, wd=wd,
                rescale_grad=rescale_grad, clip_gradient=clip_gradient)


@register("sgd_mom_update", num_inputs=3, num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``(weight, mom)`` after mom = momentum·mom − lr·g; weight += mom."""
    return _one(sgd_mom_update_multi, weight, grad, (mom,), lr=lr,
                momentum=momentum, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)


@register("nag_mom_update", num_inputs=3, num_outputs=2)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov: mom = momentum·mom + g; weight -= lr·(g + momentum·mom)."""
    return _one(nag_mom_update_multi, weight, grad, (mom,), lr=lr,
                momentum=momentum, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)


@register("adam_update", num_inputs=4, num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``(weight, mean, var)``; ``lr`` already bias-corrected."""
    return _one(adam_update_multi, weight, grad, (mean, var), lr=lr,
                beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
                rescale_grad=rescale_grad, clip_gradient=clip_gradient)


@register("rmsprop_update", num_inputs=3, num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """Tieleman and Hinton's RMSProp: ``(weight, n)``."""
    return _one(rmsprop_update_multi, weight, grad, (n,), lr=lr,
                gamma1=gamma1, epsilon=epsilon, wd=wd,
                rescale_grad=rescale_grad, clip_gradient=clip_gradient,
                clip_weights=clip_weights)


@register("rmspropalex_update", num_inputs=5, num_outputs=4)
def rmspropalex_update(weight, grad, n, g_acc, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' centered RMSProp: ``(weight, n, g_acc, delta)``."""
    return _one(rmspropalex_update_multi, weight, grad, (n, g_acc, delta),
                lr=lr, gamma1=gamma1, gamma2=gamma2, epsilon=epsilon, wd=wd,
                rescale_grad=rescale_grad, clip_gradient=clip_gradient,
                clip_weights=clip_weights)


@register("adagrad_update", num_inputs=3, num_outputs=2)
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``(weight, history)``; ``wd`` applies outside the scaled step."""
    return _one(adagrad_update_multi, weight, grad, (history,), lr=lr,
                epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)


@register("adadelta_update", num_inputs=4, num_outputs=3)
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``(weight, acc_g, acc_delta)``; no learning rate."""
    return _one(adadelta_update_multi, weight, grad, (acc_g, acc_delta),
                rho=rho, epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)


@register("ftrl_update", num_inputs=4, num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """Follow the regularized leader: ``(weight, z, n)``."""
    return _one(ftrl_update_multi, weight, grad, (z, n), lr=lr,
                lamda1=lamda1, beta=beta, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)


@register("adamax_update", num_inputs=4, num_outputs=3)
def adamax_update(weight, grad, mean, u, lr=0.002, beta1=0.9, beta2=0.999,
                  wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``(weight, mean, u)``; ``lr`` already bias-corrected."""
    return _one(adamax_update_multi, weight, grad, (mean, u), lr=lr,
                beta1=beta1, beta2=beta2, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)


@register("sgld_update", num_inputs=2, is_random=True)
def sgld_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, _generator=None):
    """Langevin dynamics: weight - lr/2·g + N(0, lr). The noise comes
    from ``_generator``, by default one drawn from the port's key chain
    on the weight's device."""
    if _generator is None:
        from .. import random as _random
        _generator = _random.torch_generator(weight.device)
    g = _grad_prep(weight, grad, rescale_grad, clip_gradient, wd)
    noise = torch.randn(weight.shape, generator=_generator,
                        device=weight.device, dtype=weight.dtype)
    return weight - lr / 2 * g + noise * math.sqrt(lr)


# ------------------------------------------------------------ multi forms

def _grad_prep_multi(weights: Tensors, grads: Tensors, rescale_grad: float,
                     clip_gradient: Optional[float],
                     wd: float) -> List[torch.Tensor]:
    gs = torch._foreach_mul(list(grads), rescale_grad)
    c = _clip_arg(clip_gradient)
    if c is not None:
        _clip_(gs, c)
    _axpy_(gs, list(weights), wd, skip_zero=True)
    return gs


def _clip_weights_multi(weights: List[torch.Tensor], clip_weights) -> None:
    cw = _clip_arg(clip_weights)
    if cw is not None:
        torch._foreach_clamp_min_(weights, -cw)
        torch._foreach_clamp_max_(weights, cw)


@torch.no_grad()
def sgd_update_multi(weights: Tensors, grads: Tensors, lr: float,
                     wd: float = 0.0, rescale_grad: float = 1.0,
                     clip_gradient: Optional[float] = None) -> None:
    """``sgd_update`` on every (weight, grad) pair, in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    _axpy_(list(weights), gs, -lr)


@torch.no_grad()
def sgd_mom_update_multi(weights: Tensors, grads: Tensors, moms: Tensors,
                         lr: float, momentum: float, wd: float = 0.0,
                         rescale_grad: float = 1.0,
                         clip_gradient: Optional[float] = None) -> None:
    """``sgd_mom_update`` on every (weight, grad, mom), in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    moms = list(moms)
    torch._foreach_mul_(moms, momentum)
    _axpy_(moms, gs, -lr)
    torch._foreach_add_(list(weights), moms)


@torch.no_grad()
def nag_mom_update_multi(weights: Tensors, grads: Tensors, moms: Tensors,
                         lr: float, momentum: float, wd: float = 0.0,
                         rescale_grad: float = 1.0,
                         clip_gradient: Optional[float] = None) -> None:
    """``nag_mom_update`` on every (weight, grad, mom), in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    moms = list(moms)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, gs)
    torch._foreach_add_(gs, moms, alpha=momentum)
    _axpy_(list(weights), gs, -lr)


@torch.no_grad()
def adam_update_multi(weights: Tensors, grads: Tensors, means: Tensors,
                      variances: Tensors, lr: float, beta1: float,
                      beta2: float, epsilon: float, wd: float = 0.0,
                      rescale_grad: float = 1.0,
                      clip_gradient: Optional[float] = None) -> None:
    """``adam_update`` on every (weight, grad, mean, var), in place;
    ``lr`` bias-corrected as for :func:`adam_update`."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    means, variances = list(means), list(variances)
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, gs, alpha=1 - beta1)
    torch._foreach_mul_(variances, beta2)
    torch._foreach_addcmul_(variances, gs, gs, value=1 - beta2)
    denom = torch._foreach_sqrt(variances)
    torch._foreach_add_(denom, epsilon)
    _addcdiv_(list(weights), means, denom, -lr)


@torch.no_grad()
def rmsprop_update_multi(weights: Tensors, grads: Tensors, ns: Tensors,
                         lr: float, gamma1: float, epsilon: float,
                         wd: float = 0.0, rescale_grad: float = 1.0,
                         clip_gradient: Optional[float] = None,
                         clip_weights: Optional[float] = None) -> None:
    """``rmsprop_update`` on every (weight, grad, n), in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    ns, weights = list(ns), list(weights)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_addcmul_(ns, gs, gs, value=1 - gamma1)
    denom = torch._foreach_add(ns, epsilon)
    torch._foreach_sqrt_(denom)
    _addcdiv_(weights, gs, denom, -lr)
    _clip_weights_multi(weights, clip_weights)


@torch.no_grad()
def rmspropalex_update_multi(weights: Tensors, grads: Tensors, ns: Tensors,
                             g_accs: Tensors, deltas: Tensors, lr: float,
                             gamma1: float, gamma2: float, epsilon: float,
                             wd: float = 0.0, rescale_grad: float = 1.0,
                             clip_gradient: Optional[float] = None,
                             clip_weights: Optional[float] = None) -> None:
    """``rmspropalex_update`` on every (weight, grad, n, g_acc, delta),
    in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    ns, g_accs, deltas = list(ns), list(g_accs), list(deltas)
    weights = list(weights)
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_addcmul_(ns, gs, gs, value=1 - gamma1)
    torch._foreach_mul_(g_accs, gamma1)
    torch._foreach_add_(g_accs, gs, alpha=1 - gamma1)
    denom = torch._foreach_mul(g_accs, g_accs)
    denom = torch._foreach_sub(ns, denom)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_mul_(deltas, gamma2)
    _addcdiv_(deltas, gs, denom, -lr)
    torch._foreach_add_(weights, deltas)
    _clip_weights_multi(weights, clip_weights)


@torch.no_grad()
def adagrad_update_multi(weights: Tensors, grads: Tensors,
                         histories: Tensors, lr: float, epsilon: float,
                         wd: float = 0.0, rescale_grad: float = 1.0,
                         clip_gradient: Optional[float] = None) -> None:
    """``adagrad_update`` on every (weight, grad, history), in place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, 0.0)
    histories, weights = list(histories), list(weights)
    torch._foreach_addcmul_(histories, gs, gs)
    denom = torch._foreach_add(histories, epsilon)
    torch._foreach_sqrt_(denom)
    step = torch._foreach_div(gs, denom)
    _axpy_(step, weights, wd, skip_zero=True)
    _axpy_(weights, step, -lr)


@torch.no_grad()
def adadelta_update_multi(weights: Tensors, grads: Tensors, acc_gs: Tensors,
                          acc_deltas: Tensors, rho: float, epsilon: float,
                          wd: float = 0.0, rescale_grad: float = 1.0,
                          clip_gradient: Optional[float] = None) -> None:
    """``adadelta_update`` on every (weight, grad, acc_g, acc_delta), in
    place."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, 0.0)
    acc_gs, acc_deltas = list(acc_gs), list(acc_deltas)
    weights = list(weights)
    torch._foreach_mul_(acc_gs, rho)
    torch._foreach_addcmul_(acc_gs, gs, gs, value=1 - rho)
    delta = torch._foreach_add(acc_deltas, epsilon)
    torch._foreach_sqrt_(delta)
    denom = torch._foreach_add(acc_gs, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_div_(delta, denom)
    torch._foreach_mul_(delta, gs)
    torch._foreach_mul_(acc_deltas, rho)
    torch._foreach_addcmul_(acc_deltas, delta, delta, value=1 - rho)
    decay = _mul(weights, wd) \
        if isinstance(wd, torch.Tensor) or wd else None
    torch._foreach_sub_(weights, delta)
    if decay is not None:
        torch._foreach_sub_(weights, decay)


@torch.no_grad()
def ftrl_update_multi(weights: Tensors, grads: Tensors, zs: Tensors,
                      ns: Tensors, lr: float, lamda1: float, beta: float,
                      wd: float = 0.0, rescale_grad: float = 1.0,
                      clip_gradient: Optional[float] = None) -> None:
    """``ftrl_update`` on every (weight, grad, z, n), in place. The
    thresholded weight, ``-(z - sign(z)·λ₁) / d`` where ``|z| > λ₁`` and
    0 elsewhere, is written ``-sign(z)·max(|z| - λ₁, 0) / d``: the same
    values in floating point."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, 0.0)
    zs, ns, weights = list(zs), list(ns), list(weights)
    sigma = torch._foreach_sqrt(ns)
    torch._foreach_addcmul_(ns, gs, gs)
    root_n = torch._foreach_sqrt(ns)
    sigma = torch._foreach_sub(root_n, sigma)
    torch._foreach_div_(sigma, lr)
    torch._foreach_add_(zs, gs)
    torch._foreach_mul_(sigma, weights)
    torch._foreach_sub_(zs, sigma)
    shrunk = torch._foreach_abs(zs)
    torch._foreach_sub_(shrunk, lamda1)
    torch._foreach_clamp_min_(shrunk, 0.0)
    torch._foreach_mul_(shrunk, torch._foreach_sign(zs))
    torch._foreach_add_(root_n, beta)
    torch._foreach_div_(root_n, lr)
    torch._foreach_add_(root_n, wd)
    torch._foreach_div_(shrunk, root_n)
    torch._foreach_neg_(shrunk)
    torch._foreach_copy_(weights, shrunk)


@torch.no_grad()
def adamax_update_multi(weights: Tensors, grads: Tensors, means: Tensors,
                        us: Tensors, lr: float, beta1: float, beta2: float,
                        wd: float = 0.0, rescale_grad: float = 1.0,
                        clip_gradient: Optional[float] = None) -> None:
    """``adamax_update`` on every (weight, grad, mean, u), in place;
    ``lr`` bias-corrected."""
    if not weights:
        return
    gs = _grad_prep_multi(weights, grads, rescale_grad, clip_gradient, wd)
    means, us = list(means), list(us)
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, gs, alpha=1 - beta1)
    torch._foreach_mul_(us, beta2)
    torch._foreach_maximum_(us, torch._foreach_abs(gs))
    _addcdiv_(list(weights), means, us, -lr)
