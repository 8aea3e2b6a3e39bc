"""Optimizers: ``Optimizer`` and ``SGD``, per parameter and fused.

The port's counterpart of the reference's ``optimizer.py`` as far as
the training path needs it: ``lr``, ``wd``, ``rescale_grad``,
``clip_gradient``, per-parameter lr/wd multipliers (``wd_mult`` is 0
for every parameter whose name does not end in ``_weight`` or
``_gamma``, as in the reference), ``create``, ``get_updater`` and
``Updater``.

Besides the per-parameter :meth:`Optimizer.update` (the reference's
eager path), :meth:`Optimizer.update_multi` updates every parameter of
a model in one go: parameters are grouped by their effective (lr, wd)
and each group is one ``torch._foreach_*`` sequence — the port's form of
the reference's fused whole-model update (``raw_update`` traced into the
train step, ``FusedUpdater``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from . import ndarray as nd
from .ndarray import NDArray
from .ops.optimizer_op import (sgd_mom_update, sgd_mom_update_multi,
                               sgd_update, sgd_update_multi)

__all__ = ["Optimizer", "SGD", "create", "get_updater", "Updater",
           "register"]


class Optimizer(object):
    """Base optimizer."""

    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name: str, **kwargs) -> "Optimizer":
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s (this slice of the port "
                         "has %s)" % (name, sorted(Optimizer.opt_registry)))

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, sym=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym

    def create_state(self, index, weight: NDArray):
        return None

    def update(self, index, weight: NDArray, grad: NDArray, state) -> None:
        raise NotImplementedError

    def update_multi(self, indices: Sequence, weights: List[torch.Tensor],
                     grads: List[torch.Tensor], states: List) -> None:
        """One step for every (weight, grad, state), in place."""
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult: Dict[str, float]):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[str, float]):
        """Parameters whose names end in neither ``_weight`` nor
        ``_gamma`` (biases, betas) get no weight decay."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _resolve_mult(self, mults: Dict[Any, float], index) -> float:
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        return self.lr * self._resolve_mult(self.lr_mult, index)

    def _get_wd(self, index) -> float:
        return self.wd * self._resolve_mult(self.wd_mult, index)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight: NDArray):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = {"rescale_grad": self.rescale_grad,
              "clip_gradient": self.clip_gradient}
        g = grad.data.to(weight.data.dtype)
        with torch.no_grad():
            if state is None:
                weight.data.copy_(sgd_update(weight.data, g, lr=lr, wd=wd,
                                             **kw))
            else:
                w, m = sgd_mom_update(weight.data, g, state.data, lr=lr,
                                      momentum=self.momentum, wd=wd, **kw)
                weight.data.copy_(w)
                state.data.copy_(m)

    def update_multi(self, indices, weights, grads, states):
        groups: Dict[tuple, List[int]] = {}
        for pos, index in enumerate(indices):
            key = (self._get_lr(index), self._get_wd(index))
            groups.setdefault(key, []).append(pos)
        for (lr, wd), pos in groups.items():
            ws = [weights[i] for i in pos]
            gs = [grads[i] for i in pos]
            if self.momentum == 0.0:
                sgd_update_multi(ws, gs, lr, wd, self.rescale_grad,
                                 self.clip_gradient)
            else:
                sgd_mom_update_multi(ws, gs, [states[i].data for i in pos],
                                     lr, self.momentum, wd,
                                     self.rescale_grad, self.clip_gradient)


class Updater(object):
    """Applies an optimizer to indexed weights, creating per-index state
    lazily."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def _state(self, index, weight: NDArray):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        return self.states[index]

    def __call__(self, index, grad: NDArray, weight: NDArray) -> None:
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, indices: Sequence, weights: Sequence[NDArray],
                     grads: Sequence[torch.Tensor]) -> None:
        """One fused step over every (index, weight, grad)."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(list(indices),
                                    [w.data for w in weights],
                                    [g.data if isinstance(g, NDArray) else g
                                     for g in grads], states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
