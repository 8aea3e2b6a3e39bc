"""Optimizers, per parameter and grouped, and the Updater that holds
their state.

The port's counterpart of the reference's ``optimizer.py``: ``SGD``
(momentum, multi-precision: an f16 weight with an f32 master copy),
``NAG``, ``SGLD``, ``DCASGD``, ``Adam``, ``AdaGrad``, ``RMSProp`` (plain
and centered), ``AdaDelta``, ``Ftrl``, ``Adamax``, ``Nadam``, ``Test``
and the name ``ccsgd`` (SGD), with ``lr``, ``wd``, ``rescale_grad``,
``clip_gradient``, ``lr_scheduler``, ``begin_num_update``, per-parameter
lr/wd multipliers (``wd_mult`` is 0 for every parameter whose name ends
in neither ``_weight`` nor ``_gamma``), ``create``, ``get_updater`` and
``Updater``. Each optimizer keeps the reference's state structure
(Adam's ``(mean, var)``, Nadam's ``(mean, var, m_schedule)`` with a
``(1,)`` schedule, DCASGD's ``(mom, weight_previous)``, multi-precision
SGD's ``(mom, master)``), which checkpoints and ``.states`` files carry
by name.

Two forms of one step:

* :meth:`Optimizer.update`, per parameter, the reference's eager path:
  the learning rate (the scheduler's, when there is one) is read at the
  current ``num_update``, then the parameter's count advances;
* :meth:`Optimizer.update_multi`, every parameter of a model at once:
  parameters are grouped by their effective (lr, wd, count) and each
  group is one ``torch._foreach_*`` sequence (``ops/optimizer_op.py``),
  the port's form of the reference's fused update. Without ``lr`` it
  reproduces the per-parameter sequence exactly, a scheduler boundary
  included (the reference's ``FusedUpdater``; ``Trainer.step``). With
  ``lr`` and ``t`` every parameter takes that rate and count, as the
  reference's fused ``Module`` step does (``Module._fit_step``).
  ``SGLD`` (fresh noise per tensor) and optimizers without a grouped
  form take the per-parameter path.

``Updater.get_states`` writes the reference's ``.states`` pickle in its
untagged form, ``{index: state}`` with numpy leaves (the reference's
``set_states`` rewraps every numpy leaf of an untagged blob as an
NDArray, which is exact for the built-in optimizers): the port cannot
write the tagged form, whose ``_NDTag`` class pickle resolves by the
reference's module path. ``set_states`` reads both forms: the
reference's ``mxnet_tpu.optimizer._NDTag`` unpickles as this module's
:class:`_NDTag`, and nothing but numpy arrays and that tag may be
unpickled. A bfloat16 state is written as float32 (numpy has no
bfloat16 without ``ml_dtypes``). Neither form holds update counts: a
fresh optimizer continues Adam's bias correction from
``begin_num_update``.
"""
from __future__ import annotations

import io
import pickle
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from . import ndarray as nd
from .ndarray import NDArray
from .ops import optimizer_op as ops

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "Test",
           "create", "get_updater", "Updater", "register"]


def _groups(*keys) -> Dict[tuple, List[int]]:
    """Positions grouped by their tuple of keys, in first-seen order."""
    out: Dict[tuple, List[int]] = {}
    for pos, key in enumerate(zip(*keys)):
        out.setdefault(key, []).append(pos)
    return out


def _pick(items, pos, part=None):
    return [items[i] if part is None else items[i][part] for i in pos]


def _raw(state):
    """The tensor tree of an NDArray state tree."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_raw(s) for s in state)
    return state.data


def _clip_multi(gs, c) -> None:
    """``clip(g, -c, c)`` whenever ``c`` is set, as the reference's Nadam
    and DCASGD clip (a negative ``c`` leaves every value ``c``)."""
    if c is not None:
        torch._foreach_clamp_min_(gs, -c)
        torch._foreach_clamp_max_(gs, c)


class Optimizer(object):
    """Base optimizer."""

    opt_registry: Dict[str, type] = {}

    # False: no grouped form (SGLD's noise is drawn per tensor), so
    # update_multi runs the per-parameter update instead, as it does for
    # a subclass that defines update and no _multi
    fused_supported = True

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name: str, **kwargs) -> "Optimizer":
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s (registered: %s)"
                         % (name, sorted(Optimizer.opt_registry)))

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        # a fixed rate and count for one per-parameter update (the
        # Module step's form, update_multi with lr and t)
        self._fixed_lr = None
        self._fixed_t = None

    def create_state(self, index, weight: NDArray):
        return None

    def update(self, index, weight: NDArray, grad: NDArray, state) -> None:
        """One step of one parameter, in place: the rate (the
        scheduler's at the current ``num_update``) and decay are read,
        then the parameter's count advances, and the grouped form runs
        over this one parameter."""
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            self._multi([weight.data], [_as(grad, weight)], [_raw(state)],
                        [lr], [wd], [self._index_update_count[index]])

    # ------------------------------------------------- lr and wd per index
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

    def _update_count(self, index):
        if self._fixed_t is not None:
            self._index_update_count[index] = self._fixed_t
            return
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _resolve_mult(self, mults: Dict[Any, float], index) -> float:
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index) -> float:
        if self._fixed_lr is not None:
            lr = self._fixed_lr
        elif self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        return lr * self._resolve_mult(self.lr_mult, index)

    def _get_wd(self, index) -> float:
        return self.wd * self._resolve_mult(self.wd_mult, index)

    # ------------------------------------------------------ grouped step
    def update_multi(self, indices: Sequence, weights: Sequence[NDArray],
                     grads: Sequence, states: Sequence, lr=None,
                     t=None) -> None:
        """One step for every (index, weight, grad, state), in place.

        Without ``lr``: each parameter's count is its own count + 1, and
        the scheduler is read before each parameter's count advances,
        as the per-parameter loop reads it. With ``lr`` and ``t``: every
        parameter takes rate ``lr`` (times its multiplier) and count
        ``t``, and ``num_update`` becomes ``t``."""
        n = len(indices)
        if not n:
            return
        if lr is None:
            counts = [self._index_update_count.get(i, self.begin_num_update)
                      + 1 for i in indices]
            if self.lr_scheduler is not None:
                base, num_update = [], self.num_update
                for c in counts:
                    base.append(float(self.lr_scheduler(num_update)))
                    num_update = max(num_update, c)
            else:
                base = [float(self.lr)] * n
        else:
            counts, base = [int(t)] * n, [float(lr)] * n
        grads = [g if isinstance(g, NDArray) else NDArray(g) for g in grads]
        if not self.fused_supported or \
                type(self)._multi is Optimizer._multi:
            for i, w, g, s, b, c in zip(indices, weights, grads, states,
                                        base, counts):
                self._fixed_lr, self._fixed_t = (b, c) if lr is not None \
                    else (None, None)
                try:
                    self.update(i, w, g, s)
                finally:
                    self._fixed_lr = self._fixed_t = None
            if lr is not None:
                self.num_update = int(t)
            return
        ws = [w.data for w in weights]
        gs = [g.data if g.data.dtype == w.dtype else g.data.to(w.dtype)
              for g, w in zip(grads, ws)]
        lrs = [b * self._resolve_mult(self.lr_mult, i)
               for b, i in zip(base, indices)]
        wds = [self._get_wd(i) for i in indices]
        with torch.no_grad():
            self._multi(ws, gs, [_raw(s) for s in states], lrs, wds, counts)
        if lr is None:
            for i, c in zip(indices, counts):
                self._index_update_count[i] = c
            self.num_update = max(self.num_update, max(counts))
        else:
            self.num_update = int(t)

    def _multi(self, weights: List[torch.Tensor], grads: List[torch.Tensor],
               states: List, lrs: List[float], wds: List[float],
               counts: List[int]) -> None:
        """The grouped step over tensors: ``lrs`` and ``wds`` per
        parameter, multipliers applied; ``counts`` the update counts."""
        raise NotImplementedError


register = Optimizer.register
create = Optimizer.create_optimizer


def _as(grad: NDArray, weight: NDArray) -> torch.Tensor:
    g = grad.data
    return g if g.dtype == weight.data.dtype else g.to(weight.data.dtype)


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay; ``multi_precision`` keeps an
    f32 master copy of an f16 weight and updates that."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        master = None
        if self.multi_precision and weight.dtype == np.float16:
            master = NDArray(weight.data.to(torch.float32))
        mom = None
        if self.momentum != 0.0:
            base = master if master is not None else weight
            mom = nd.zeros(base.shape, ctx=base.context, dtype=base.dtype)
        return (mom, master) if master is not None else mom

    def _multi(self, weights, grads, states, lrs, wds, counts):
        masters = [isinstance(s, tuple) for s in states]
        for (lr, wd, mp), pos in _groups(lrs, wds, masters).items():
            if mp:
                ws = _pick(states, pos, 1)
                gs = [g.to(torch.float32) for g in _pick(grads, pos)]
                moms = _pick(states, pos, 0)
            else:
                ws, gs, moms = (_pick(weights, pos), _pick(grads, pos),
                                _pick(states, pos))
            if self.momentum == 0.0:
                ops.sgd_update_multi(ws, gs, lr, wd, self.rescale_grad,
                                     self.clip_gradient)
            else:
                ops.sgd_mom_update_multi(ws, gs, moms, lr, self.momentum, wd,
                                         self.rescale_grad,
                                         self.clip_gradient)
            if mp:
                torch._foreach_copy_(_pick(weights, pos), ws)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd), pos in _groups(lrs, wds).items():
            ws, gs = _pick(weights, pos), _pick(grads, pos)
            if self.momentum == 0.0:
                ops.sgd_update_multi(ws, gs, lr, wd, self.rescale_grad,
                                     self.clip_gradient)
            else:
                ops.nag_mom_update_multi(ws, gs, _pick(states, pos), lr,
                                         self.momentum, wd,
                                         self.rescale_grad,
                                         self.clip_gradient)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics; the noise comes from the
    port's key chain (:func:`random.torch_generator`), one draw per
    tensor, so it stays on the per-parameter path."""

    fused_supported = False

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            weight.data.copy_(ops.sgld_update(
                weight.data, _as(grad, weight), lr=lr, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=self.clip_gradient))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; its state is ``(mom,
    weight_previous)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype) \
            if self.momentum != 0.0 else None
        return (mom, NDArray(weight.data.clone()))

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd), pos in _groups(lrs, wds).items():
            ws, prevs = _pick(weights, pos), _pick(states, pos, 1)
            gs = torch._foreach_mul(_pick(grads, pos), self.rescale_grad)
            _clip_multi(gs, self.clip_gradient)
            corr = torch._foreach_mul(gs, self.lamda)
            torch._foreach_mul_(corr, gs)
            torch._foreach_mul_(corr, torch._foreach_sub(ws, prevs))
            comp = torch._foreach_add(gs, ws, alpha=wd)
            torch._foreach_add_(comp, corr)
            if self.momentum == 0.0:
                step = torch._foreach_mul(comp, -lr)
            else:
                step = _pick(states, pos, 0)
                torch._foreach_mul_(step, self.momentum)
                torch._foreach_add_(step, comp, alpha=-lr)
            torch._foreach_copy_(prevs, ws)
            torch._foreach_add_(ws, step)


@register
class Adam(Optimizer):
    """Adam as the reference computes it: ``wd·w`` folded into the
    gradient, elementwise clipping, ε outside the bias correction."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def _corrected(self, lr, t):
        return lr * ((1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t))

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd, t), pos in _groups(lrs, wds, counts).items():
            ops.adam_update_multi(
                _pick(weights, pos), _pick(grads, pos),
                _pick(states, pos, 0), _pick(states, pos, 1),
                self._corrected(lr, t), self.beta1, self.beta2,
                self.epsilon, wd, self.rescale_grad, self.clip_gradient)


@register
class AdaGrad(Optimizer):
    """AdaGrad; ``eps`` keeps the square root away from 0."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd), pos in _groups(lrs, wds).items():
            ops.adagrad_update_multi(
                _pick(weights, pos), _pick(grads, pos), _pick(states, pos),
                lr, self.float_stable_eps, wd, self.rescale_grad,
                self.clip_gradient)


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Graves' variant
    (``rmspropalex_update``), with state ``(n, g, delta)``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        def z():
            return nd.zeros(weight.shape, ctx=weight.context,
                            dtype=weight.dtype)
        return (z(), z(), z()) if self.centered else z()

    def _multi(self, weights, grads, states, lrs, wds, counts):
        cw = self.clip_weights or None
        for (lr, wd), pos in _groups(lrs, wds).items():
            ws, gs = _pick(weights, pos), _pick(grads, pos)
            if self.centered:
                ops.rmspropalex_update_multi(
                    ws, gs, _pick(states, pos, 0), _pick(states, pos, 1),
                    _pick(states, pos, 2), lr, self.gamma1, self.gamma2,
                    self.epsilon, wd, self.rescale_grad, self.clip_gradient,
                    cw)
            else:
                ops.rmsprop_update_multi(
                    ws, gs, _pick(states, pos), lr, self.gamma1,
                    self.epsilon, wd, self.rescale_grad, self.clip_gradient,
                    cw)


@register
class AdaDelta(Optimizer):
    """AdaDelta; no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (wd,), pos in _groups(wds).items():
            ops.adadelta_update_multi(
                _pick(weights, pos), _pick(grads, pos),
                _pick(states, pos, 0), _pick(states, pos, 1), self.rho,
                self.epsilon, wd, self.rescale_grad, self.clip_gradient)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader, with state ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd), pos in _groups(lrs, wds).items():
            ops.ftrl_update_multi(
                _pick(weights, pos), _pick(grads, pos),
                _pick(states, pos, 0), _pick(states, pos, 1), lr,
                self.lamda1, self.beta, wd, self.rescale_grad,
                self.clip_gradient)


@register
class Adamax(Optimizer):
    """Adam's infinity-norm variant, state ``(mean, u)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd, t), pos in _groups(lrs, wds, counts).items():
            ops.adamax_update_multi(
                _pick(weights, pos), _pick(grads, pos),
                _pick(states, pos, 0), _pick(states, pos, 1),
                lr / (1.0 - self.beta1 ** t), self.beta1, self.beta2, wd,
                self.rescale_grad, self.clip_gradient)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum. The cumulative momentum schedule is
    per-parameter state, ``(mean, var, m_schedule)`` with a ``(1,)``
    float32 schedule, as the reference keeps it. The gradient takes
    ``wd·w`` before it is clipped, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.ones((1,), ctx=weight.context, dtype="float32"))

    def _momenta(self, t):
        return (self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay)),
                self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                   * self.schedule_decay)))

    def _multi(self, weights, grads, states, lrs, wds, counts):
        for (lr, wd, t), pos in _groups(lrs, wds, counts).items():
            ws = _pick(weights, pos)
            means, variances = _pick(states, pos, 0), _pick(states, pos, 1)
            scheds = _pick(states, pos, 2)
            mom_t, mom_t1 = self._momenta(t)
            gs = torch._foreach_mul(_pick(grads, pos), self.rescale_grad)
            if wd:
                torch._foreach_add_(gs, ws, alpha=wd)
            _clip_multi(gs, self.clip_gradient)
            m_schedule = torch._foreach_mul(scheds, mom_t)
            m_next = torch._foreach_mul(m_schedule, mom_t1)
            torch._foreach_mul_(means, self.beta1)
            torch._foreach_add_(means, gs, alpha=1.0 - self.beta1)
            torch._foreach_mul_(variances, self.beta2)
            torch._foreach_addcmul_(variances, gs, gs,
                                    value=1.0 - self.beta2)
            one_minus = torch._foreach_neg(m_schedule)
            torch._foreach_add_(one_minus, 1.0)
            g_prime = torch._foreach_div(gs, one_minus)
            one_minus = torch._foreach_neg(m_next)
            torch._foreach_add_(one_minus, 1.0)
            m_bar = torch._foreach_div(means, one_minus)
            torch._foreach_mul_(m_bar, mom_t1)
            torch._foreach_add_(m_bar, g_prime, alpha=1.0 - mom_t)
            denom = torch._foreach_div(variances, 1.0 - self.beta2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.epsilon)
            torch._foreach_addcdiv_(ws, m_bar, denom, value=-lr)
            torch._foreach_copy_(scheds, m_schedule)


@register
class Test(Optimizer):
    """The simplest update, for tests: ``w += rescale_grad·g``; the
    state is a copy of the new weight."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight.data.add_(_as(grad, weight) * self.rescale_grad)
            state.data.copy_(weight.data)

    def _multi(self, weights, grads, states, lrs, wds, counts):
        torch._foreach_add_(weights, torch._foreach_mul(grads,
                                                        self.rescale_grad))
        torch._foreach_copy_(states, weights)


# ccSGD was a C++ twin of SGD in the reference
Optimizer.opt_registry["ccsgd"] = SGD


# ------------------------------------------------------------- the Updater

class _NDTag(object):
    """A pickled numpy leaf that was an NDArray (the reference's tagged
    ``.states`` form); the reference's class unpickles as this one."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __getstate__(self):
        return self.value

    def __setstate__(self, value):
        self.value = value


# what a .states pickle may name: numpy's array reconstruction, the
# reference's tag, and nothing else
_NUMPY_NAMES = frozenset(("_reconstruct", "scalar", "ndarray", "dtype",
                          "_frombuffer"))


class _StatesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "mxnet_tpu.optimizer" and name == "_NDTag":
            return _NDTag
        if (module == "numpy" or module.startswith("numpy.")) \
                and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "optimizer states may hold numpy arrays only, not %s.%s"
            % (module, name))


def load_states_pickle(blob: bytes):
    """Unpickle a ``.states`` payload (either package's) without
    importing the reference."""
    return _StatesUnpickler(io.BytesIO(blob)).load()


def state_to_numpy(state):
    """An NDArray (or tensor) state tree as numpy leaves; bfloat16 as
    float32."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(state_to_numpy(s) for s in state)
    t = state.data if isinstance(state, NDArray) else state
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def state_from_numpy(state, legacy=True):
    """The inverse: numpy leaves (tagged ones always, untagged ones in a
    legacy blob) as NDArrays on the host, owning their memory; other
    leaves pass through."""
    if isinstance(state, tuple):
        return tuple(state_from_numpy(s, legacy) for s in state)
    if isinstance(state, _NDTag) or (legacy and isinstance(state,
                                                           np.ndarray)):
        raw = state.value if isinstance(state, _NDTag) else state
        return NDArray(torch.from_numpy(np.array(raw)))
    return state


def _to_device(state, device):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_to_device(s, device) for s in state)
    if isinstance(state, NDArray) and state.data.device != device:
        return NDArray(state.data.to(device))
    return state


class Updater(object):
    """Applies an optimizer to indexed weights, creating each index's
    state at its first update. A state loaded by :meth:`set_states`
    waits on the host until its weight's first update moves it to the
    weight's device."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def _state(self, index, weight: NDArray):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        else:
            self.states[index] = _to_device(self.states[index],
                                            weight.data.device)
        return self.states[index]

    def __call__(self, index, grad: NDArray, weight: NDArray) -> None:
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, indices: Sequence, weights: Sequence[NDArray],
                     grads: Sequence, lr=None, t=None) -> None:
        """One grouped step over every (index, weight, grad); ``lr`` and
        ``t`` as for :meth:`Optimizer.update_multi`."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(list(indices), list(weights),
                                    list(grads), states, lr=lr, t=t)

    def get_states(self) -> bytes:
        """The reference's ``.states`` pickle, untagged form."""
        return pickle.dumps({k: state_to_numpy(v)
                             for k, v in self.states.items()})

    def set_states(self, states: bytes) -> None:
        """Load a ``.states`` pickle of either package (tagged or
        untagged); the states stay on the host until first use."""
        payload = load_states_pickle(states)
        tagged = isinstance(payload, dict) and "__nd_tagged__" in payload
        if tagged:
            payload = payload["states"]
        self.states = {k: state_from_numpy(v, legacy=not tagged)
                       for k, v in payload.items()}


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
