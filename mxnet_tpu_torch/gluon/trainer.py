"""Gluon ``Trainer``: an optimizer over a set of Parameters.

The port's counterpart of the reference's ``gluon/trainer.py``. The
optimizer comes by name through ``optimizer.create`` (or as an
instance), with each parameter's ``lr_mult`` / ``wd_mult`` by name (all
of them, biases too: the reference's Trainer sets the multipliers
itself). :meth:`step` rescales the gradients by ``1 / batch_size`` and
updates every parameter that asks for a gradient in one
``Updater.update_multi`` (``torch._foreach_*`` per group of equal lr and
wd): the port's form of the reference's fused Trainer step.

Any registered optimizer works, by name or as an instance.
:meth:`Trainer.save_states` writes the reference's ``.states`` pickle
(``Updater.get_states``: each state by parameter index, no update
counts) and :meth:`Trainer.load_states` reads either package's, so
the files cross packages both ways; a fresh Trainer continues Adam's
bias correction from ``begin_num_update``.

One device: ``kvstore="device"`` or ``"local"`` (or None) means no
kvstore, as it does for one device in the reference; a distributed
kvstore raises (ROADMAP.md queue A9).
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from ..checkpoint.atomic import atomic_open
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer(object):
    """Applies ``optimizer`` to ``params`` (a ParameterDict, a dict or a
    list of Parameters)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % type(params))
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % type(param))
        if kvstore not in ("device", "local", None):
            raise MXNetError(
                "kvstore %r: the port trains on one device without a "
                "kvstore (distributed kvstores are ROADMAP.md queue A9)"
                % (kvstore,))
        self._params = [p for p in params if p.grad_req != "null"]
        self._scale = 1.0
        self._init_optimizer(optimizer, dict(optimizer_params or {}))

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._optimizer.idx2name = {i: p.name
                                    for i, p in enumerate(self._params)}
        self._optimizer.lr_mult = {p.name: p.lr_mult for p in self._params}
        self._optimizer.wd_mult = {p.name: p.wd_mult for p in self._params}
        self._updaters = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step over every parameter that asks for a
        gradient, its gradient rescaled by ``1 / batch_size``.
        ``ignore_stale_grad`` is accepted as in the reference, which does
        not track staleness either."""
        self._optimizer.rescale_grad = self._scale / batch_size
        live = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        self._updaters.update_multi(
            live, [self._params[i].data() for i in live],
            [self._params[i].grad().data for i in live])

    def save_states(self, fname):
        """Save the optimizer's states in the reference's ``.states``
        pickle, atomically."""
        with atomic_open(fname, "wb") as fout:
            fout.write(self._updaters.get_states())

    def load_states(self, fname):
        """Load a ``.states`` file of either package; each state moves to
        its parameter's device now."""
        with open(fname, "rb") as fin:
            self._updaters.set_states(fin.read())
        for i, param in enumerate(self._params):
            if i in self._updaters.states:
                self._updaters._state(i, param.data())
