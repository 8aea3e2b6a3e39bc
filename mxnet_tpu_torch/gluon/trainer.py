"""Gluon ``Trainer``: an optimizer over a set of Parameters.

The port's counterpart of the reference's ``gluon/trainer.py``. The
optimizer comes by name through ``optimizer.create`` (or as an
instance), with each parameter's ``lr_mult`` / ``wd_mult`` by name (all
of them, biases too: the reference's Trainer sets the multipliers
itself). :meth:`step` rescales the gradients by ``1 / batch_size`` and
updates every parameter that asks for a gradient in one compiled
program (``_fused.FusedUpdater``, the reference's fused Trainer step,
under ``MXNET_TPU_FUSED_TRAINER``), or else in one eager
``Updater.update_multi`` (``torch._foreach_*`` per group of equal lr
and wd).

Any registered optimizer works, by name or as an instance.
:meth:`Trainer.save_states` writes the reference's ``.states`` pickle
(``Updater.get_states``: each state by parameter index, no update
counts) and :meth:`Trainer.load_states` reads either package's, so
the files cross packages both ways; a fresh Trainer continues Adam's
bias correction from ``begin_num_update``.

The store is settled at the first :meth:`step` or
:meth:`load_states`, as in the reference (``model._create_kvstore``): on
one device a name without ``dist`` (``"device"``, ``"local"``) or None
means no store; a :class:`..kvstore.KVStore` gets a key per parameter
and the optimizer (on one device it always updates on the store), and
then :meth:`step` pushes every live gradient before it pulls any
updated weight, and the states are the store's. A ``dist`` name raises
here (ROADMAP.md queue A9).
"""
from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from .._fused import FusedUpdater
from ..checkpoint.atomic import atomic_open
from ..model import _create_kvstore
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
        if isinstance(kvstore, str) and "dist" in kvstore:
            kvs.create(kvstore)     # raises, naming ROADMAP.md queue A9
        self._params = [p for p in params if p.grad_req != "null"]
        self._scale = 1.0
        self._init_optimizer(optimizer, dict(optimizer_params or {}))
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._kv_initialized = False

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
        self._fused_step = FusedUpdater(self._updaters)

    def _init_kvstore(self):
        # on one device a store is one given as an object, and it always
        # updates on the store
        kvstore, _ = _create_kvstore(
            self._kvstore_arg, 1, {p.name: p.data() for p in self._params})
        if kvstore:
            for i, param in enumerate(self._params):
                kvstore.init(i, param.data())
            kvstore.set_optimizer(self._optimizer)
        self._kvstore = kvstore
        self._kv_initialized = True

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
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        live = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if self._kvstore is not None:
            for i in live:
                self._kvstore.push(i, self._params[i].grad())
            for i in live:
                self._kvstore.pull(i, out=self._params[i].data())
            return
        items = [(i, self._params[i].data(), self._params[i].grad())
                 for i in live]
        if self._fused_step.try_step(self._updaters, items):
            return
        self._updaters.update_multi(live, [w for _i, w, _g in items],
                                    [g.data for _i, _w, g in items])

    def save_states(self, fname):
        """Save the optimizer's states (the store's, when it updates on
        the store) in the reference's ``.states`` pickle, atomically."""
        if self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname)
            return
        with atomic_open(fname, "wb") as fout:
            fout.write(self._updaters.get_states())

    def load_states(self, fname):
        """Load a ``.states`` file of either package (into the store's
        optimizer when it updates on the store); each state moves to its
        parameter's device now."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as fin:
            self._updaters.set_states(fin.read())
        for i, param in enumerate(self._params):
            if i in self._updaters.states:
                self._updaters._state(i, param.data())
