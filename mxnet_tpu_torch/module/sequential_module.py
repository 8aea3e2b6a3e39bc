"""SequentialModule — modules chained head to tail.

The port's copy of the reference's ``module/sequential_module.py``: a
container whose i-th module consumes the (i-1)-th module's outputs (and,
in training, passes its input gradients back as the previous module's
head gradients); the ``take_labels`` meta says which modules read the
labels, ``auto_wiring`` renames the incoming data to a module's data
names.
"""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A chain of modules trained and run as one."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = set([getattr(SequentialModule, x)
                               for x in dir(SequentialModule)
                               if x.startswith("META_")])

    def add(self, module, **kwargs):
        """Add a module to the chain. Returns self for chaining."""
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, "Unknown meta %s" % key
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if len(self._modules) > 0:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if len(self._modules) > 0:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return (arg_params, aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init,
                               allow_extra=allow_extra)

        def _check_name(known_names, new_names, modules, i):
            for name in new_names:
                assert name not in known_names, \
                    "Duplicated parameter names: " + \
                    "name '%s' in layer %d (%s) is already used in layer " \
                    "%d (%s)" % (name, i, type(modules[i]),
                                 known_names[name],
                                 type(modules[known_names[name]]))
                known_names[name] = i

        arg_names, aux_names = dict(), dict()
        for i_layer, module in enumerate(self._modules):
            arg_params_m, aux_params_m = module.get_params()
            _check_name(arg_names, arg_params_m.keys(), self._modules, i_layer)
            _check_name(aux_names, aux_params_m.keys(), self._modules, i_layer)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert len(self._modules) > 0
        assert shared_module is None, \
            "Shared module is not supported for SequentialModule"

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, module in enumerate(self._modules):
            meta = self._metas[i_layer]
            if SequentialModule.META_TAKE_LABELS in meta and \
                    meta[SequentialModule.META_TAKE_LABELS]:
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None

            my_inputs_need_grad = bool(inputs_need_grad or
                                       (for_training and i_layer > 0))

            if meta.get(SequentialModule.META_AUTO_WIRING, False):
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [
                    (new_name,
                     d.shape if isinstance(d, DataDesc) else d[1])
                    for new_name, d in zip(data_names, my_data_shapes)]

            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = [
                DataDesc(name, shape) for name, shape in
                zip(module.output_names,
                    [s for _, s in module.output_shapes])]

        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for i_layer, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            out = module.get_outputs()
            label = batch.label if hasattr(batch, "label") else None
            batch = DataBatch(data=out, label=label,
                              pad=getattr(data_batch, "pad", 0))
            batch.provide_data = [
                DataDesc(name, arr.shape) for name, arr in
                zip(module.output_names, out)]

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i_layer, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if SequentialModule.META_TAKE_LABELS in meta and \
                    meta[SequentialModule.META_TAKE_LABELS]:
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
