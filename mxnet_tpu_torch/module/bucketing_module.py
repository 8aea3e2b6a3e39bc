"""BucketingModule — variable-length sequences, one executor per bucket.

The port's counterpart of the reference's ``module/bucketing_module.py``
(MXNet's ``python/mxnet/module/bucketing_module.py``). ``sym_gen(key)``
gives each bucket's graph; the default bucket's module is bound first,
and every other bucket's module binds against it (``Module.bind(
shared_module=)``), so all of them hold the same parameter, gradient
and aux tensors — an update through one bucket is seen by every other —
and share one optimizer and its state (``borrow_optimizer``). A batch
names its bucket (``DataBatch.bucket_key``, e.g. from
``rnn.BucketSentenceIter``), and ``prepare`` switches to it, binding the
bucket's module the first time.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """A module per bucket key, all sharing the default bucket's
    parameters."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module._label_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if not isinstance(res, tuple):
            raise ValueError("sym_gen must return (symbol, data_names, "
                             "label_names)")
        return res

    def _module(self, bucket_key):
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    # ------------------------------------------------------------- params
    def get_params(self):
        assert self.binded and self.params_initialized
        return self._curr_module.get_params()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self.params_initialized = True

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the shared parameters, as
        :func:`model.save_checkpoint` writes them."""
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)

    # ------------------------------------------------------------- binding
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket; the others bind when a batch first
        asks for them (:meth:`switch_bucket`)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it against the
        default bucket's module (and borrowing its optimizer) the first
        time."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes, default.for_training,
                        default.inputs_need_grad, force_rebind=False,
                        shared_module=default)
            if default.optimizer_initialized:
                module.borrow_optimizer(default)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def prepare(self, data_batch):
        """Switch to the batch's bucket (none named: stay)."""
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            return
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # ------------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.prepare(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._curr_module.update()

    def _fit_step(self, data_batch):
        self.prepare(data_batch)
        self._curr_module._fit_step(data_batch)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)
