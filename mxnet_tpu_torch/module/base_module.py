"""BaseModule — the training-loop owner, and its ``fit`` loop.

The port's counterpart of the reference's ``module/base_module.py``:
the abstract bind / forward / backward / update primitives and the
canonical ``fit`` loop (bind, init_params, init_optimizer; per batch one
``_fit_step`` and a metric update; per epoch the metric log, the epoch
callbacks and an optional evaluation pass).

``fit(checkpoint=...)`` saves through :mod:`..checkpoint` at epoch ends
and every N batches, and on SIGTERM saves and exits with status 143;
``fit(resume_from=dir)`` restores the newest valid checkpoint
(parameters, optimizer states and counts, the key chain, the metric
totals) and continues at the next epoch or, for a mid-epoch save, at
the next batch, skipping the batches the saved run consumed. The
reference's ``fit`` also takes gradient accumulation, a parallel layout,
autotuning and a monitor; they are later items of the port (ROADMAP.md,
queue A) and ``fit`` raises :class:`MXNetError` naming the item when
one is passed.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple
from typing import List

from ..base import MXNetError
from .. import faults as _faults
from .. import metric as _metric

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

# fit() options of the reference that later items of the port bring
_LATER = {
    "grad_accum": "queue A7 (grad_accum)",
    "layout": "queue A9 (parallelism)",
    "tune": "queue A10 (tune)",
    "monitor": "queue A2 (executor monitor)",
}


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


def _check_input_names(symbol, names, typename, throw):
    args = set(symbol.list_arguments())
    for name in names:
        if name in args:
            continue
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s" % (typename, str(names), name,
                                           "\n\t".join(sorted(args))))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule(object):
    """The base class of a module."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Set parameters from name -> array dicts (NDArray, numpy or
        tensor): the way one set of weights, e.g. the JAX package's
        ``get_params()`` as numpy, is carried into the port."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True):
        """Run inference over ``eval_data`` and evaluate."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint=None, resume_from=None,
            grad_accum=None, layout=None, tune=None):
        """Train the module: per batch one ``_fit_step`` (forward,
        backward and the fused update) and a metric update; checkpoints
        and resume as the module's docstring says."""
        assert num_epoch is not None, "please specify number of epochs"
        given = {"grad_accum": grad_accum, "layout": layout, "tune": tune,
                 "monitor": monitor}
        for name, value in given.items():
            if value is not None:
                raise MXNetError("fit(%s=...) is not ported yet: it comes "
                                 "with ROADMAP.md %s" % (name, _LATER[name]))
        from .. import random as _random
        from ..initializer import Uniform
        if initializer is None:
            # from the seeded key chain, as the reference draws it: two
            # fits after the same mt.random.seed() start from the same
            # weights, and from the reference's
            initializer = Uniform(0.01).set_rng(
                _random.derive_numpy_rng("fit_default_init"))

        ckpt_mgr = resume = None
        if checkpoint is not None or resume_from is not None:
            from .. import checkpoint as ckpt_mod
        if checkpoint is not None:
            if getattr(self, "_checkpoint_snapshot", None) is None:
                raise MXNetError(
                    "fit(checkpoint=...) needs a module with "
                    "_checkpoint_snapshot (mt.mod.Module); %s has none: use "
                    "epoch_end_callback=mt.callback.do_checkpoint(...)"
                    % type(self).__name__)
            ckpt_mgr = ckpt_mod.CheckpointManager(checkpoint)
        if resume_from is not None:
            resume = ckpt_mod.restore_latest(
                str(resume_from),
                verify=ckpt_mgr.config.verify_on_load if ckpt_mgr else True)
            if arg_params or aux_params:
                self.logger.warning("fit(resume_from=%s) overrides the "
                                    "explicit arg_params/aux_params",
                                    resume.path)
            arg_params = resume.arg_params_nd()
            aux_params = resume.aux_params_nd()
            force_init = True
            begin_epoch = resume.resume_epoch
            self.logger.info("resuming from %s (step %d, epoch %d%s)",
                             resume.path, resume.step, begin_epoch,
                             ", batch %d" % resume.batches_done
                             if resume.mid_epoch else "")

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume is not None:
            restore = getattr(self, "_checkpoint_restore", None)
            if restore is not None:
                restore(resume)
            ckpt_mod.restore_global_rng(resume)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        resume_skip_eoe = False
        if resume is not None and resume.mid_epoch:
            # skip the batches the saved run consumed (their effect is in
            # the restored state); the data plane's cursor, which would
            # seek instead, comes with ROADMAP A6
            skip_iter = iter(train_data)
            for _ in range(resume.batches_done):
                try:
                    next(skip_iter)
                except StopIteration:
                    resume_skip_eoe = True
                    break

        uninstall_sigterm = None
        if ckpt_mgr is not None and ckpt_mgr.config.save_on_sigterm:
            uninstall_sigterm = ckpt_mgr.install_sigterm()
        every_n = ckpt_mgr.config.every_n_batches if ckpt_mgr else None
        period = max(1, ckpt_mgr.config.period_epochs) if ckpt_mgr else 1
        completed = False
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.perf_counter()
                eval_metric.reset()
                nbatch = 0
                data_iter = iter(train_data)
                end_of_batch = False
                if resume is not None and resume.mid_epoch \
                        and epoch == begin_epoch:
                    if resume.metric_state is not None:
                        restore_m = getattr(eval_metric, "_ckpt_restore",
                                            None)
                        if restore_m is None or \
                                not restore_m(resume.metric_state):
                            self.logger.warning(
                                "resume: could not restore the mid-epoch "
                                "metric state; epoch %d's training metrics "
                                "cover the resumed tail only", epoch)
                    nbatch = resume.batches_done
                    end_of_batch = resume_skip_eoe
                next_data_batch = None
                if not end_of_batch:
                    try:
                        next_data_batch = next(data_iter)
                    except StopIteration:
                        # the save landed on the epoch's last batch: on to
                        # the epoch end the saved run did not reach
                        end_of_batch = True
                while not end_of_batch:
                    if _faults.ARMED:
                        _faults.fire("fit.batch", default_kind="sigterm")
                    data_batch = next_data_batch
                    self._fit_step(data_batch)
                    # the metric before prepare: prepare may switch the
                    # current bucket, whose outputs are not this batch's
                    self.update_metric(eval_metric, data_batch.label)
                    try:
                        next_data_batch = next(data_iter)
                        self.prepare(next_data_batch)
                    except StopIteration:
                        end_of_batch = True
                    if batch_end_callback is not None:
                        params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(params)
                    nbatch += 1
                    if ckpt_mgr is not None:
                        if every_n and nbatch % every_n == 0:
                            ckpt_mgr.save_module(self, epoch=epoch,
                                                 batches_done=nbatch,
                                                 metric=eval_metric)
                        if ckpt_mgr.preempt_requested:
                            ckpt_mgr.preempt_save(self, epoch=epoch,
                                                  batches_done=nbatch,
                                                  metric=eval_metric)
                            self.logger.warning(
                                "SIGTERM: checkpoint saved at epoch %d "
                                "batch %d; exiting with status 143", epoch,
                                nbatch)
                            raise SystemExit(143)
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.perf_counter() - tic)
                arg_params_, aux_params_ = self.get_params()
                if epoch_end_callback is not None:
                    for callback in _as_list(epoch_end_callback):
                        callback(epoch, self.symbol, arg_params_,
                                 aux_params_)
                if eval_data is not None:
                    res = self.score(eval_data, validation_metric)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                if ckpt_mgr is not None:
                    if (epoch + 1) % period == 0:
                        ckpt_mgr.save_module(self, epoch=epoch,
                                             metric=eval_metric)
                    if ckpt_mgr.preempt_requested:
                        ckpt_mgr.preempt_save(self, epoch=epoch,
                                              metric=eval_metric)
                        self.logger.warning(
                            "SIGTERM: checkpoint saved at the end of epoch "
                            "%d; exiting with status 143", epoch)
                        raise SystemExit(143)
                train_data.reset()
            completed = True
        finally:
            if uninstall_sigterm is not None:
                uninstall_sigterm()
            if ckpt_mgr is not None:
                # a write failure is raised on a clean run only: raising
                # while fit unwinds would hide the original error
                ckpt_mgr.close(raise_errors=completed)

    # abstract primitives
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def prepare(self, data_batch):
        """Ready the module for ``data_batch`` (``BucketingModule``
        switches to its bucket)."""

    def _fit_step(self, data_batch):
        self.forward_backward(data_batch)
        self.update()

    @property
    def data_names(self) -> List[str]:
        raise NotImplementedError()

    @property
    def output_names(self) -> List[str]:
        raise NotImplementedError()
