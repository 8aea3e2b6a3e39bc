"""Training callbacks: ``Speedometer``, ``do_checkpoint``,
``module_checkpoint``, ``log_train_metric`` and ``ProgressBar``.

The port's own copy of the reference's ``callback.py`` (jax-free there
too). ``do_checkpoint`` and ``module_checkpoint`` write through the
port's :func:`model.save_checkpoint` (and, asked, the optimizer's
``.states``), whose files load in both packages;
``subsystem_checkpoint`` drives a :mod:`.checkpoint` manager from an
epoch callback.
"""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "subsystem_checkpoint", "log_train_metric", "ProgressBar",
           "BatchEndParam"]


class BatchEndParam(object):
    """What a batch-end callback is given."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch callback: ``mod.save_checkpoint(prefix, epoch + 1,
    save_optimizer_states)`` every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs
    (:func:`model.save_checkpoint`)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def subsystem_checkpoint(module, manager, period=1):
    """Epoch callback saving everything ``module`` needs to resume
    through a :class:`.checkpoint.CheckpointManager` (or a
    ``CheckpointConfig``, or a directory) every ``period`` epochs, for
    loops built from callbacks rather than ``fit(checkpoint=...)``. Call
    ``callback.manager.close()`` when training ends."""
    from . import checkpoint as _ckpt
    if not isinstance(manager, _ckpt.CheckpointManager):
        manager = _ckpt.CheckpointManager(manager)
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            manager.save_module(module, epoch=iter_no)

    _callback.manager = manager
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer(object):
    """Batch-end callback logging samples per second (and the metric)
    every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (
                    time.perf_counter() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.perf_counter()
        else:
            self.init = True
            self.tic = time.perf_counter()


class ProgressBar(object):
    """Batch-end callback drawing a progress bar on stdout."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write("[%s] %s%s\r" % (prog_bar, percents, "%"))
