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
the next batch: a loader with a cursor (``data.DataLoader``'s
``_mx_fast_forward``) seeks there without decoding a skipped batch, and
the manifest carries its cursor (``_mx_cursor``); any other iterator
skips the batches the saved run consumed.

The loop is the reference's async one. ``MXNET_TPU_ASYNC_WINDOW`` (2)
steps stay queued on the card ahead of the host (an
:class:`.._fused.InflightWindow` of CUDA events); the module's device
placer copies each batch to the card ahead of its step
(``MXNET_TPU_DEVICE_PREFETCH`` deep), in a ``PrefetchingIter`` that
``fit`` wraps around the iterator (and closes at the end) or, for a
loader with ``_mx_set_device_placer``, in the loader itself; a
device-capable metric sums on the card and the host reads it once an
epoch. Counters: ``loop_host_sync`` (a batch whose metric needed the
host), ``loop_metric_sync`` (folds of a device sum),
``loop_prefetch_stall`` / ``loop_prefetch_placed`` /
``loop_prefetch_depth`` (the prefetch stage), ``loop_nonfinite``
(``MXNET_TPU_NANCHECK``). Window 0, a monitor or a module without the
hooks runs the synchronous loop.

Observability (:mod:`..obs`): the training thread's trace lane is
``train``; each batch carries a flow id (from the prefetch stage, or
made here while spans record) through the ``prefetch_next`` /
``device_place`` / ``fused_step_dispatch`` / ``metric_update`` spans, and
the epoch's one metric read is the ``metric_sync`` span on the
``metric`` lane. The step span times the dispatch of the step, not its
device work. With the flight recorder armed (``MXNET_TPU_OBS_BLACKBOX``)
the loop notes each epoch end, a preemption (flushed before the exit
with status 143) and a ``MXNET_TPU_NANCHECK`` abort.
``fit(monitor=)`` installs a :class:`..monitor.Monitor` and, as the
reference does, runs ``forward_backward`` and ``update`` per batch
(``tic`` before, ``toc_print`` after) instead of the fused step, and so
refuses ``grad_accum`` above 1. ``fit(grad_accum=n)`` routes to the
module's ``set_grad_accum`` before it binds.

``fit(tune="auto"|"static")`` (or ``MXNET_TPU_TUNE``) searches, or
loads from the store, the tuned configuration of this program
(:mod:`..tune`, imported only then) under the
``MXNET_TPU_ANALYZE_HBM_BUDGET`` budget and applies the winner before
the bind: its knobs as config overrides scoped to this ``fit``, its
``grad_accum`` unless the caller passed one; it counts
``tune_applied``. The reference's ``fit`` also takes a parallel layout,
a later item of the port (ROADMAP.md, queue A9): ``fit`` raises
:class:`MXNetError` naming the item when one is passed.

Inference: ``predict`` / ``iter_predict`` run ``forward(is_train=False)``
per batch and drop the last batch's padding; ``save_params`` /
``load_params`` write and read ``arg:`` / ``aux:`` entries with
``nd.save`` / ``nd.load``, a file either package reads.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple
from typing import List

from ..base import MXNetError
from ..context import device_scope
from .. import _fused
from .. import config as _config
from .. import faults as _faults
from .. import metric as _metric
from .. import ndarray as nd
from .. import profiler as _profiler

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

# fit() options of the reference that later items of the port bring
_LATER = {
    "layout": "queue A9 (parallelism)",
}

_TUNE_OFF = (None, False, 0, "", "off", "0", "no", "false", "none")


def _blackbox_preempt(**where) -> None:
    """The flight recorder's preemption note and flush, made on the
    training thread when the SIGTERM flag is observed — never in the
    signal handler."""
    bb = _profiler.blackbox()
    if bb is not None:
        bb.record("preempt", "sigterm", **where)
        bb.flush("sigterm")


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
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def save_params(self, fname: str):
        """Write the parameters as ``arg:<name>`` / ``aux:<name>``
        entries of one ``nd.save`` file."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname: str):
        """Set the parameters from a :meth:`save_params` file (of either
        package)."""
        with device_scope("cpu"):
            save_dict = nd.load(fname)
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

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

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` per batch of inference, the
        batch's padding dropped from each output."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Run inference over ``eval_data`` and collect the outputs (the
        last batch's padding dropped): merged along the batch axis into
        one array per output (just the array for one output, unless
        ``always_output_list``), or per batch without
        ``merge_batches``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise ValueError("Cannot merge batches: different numbers "
                                     "of outputs per batch")
            output_list2 = [nd.concatenate([out[i] for out in output_list])
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

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
        given = {"layout": layout}
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

        # fit(tune=...): search (or load) the tuned configuration of this
        # program and apply it before anything binds; explicit user
        # arguments win
        tune_mode = tune if tune is not None \
            else _config.get("MXNET_TPU_TUNE")
        if tune_mode in (True, 1, "on", "1", "yes", "true"):
            tune_mode = "auto"
        tune_knob_snapshot = None
        if tune_mode not in _TUNE_OFF:
            from .. import tune as _tune   # only when armed
            budget = _config.get("MXNET_TPU_ANALYZE_HBM_BUDGET") or None
            tuned = _tune.tune_fit(self, train_data, optimizer,
                                   optimizer_params, mode=str(tune_mode),
                                   budget=budget)
            cand = tuned.candidate
            # fit-scoped: restored in the finally below, so a later fit
            # with the tuner off never trains under this winner's knobs
            tune_knob_snapshot = _config.snapshot_overrides(cand.knobs())
            for knob, val in cand.knobs().items():
                _config.set(knob, val)
            if grad_accum is None and cand.grad_accum > 1:
                grad_accum = cand.grad_accum
            _profiler.incr_counter("tune_applied")
            self.logger.info("fit(tune=%s): applying %s config %s",
                             tune_mode, tuned.source, cand.to_dict())

        if grad_accum is not None:
            setter = getattr(self, "set_grad_accum", None)
            if setter is not None:
                # before init_optimizer, which settles the split
                setter(grad_accum)
            elif int(grad_accum) > 1:
                raise MXNetError(
                    "fit(grad_accum=%s): %s does not support microbatch "
                    "gradient accumulation" % (grad_accum,
                                               type(self).__name__))
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            check = getattr(self, "_check_accum_needs_fused", None)
            if check is not None:
                check()
            self.install_monitor(monitor)
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

        # ------------------------------------------------ async loop setup
        window = int(_config.get("MXNET_TPU_ASYNC_WINDOW"))
        async_ok = getattr(self, "_async_capable", lambda: False)
        if monitor is not None or not async_ok():
            window = 0
        update_device = getattr(self, "_update_metric_device", None)
        inflight = _fused.InflightWindow(window)
        step_token = getattr(self, "_step_token", lambda: None)

        def _loader_hook(it, name):
            # a data-plane hook on the iterator, looking through one
            # PrefetchingIter the user applied
            fn = getattr(it, name, None)
            if fn is None:
                inner = getattr(it, "iters", None)
                if inner:
                    fn = getattr(inner[0], name, None)
            return fn

        resume_skip_eoe = False
        if resume is not None:
            ff = _loader_hook(train_data, "_mx_fast_forward")
            if ff is not None:
                # a loader with a cursor seeks to the saved position (no
                # decode of a skipped batch) after checking the cursor's
                # stream identity; at an epoch boundary it syncs the
                # shuffle epoch
                ff(begin_epoch, resume.batches_done if resume.mid_epoch
                   else 0, cursor=resume.data_cursor)
            elif resume.mid_epoch:
                # skip the batches the saved run consumed (their effect
                # is in the restored state) before a prefetcher starts
                skip_iter = iter(train_data)
                for _ in range(resume.batches_done):
                    try:
                        next(skip_iter)
                    except StopIteration:
                        resume_skip_eoe = True
                        break

        wrapped = placer_sink = None
        inner_train_data = train_data
        if window > 0:
            depth = int(_config.get("MXNET_TPU_DEVICE_PREFETCH"))
            placer = getattr(self, "_device_placer", lambda: None)()
            if depth > 0 and placer is not None \
                    and getattr(train_data, "provide_data", None):
                sink = getattr(train_data, "_mx_set_device_placer", None)
                if sink is not None:
                    # the loader is the prefetch stage: it places each
                    # batch it delivers
                    sink(placer)
                    placer_sink = train_data
                else:
                    from ..io.io import PrefetchingIter
                    if not isinstance(train_data, PrefetchingIter):
                        train_data = wrapped = PrefetchingIter(
                            train_data, device_placer=placer,
                            device_prefetch=depth)
                    # a PrefetchingIter the user made is used as it is
                    # (no second wrap); its batches are copied in
                    # _load_batch
        # the manifest's cursor, from fit's CONSUMED count (the loader's
        # own runs the prefetch depth ahead)
        cursor_fn = _loader_hook(inner_train_data, "_mx_cursor")
        # the training thread's trace lane: step and checkpoint-snapshot
        # spans land here; metric updates and syncs on their own track
        _profiler.register_thread_lane("train")

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
                    # the batch's flow id threads its trace slices across
                    # lanes (prefetch -> place -> step -> metric); batches
                    # the prefetch stage produced already carry one
                    fid = getattr(data_batch, "_mx_flow", None)
                    if fid is None and _profiler.spans_enabled():
                        fid = _profiler.new_flow()
                    with _profiler.span("fused_step_dispatch", "step",
                                        flow=fid):
                        if monitor is not None:
                            # per-op values: the unfused step, as the
                            # reference's monitored loop runs it
                            monitor.tic()
                            self.forward_backward(data_batch)
                            self.update()
                        else:
                            self._fit_step(data_batch)
                    if window > 0:
                        inflight.push(step_token())
                    # the metric before prepare: prepare may switch the
                    # current bucket, whose outputs are not this batch's
                    with _profiler.span("metric_update", "metric",
                                        flow=fid, lane="metric"):
                        if not (window > 0 and update_device is not None
                                and update_device(eval_metric,
                                                  data_batch.label)):
                            if window > 0:
                                # the async loop had to read this
                                # batch's metric on the host
                                _profiler.incr_counter("loop_host_sync")
                            self.update_metric(eval_metric,
                                               data_batch.label)
                    try:
                        next_data_batch = next(data_iter)
                        self.prepare(next_data_batch)
                    except StopIteration:
                        end_of_batch = True
                    if monitor is not None:
                        monitor.toc_print()
                    if batch_end_callback is not None:
                        params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals())
                        for callback in _as_list(batch_end_callback):
                            callback(params)
                    nbatch += 1
                    if ckpt_mgr is not None:
                        cursor = cursor_fn(epoch=epoch, batches_done=nbatch) \
                            if cursor_fn else None   # fit's consumed count
                        if every_n and nbatch % every_n == 0:
                            # a step boundary: wait out the window first
                            inflight.drain()
                            ckpt_mgr.save_module(self, epoch=epoch,
                                                 batches_done=nbatch,
                                                 metric=eval_metric,
                                                 loader_state=cursor)
                        if ckpt_mgr.preempt_requested:
                            inflight.drain()
                            ckpt_mgr.preempt_save(self, epoch=epoch,
                                                  batches_done=nbatch,
                                                  metric=eval_metric,
                                                  loader_state=cursor)
                            self.logger.warning(
                                "SIGTERM: checkpoint saved at epoch %d "
                                "batch %d; exiting with status 143", epoch,
                                nbatch)
                            _blackbox_preempt(epoch=epoch, batch=nbatch)
                            raise SystemExit(143)
                # the epoch barrier: the time and what follows see every
                # step done; then the one host read of the metric
                inflight.drain()
                with _profiler.span("metric_sync", "metric", lane="metric"):
                    name_values = eval_metric.get_name_value()
                bb = _profiler.blackbox()
                if bb is not None:
                    bb.record("epoch", "end", epoch=epoch, batches=nbatch,
                              metrics={n: round(float(v), 6)
                                       for n, v in name_values})
                for name, val in name_values:
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.perf_counter() - tic)
                if getattr(self, "_nancheck_mode", "off") != "off":
                    bad = self._nancheck_poll()
                    if bad is not None:
                        _profiler.incr_counter("loop_nonfinite")
                        msg = ("non-finite values in output %r during "
                               "epoch %d (MXNET_TPU_NANCHECK=%s)"
                               % (bad, epoch, self._nancheck_mode))
                        if self._nancheck_mode == "abort":
                            bb = _profiler.blackbox()
                            if bb is not None:
                                # a terminal moment: the window carries
                                # the diverged output's name
                                bb.record("nancheck", "abort",
                                          output=str(bad), epoch=epoch)
                                bb.flush("nancheck")
                            raise MXNetError(msg)
                        self.logger.warning(msg)
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
                    # the next epoch at batch 0, where a resume from this
                    # checkpoint starts
                    cursor = cursor_fn(epoch=epoch + 1, batches_done=0) \
                        if cursor_fn else None
                    if (epoch + 1) % period == 0:
                        ckpt_mgr.save_module(self, epoch=epoch,
                                             metric=eval_metric,
                                             loader_state=cursor)
                    if ckpt_mgr.preempt_requested:
                        ckpt_mgr.preempt_save(self, epoch=epoch,
                                              metric=eval_metric,
                                              loader_state=cursor)
                        self.logger.warning(
                            "SIGTERM: checkpoint saved at the end of epoch "
                            "%d; exiting with status 143", epoch)
                        _blackbox_preempt(epoch=epoch)
                        raise SystemExit(143)
                # a prefetcher is not reset after the last epoch: its
                # worker would place batches of an epoch that never runs;
                # close() below stops it and the inner iterator is reset
                if wrapped is None or epoch < num_epoch - 1:
                    train_data.reset()
            completed = True
        finally:
            if uninstall_sigterm is not None:
                uninstall_sigterm()
            if tune_knob_snapshot is not None:
                _config.restore_overrides(tune_knob_snapshot)
            if placer_sink is not None:
                placer_sink._mx_set_device_placer(None)
            if wrapped is not None:
                joined = wrapped.close()
                # leave the iterator as the synchronous loop would:
                # reset, unless a worker is still inside it or fit is
                # unwinding an error
                if joined and completed:
                    inner_train_data.reset()
                elif not joined:
                    self.logger.warning(
                        "prefetch worker did not exit within the close() "
                        "deadline; skipping the final reset of the "
                        "training iterator")
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

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def install_monitor(self, mon):
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
