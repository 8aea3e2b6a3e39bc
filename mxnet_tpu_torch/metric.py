"""Evaluation metrics.

The port's counterpart of the reference's ``metric.py``: ``Accuracy``,
``TopKAccuracy``, ``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``PearsonCorrelation``, ``Loss`` (and its legacy names
``Torch`` and ``Caffe``), ``CustomMetric`` and :func:`np`, and
``CompositeEvalMetric``; :func:`create` takes a name, a callable, a list
or a metric.

Like the reference's device-resident path, a metric that decomposes
into a (sum, count) pair sums a batch's contribution on the
predictions' device, with the count known from the shapes, and the host
reads the total only in :meth:`EvalMetric.get` (the log boundary), so a
training loop that updates the metric every batch does not wait for the
device every batch. ``F1``, ``PearsonCorrelation`` and ``CustomMetric``
compute on the host, per batch, in numpy, as the reference's host path
does.

``fit``'s async loop asks :meth:`EvalMetric.device_capable` first (the
reference's ``_device_capable`` classes, and ``MXNET_TPU_DEVICE_METRICS``
on) and calls :meth:`EvalMetric.update_device`; a metric that cannot
sum on the device returns False and the loop updates it on the host
and counts ``loop_host_sync``. Each fold of a device sum into the host
totals after an :meth:`EvalMetric.update_device` counts
``loop_metric_sync``.

A checkpoint carries a metric's totals (``_ckpt_state`` /
``_ckpt_restore``, the reference's format): a composite restores all of
its children or none.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as numpy_mod
import torch

from . import profiler as _profiler
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "PearsonCorrelation", "Loss", "Torch", "Caffe", "CustomMetric",
           "np", "create", "register"]

_METRIC_REGISTRY: Dict[str, type] = {}

_ALIASES = {"acc": "accuracy", "ce": "crossentropy",
            "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy"}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric from a name (or alias: ``acc``, ``ce``, ``top_k_acc``), a
    callable ``feval(label, pred)`` (a :class:`CustomMetric`), a list of
    either (a :class:`CompositeEvalMetric`) or an EvalMetric."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = str(metric).lower()
    name = _ALIASES.get(name, name)
    if name not in _METRIC_REGISTRY:
        raise ValueError("Metric must be either callable or in %s; got %s"
                         % (sorted(_METRIC_REGISTRY), metric))
    return _METRIC_REGISTRY[name](*args, **kwargs)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(numpy_mod.asarray(x))


def _as_np(x) -> numpy_mod.ndarray:
    t = _as_tensor(x).detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = tuple(labels.shape), tuple(preds.shape)
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (label_shape, pred_shape))


class EvalMetric(object):
    """Base metric: a running (sum, count). Subclasses that sum on the
    device implement :meth:`_reduce`; the others override
    :meth:`update`."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update_dict(self, label: Dict, pred: Dict):
        pred = [pred[n] for n in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[n] for n in self.label_names] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred).detach()
            label = _as_tensor(label).detach().to(pred.device)
            s, n = self._reduce(label, pred)
            self._sum = s if self._sum is None else self._sum + s
            self.num_inst += int(n)

    def _reduce(self, label: torch.Tensor, pred: torch.Tensor):
        """``(sum tensor, count)`` of one batch."""
        raise NotImplementedError

    # -------------------------------------------------- device-resident path
    _device_capable = False

    def device_capable(self) -> bool:
        """True when this metric sums on the device (and
        ``MXNET_TPU_DEVICE_METRICS`` is on): asked by the fit loop before
        it updates, so a composite falls back as one unit."""
        if not self._device_capable:
            return False
        from . import config as _config
        return bool(_config.get("MXNET_TPU_DEVICE_METRICS"))

    def update_device(self, labels, preds) -> bool:
        """Sum this batch on the device, with no host read. False (and
        nothing touched) when the metric cannot: the caller then runs
        :meth:`update`."""
        if not self.device_capable():
            return False
        if labels is not None and not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        self.update(labels, preds)
        self._device_path = True
        return True

    def update_dict_device(self, label: Dict, pred: Dict) -> bool:
        """``update_dict``'s twin for the device path."""
        if not self.device_capable():
            return False
        pred = [pred[n] for n in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[n] for n in self.label_names] \
            if self.label_names is not None else list(label.values())
        return self.update_device(label, pred)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._sum = None
        self._device_path = False

    def _sync(self):
        """Fold the device sum into the host total: the one host read."""
        if self._sum is not None:
            if self._device_path:
                _profiler.incr_counter("loop_metric_sync")
            self.sum_metric += float(self._sum)
            self._sum = None
        self._device_path = False

    def get(self):
        self._sync()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    # ---------------------------------------------------- checkpoint state
    def _ckpt_state(self):
        """The totals as a JSON-able dict, for a mid-epoch checkpoint."""
        self._sync()
        return {"kind": "scalar", "name": self.name,
                "sum_metric": float(self.sum_metric),
                "num_inst": int(self.num_inst)}

    def _ckpt_restore(self, state) -> bool:
        """Inverse of :meth:`_ckpt_state`; False, leaving the metric as
        it was, on a state it cannot take."""
        if not isinstance(state, dict) or state.get("kind") != "scalar":
            return False
        self.reset()
        self.sum_metric = float(state["sum_metric"])
        self.num_inst = int(state["num_inst"])
        return True

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` returns their names and
    values as two lists."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in metrics] if metrics else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def device_capable(self) -> bool:
        """Only when every child is: a mixed set falls back to the host
        path as one unit, so no child sees a batch twice."""
        return bool(self.metrics) and \
            all(m.device_capable() for m in self.metrics)

    def update_device(self, labels, preds) -> bool:
        if not self.device_capable():
            return False
        for metric in self.metrics:
            if not metric.update_device(labels, preds):
                _profiler.incr_counter("loop_host_sync")
                metric.update(labels, preds)
        return True

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)

    def _ckpt_state(self):
        return {"kind": "composite",
                "children": [m._ckpt_state() for m in self.metrics]}

    def _ckpt_restore(self, state) -> bool:
        """All children or none: on any child's failure every child is
        reset, so no child holds the snapshot's totals while another
        holds only the resumed tail's."""
        if not isinstance(state, dict) or state.get("kind") != "composite":
            return False
        children = state.get("children") or []
        if len(children) != len(self.metrics):
            return False
        if all([m._ckpt_restore(s) for m, s in zip(self.metrics, children)]):
            return True
        for m in self.metrics:
            m.reset()
        return False


@register
class Accuracy(EvalMetric):
    """Share of argmax predictions equal to the label; ``axis`` is the
    class axis of the predictions."""

    _device_capable = True

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def _reduce(self, label, pred):
        if pred.dim() > label.dim():
            pred = pred.argmax(dim=self.axis)
        pred = pred.to(torch.int32).flatten()
        label = label.to(torch.int32).flatten()
        check_label_shapes(label, pred, shape=1)
        return (pred == label).sum().to(torch.float64), label.numel()


@register
class TopKAccuracy(EvalMetric):
    """Share of labels among the ``top_k`` highest scores (a stable sort,
    so tied scores rank as the reference's do)."""

    _device_capable = True

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def _reduce(self, label, pred):
        assert pred.dim() == 2, "Predictions should be 2 dims"
        order = torch.argsort(pred.to(torch.float32), dim=1, stable=True)
        num_samples, num_classes = order.shape
        top_k = min(num_classes, self.top_k)
        label = label.to(torch.int64).reshape(-1, 1)
        hits = (order[:, num_classes - top_k:] == label).sum()
        return hits.to(torch.float64), num_samples


@register
class F1(EvalMetric):
    """Binary F1 of the argmax predictions, averaged over batches (on
    the host, per batch)."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype(numpy_mod.int32)
            pred_label = numpy_mod.argmax(pred, axis=1)
            check_label_shapes(label.flatten(), pred_label.flatten(),
                               shape=1)
            if len(numpy_mod.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            flat = label.flatten()
            tp = numpy_mod.sum((pred_label == 1) & (flat == 1))
            fp = numpy_mod.sum((pred_label == 1) & (flat == 0))
            fn = numpy_mod.sum((pred_label == 0) & (flat == 1))
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                f1 = 2 * precision * recall / (precision + recall)
            else:
                f1 = 0.0
            self.sum_metric += f1
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    """exp of the mean of -log(max(p[label], 1e-10)) over every label
    other than ``ignore_label``; the predictions' last axis is the
    class axis. The count of labels taken is summed on the device too,
    so :meth:`get` is the one host read."""

    _device_capable = True

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def reset(self):
        super().reset()
        self._num = None

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred).detach()
            label = _as_tensor(label).detach().to(pred.device)
            if label.numel() * pred.shape[-1] != pred.numel():
                raise ValueError("shape mismatch: %s vs. %s"
                                 % (tuple(label.shape), tuple(pred.shape)))
            label = label.reshape(-1).to(torch.int64)
            # a negative label indexes from the end, as numpy's would
            probs = pred.reshape(-1, pred.shape[-1]).gather(
                1, label.remainder(pred.shape[-1])[:, None])[:, 0].to(
                    torch.float64)
            num = torch.full((), label.numel(), dtype=torch.float64,
                             device=pred.device)
            if self.ignore_label is not None:
                ignore = label == int(self.ignore_label)
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                num = num - ignore.sum()
            loss = -torch.log(torch.clamp(probs, min=1e-10)).sum()
            self._sum = loss if self._sum is None else self._sum + loss
            self._num = num if self._num is None else self._num + num

    def _sync(self):
        if self._sum is not None:
            if self._device_path:
                _profiler.incr_counter("loop_metric_sync")
            both = torch.stack([self._sum, self._num]).cpu()   # one read
            self.sum_metric += float(both[0])
            self.num_inst += int(both[1])
            self._sum = self._num = None
        self._device_path = False

    def get(self):
        self._sync()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _column(label, pred):
    """A 1-D label as a column, as the reference reshapes it (against a
    1-D prediction the difference then broadcasts, as it does there)."""
    return label.reshape(label.shape[0], 1) if label.dim() == 1 else label


@register
class MAE(EvalMetric):
    """Mean absolute error, averaged over batches."""

    _device_capable = True

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _reduce(self, label, pred):
        label = _column(label, pred)
        return torch.abs(label - pred).mean().to(torch.float64), 1


@register
class MSE(EvalMetric):
    """Mean squared error, averaged over batches."""

    _device_capable = True

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _reduce(self, label, pred):
        label = _column(label, pred)
        return ((label - pred) ** 2.0).mean().to(torch.float64), 1


@register
class RMSE(EvalMetric):
    """Root of each batch's mean squared error, averaged over batches."""

    _device_capable = True

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _reduce(self, label, pred):
        label = _column(label, pred)
        return torch.sqrt(((label - pred) ** 2.0).mean()).to(
            torch.float64), 1


@register
class CrossEntropy(EvalMetric):
    """Mean of -log(p[label] + eps) over the rows of the predictions."""

    _device_capable = True

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def _reduce(self, label, pred):
        label = label.flatten().to(torch.int64)
        if label.shape[0] != pred.shape[0]:
            raise ValueError("%d labels for %d prediction rows"
                             % (label.shape[0], pred.shape[0]))
        prob = pred.gather(1, label[:, None])[:, 0].to(torch.float64)
        return (-torch.log(prob + self.eps)).sum(), label.shape[0]


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r of predictions and labels, averaged over batches (on
    the host, per batch)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_np(label), _as_np(pred)
            check_label_shapes(label, pred, 1)
            self.sum_metric += numpy_mod.corrcoef(pred.ravel(),
                                                  label.ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of the outputs, for loss heads; labels are ignored."""

    _device_capable = True

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            pred = _as_tensor(pred).detach()
            s = pred.sum().to(torch.float64)
            self._sum = s if self._sum is None else self._sum + s
            self.num_inst += pred.numel()


@register
class Torch(Loss):
    """``Loss`` under its legacy name."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Torch):
    """``Loss`` under its legacy name."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, per batch: a value, or a
    ``(sum, count)`` pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` from a function of numpy arrays."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
