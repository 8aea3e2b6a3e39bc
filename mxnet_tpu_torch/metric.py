"""Evaluation metrics: ``EvalMetric``, ``create``, ``Accuracy``,
``CrossEntropy`` and ``Perplexity``.

The port's counterpart of the reference's ``metric.py`` for the metrics
``fit`` uses by default. Like the reference's device-resident path, a
batch's contribution is summed on the predictions' device and the host
reads the total only in :meth:`EvalMetric.get` (the log boundary), so a
training loop that updates the metric every batch does not wait for the
device every batch.
"""
from __future__ import annotations

from typing import Dict

import math

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "CrossEntropy", "Perplexity", "create",
           "register"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric from its name (``acc``, ``ce``, ``accuracy``,
    ``crossentropy``) or an EvalMetric."""
    if isinstance(metric, EvalMetric):
        return metric
    name = str(metric).lower()
    name = {"acc": "accuracy", "ce": "crossentropy"}.get(name, name)
    if name not in _METRIC_REGISTRY:
        raise ValueError("Metric must be in %s (this slice of the port); "
                         "got %s" % (sorted(_METRIC_REGISTRY), metric))
    return _METRIC_REGISTRY[name](*args, **kwargs)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x))


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError("Shape of labels %d does not match shape of "
                         "predictions %d" % (len(labels), len(preds)))


class EvalMetric(object):
    """Base metric: a running (sum, count)."""

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

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._sum = None

    def get(self):
        if self._sum is not None:
            self.sum_metric += float(self._sum)     # the one host sync
            self._sum = None
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        return [(name, value)]

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


@register
class Accuracy(EvalMetric):
    """Share of argmax predictions equal to the label; ``axis`` is the
    class axis of the predictions."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def _reduce(self, label, pred):
        if pred.dim() > label.dim():
            pred = pred.argmax(dim=self.axis)
        pred = pred.to(torch.int32).flatten()
        label = label.to(torch.int32).flatten()
        if pred.shape != label.shape:
            raise ValueError("Shape of labels %s does not match shape of "
                             "predictions %s" % (tuple(label.shape),
                                                 tuple(pred.shape)))
        return (pred == label).sum().to(torch.float64), label.numel()


@register
class CrossEntropy(EvalMetric):
    """Mean of -log(p[label] + eps) over the rows of the predictions."""

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
class Perplexity(EvalMetric):
    """exp of the mean of -log(max(p[label], 1e-10)) over every label
    other than ``ignore_label``; the predictions' last axis is the
    class axis. The count of labels taken is summed on the device too,
    so :meth:`get` is the one host read."""

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

    def get(self):
        if self._sum is not None:
            both = torch.stack([self._sum, self._num]).cpu()   # one read
            self.sum_metric += float(both[0])
            self.num_inst += int(both[1])
            self._sum = self._num = None
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))
