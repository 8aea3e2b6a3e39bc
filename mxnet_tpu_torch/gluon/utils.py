"""Gluon utilities: ``split_data``, ``split_and_load`` and
``clip_global_norm``.

The port's counterpart of the reference's ``gluon/utils.py``.
``split_and_load`` takes one device (several are ROADMAP.md queue A9)
and returns the whole batch on it as a one-element list, as the
reference does for one device.
"""
from __future__ import annotations

import math

from .. import ndarray as nd
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` into ``num_slice`` slices (the
    last one takes the rest unless ``even_split``)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (data.shape, num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (data.shape, num_slice, batch_axis, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        if batch_axis == 0:
            slices.append(data[begin:end])
        else:
            slices.append(nd.slice_axis(data, axis=batch_axis,
                                        begin=begin, end=end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """The batch on the one device of ``ctx_list``, as a one-element
    list."""
    if len(ctx_list) != 1:
        raise MXNetError(
            "split_and_load over %d devices: the port trains on one device "
            "(several devices are ROADMAP.md queue A9)" % len(ctx_list))
    dev = resolve_device(ctx_list[0])
    if not isinstance(data, nd.NDArray):
        return [nd.array(data, ctx=dev)]
    return [data.as_in_context(dev)]


def clip_global_norm(arrays, max_norm):
    """Rescale ``arrays`` in place so that the 2-norm of all of them
    together is at most ``max_norm``; returns that norm before
    clipping."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    total_norm = math.sqrt(sum(float(nd.sum(arr * arr).asscalar())
                               for arr in arrays))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm
