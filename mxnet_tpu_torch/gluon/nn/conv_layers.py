"""Gluon convolution and pooling layers: the port's copy of the
reference's ``gluon/nn/conv_layers.py`` — Conv1D/2D/3D, their
``Conv*DTranspose`` (the ``Deconvolution`` op), and the max, average and
global pools over the ``Pooling`` op (``ceil_mode`` is its ``full``
convention).
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tup(val, n):
    if isinstance(val, (int, np.integer)):
        return (int(val),) * n
    return tuple(int(v) for v in val)


class _Conv(HybridBlock):
    """Shared conv implementation (reference: conv_layers.py _Conv:33)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + \
                    tuple(kernel_size)
            else:  # Deconvolution: (in, out, *k)
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=init_mod.Zero(),
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def shape_update(self, x, *args):
        in_ch = x.shape[1]
        g = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        if self._op_name == "Convolution":
            self.weight.shape = (self._channels, in_ch // g) + k
        else:
            self.weight.shape = (in_ch, self._channels // g) + k
        if self.bias is not None:
            self.bias.shape = (self._channels,)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return "%s(%s, kernel_size=%s, stride=%s)" % (
            self.__class__.__name__, self._channels,
            self._kwargs["kernel"], self._kwargs["stride"])


class Conv1D(_Conv):
    """(reference: conv_layers.py:156)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """(reference: conv_layers.py:218)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    """(reference: conv_layers.py:282)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """(reference: conv_layers.py:394)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    """(reference: conv_layers.py:450)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    """(reference: conv_layers.py:510)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """Shared pooling implementation (reference: conv_layers.py _Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s)" % (
            self.__class__.__name__, self._kwargs["kernel"],
            self._kwargs["stride"])


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 1),
                         _tup(strides, 1) if strides is not None else None,
                         _tup(padding, 1), ceil_mode, False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2),
                         _tup(strides, 2) if strides is not None else None,
                         _tup(padding, 2), ceil_mode, False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 3),
                         _tup(strides, 3) if strides is not None else None,
                         _tup(padding, 3), ceil_mode, False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 1),
                         _tup(strides, 1) if strides is not None else None,
                         _tup(padding, 1), ceil_mode, False, "avg", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2),
                         _tup(strides, 2) if strides is not None else None,
                         _tup(padding, 2), ceil_mode, False, "avg", **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 3),
                         _tup(strides, 3) if strides is not None else None,
                         _tup(padding, 3), ceil_mode, False, "avg", **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), False, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "max",
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), False, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "avg",
                         **kwargs)
