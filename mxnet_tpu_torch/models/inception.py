"""Inception symbol builders: Inception-BN (224x224, ``version="bn"``)
and Inception-v3 (299x299, ``version="v3"``).

The port's copy of the reference package's ``models/inception.py``,
over the port's ``symbol``: the networks of upstream MXNet's
``example/image-classification/symbols/inception-bn.py`` and
``inception-v3.py`` (the Inception columns of its perf tables), with
the same node names and parameter shapes.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol"]


def _conv_bn(x, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=""):
    x = sym.Convolution(data=x, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    x = sym.BatchNorm(data=x, fix_gamma=False, eps=1e-3,
                      name="%s_bn" % name)
    return sym.Activation(data=x, act_type="relu", name="%s_relu" % name)


def _pool(x, kernel, stride, pool_type, pad=(0, 0), name=""):
    return sym.Pooling(data=x, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


# ------------------------------------------------------------ Inception-BN


def _bn_unit_a(x, c1, c3r, c3, d3r, d3, pool, proj, name):
    """1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-proj, stride 1."""
    b1 = _conv_bn(x, c1, (1, 1), name="%s_1x1" % name)
    b2 = _conv_bn(x, c3r, (1, 1), name="%s_3x3r" % name)
    b2 = _conv_bn(b2, c3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    b3 = _conv_bn(x, d3r, (1, 1), name="%s_d3x3r" % name)
    b3 = _conv_bn(b3, d3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    b3 = _conv_bn(b3, d3, (3, 3), pad=(1, 1), name="%s_d3x3b" % name)
    b4 = _pool(x, (3, 3), (1, 1), pool, pad=(1, 1), name="%s_pool" % name)
    b4 = _conv_bn(b4, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b2, b3, b4, name="%s_concat" % name)


def _bn_unit_b(x, c3r, c3, d3r, d3, name):
    """Stride-2 grid reduction: 1x1-3x3/2 | 1x1-3x3-3x3/2 | maxpool/2."""
    b1 = _conv_bn(x, c3r, (1, 1), name="%s_3x3r" % name)
    b1 = _conv_bn(b1, c3, (3, 3), stride=(2, 2), pad=(1, 1),
                  name="%s_3x3" % name)
    b2 = _conv_bn(x, d3r, (1, 1), name="%s_d3x3r" % name)
    b2 = _conv_bn(b2, d3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    b2 = _conv_bn(b2, d3, (3, 3), stride=(2, 2), pad=(1, 1),
                  name="%s_d3x3b" % name)
    b3 = _pool(x, (3, 3), (2, 2), "max", pad=(1, 1), name="%s_pool" % name)
    return sym.Concat(b1, b2, b3, name="%s_concat" % name)


def _inception_bn(num_classes):
    data = sym.Variable("data")                       # (N, 3, 224, 224)
    x = _conv_bn(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="stem1")
    x = _pool(x, (3, 3), (2, 2), "max", pad=(1, 1), name="stem_pool1")
    x = _conv_bn(x, 64, (1, 1), name="stem2r")
    x = _conv_bn(x, 192, (3, 3), pad=(1, 1), name="stem2")
    x = _pool(x, (3, 3), (2, 2), "max", pad=(1, 1), name="stem_pool2")
    x = _bn_unit_a(x, 64, 64, 64, 64, 96, "avg", 32, "in3a")
    x = _bn_unit_a(x, 64, 64, 96, 64, 96, "avg", 64, "in3b")
    x = _bn_unit_b(x, 128, 160, 64, 96, "in3c")
    x = _bn_unit_a(x, 224, 64, 96, 96, 128, "avg", 128, "in4a")
    x = _bn_unit_a(x, 192, 96, 128, 96, 128, "avg", 128, "in4b")
    x = _bn_unit_a(x, 160, 128, 160, 128, 160, "avg", 128, "in4c")
    x = _bn_unit_a(x, 96, 128, 192, 160, 192, "avg", 128, "in4d")
    x = _bn_unit_b(x, 128, 192, 192, 256, "in4e")
    x = _bn_unit_a(x, 352, 192, 320, 160, 224, "avg", 128, "in5a")
    x = _bn_unit_a(x, 352, 192, 320, 192, 224, "max", 128, "in5b")
    x = sym.Pooling(data=x, global_pool=True, pool_type="avg", kernel=(7, 7),
                    name="global_pool")
    x = sym.Flatten(data=x)
    x = sym.FullyConnected(data=x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")


# ------------------------------------------------------------ Inception-v3


def _v3_a(x, pool_proj, name):
    b1 = _conv_bn(x, 64, (1, 1), name="%s_1x1" % name)
    b2 = _conv_bn(x, 48, (1, 1), name="%s_5x5r" % name)
    b2 = _conv_bn(b2, 64, (5, 5), pad=(2, 2), name="%s_5x5" % name)
    b3 = _conv_bn(x, 64, (1, 1), name="%s_d3r" % name)
    b3 = _conv_bn(b3, 96, (3, 3), pad=(1, 1), name="%s_d3a" % name)
    b3 = _conv_bn(b3, 96, (3, 3), pad=(1, 1), name="%s_d3b" % name)
    b4 = _pool(x, (3, 3), (1, 1), "avg", pad=(1, 1), name="%s_pool" % name)
    b4 = _conv_bn(b4, pool_proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b2, b3, b4, name="%s_concat" % name)


def _v3_b(x, name):
    b1 = _conv_bn(x, 384, (3, 3), stride=(2, 2), name="%s_3x3" % name)
    b2 = _conv_bn(x, 64, (1, 1), name="%s_d3r" % name)
    b2 = _conv_bn(b2, 96, (3, 3), pad=(1, 1), name="%s_d3a" % name)
    b2 = _conv_bn(b2, 96, (3, 3), stride=(2, 2), name="%s_d3b" % name)
    b3 = _pool(x, (3, 3), (2, 2), "max", name="%s_pool" % name)
    return sym.Concat(b1, b2, b3, name="%s_concat" % name)


def _v3_c(x, c7, name):
    b1 = _conv_bn(x, 192, (1, 1), name="%s_1x1" % name)
    b2 = _conv_bn(x, c7, (1, 1), name="%s_7r" % name)
    b2 = _conv_bn(b2, c7, (1, 7), pad=(0, 3), name="%s_7a" % name)
    b2 = _conv_bn(b2, 192, (7, 1), pad=(3, 0), name="%s_7b" % name)
    b3 = _conv_bn(x, c7, (1, 1), name="%s_77r" % name)
    b3 = _conv_bn(b3, c7, (7, 1), pad=(3, 0), name="%s_77a" % name)
    b3 = _conv_bn(b3, c7, (1, 7), pad=(0, 3), name="%s_77b" % name)
    b3 = _conv_bn(b3, c7, (7, 1), pad=(3, 0), name="%s_77c" % name)
    b3 = _conv_bn(b3, 192, (1, 7), pad=(0, 3), name="%s_77d" % name)
    b4 = _pool(x, (3, 3), (1, 1), "avg", pad=(1, 1), name="%s_pool" % name)
    b4 = _conv_bn(b4, 192, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b2, b3, b4, name="%s_concat" % name)


def _v3_d(x, name):
    b1 = _conv_bn(x, 192, (1, 1), name="%s_3r" % name)
    b1 = _conv_bn(b1, 320, (3, 3), stride=(2, 2), name="%s_3" % name)
    b2 = _conv_bn(x, 192, (1, 1), name="%s_7r" % name)
    b2 = _conv_bn(b2, 192, (1, 7), pad=(0, 3), name="%s_7a" % name)
    b2 = _conv_bn(b2, 192, (7, 1), pad=(3, 0), name="%s_7b" % name)
    b2 = _conv_bn(b2, 192, (3, 3), stride=(2, 2), name="%s_7c" % name)
    b3 = _pool(x, (3, 3), (2, 2), "max", name="%s_pool" % name)
    return sym.Concat(b1, b2, b3, name="%s_concat" % name)


def _v3_e(x, name):
    b1 = _conv_bn(x, 320, (1, 1), name="%s_1x1" % name)
    b2 = _conv_bn(x, 384, (1, 1), name="%s_13r" % name)
    b2a = _conv_bn(b2, 384, (1, 3), pad=(0, 1), name="%s_13a" % name)
    b2b = _conv_bn(b2, 384, (3, 1), pad=(1, 0), name="%s_13b" % name)
    b3 = _conv_bn(x, 448, (1, 1), name="%s_d13r" % name)
    b3 = _conv_bn(b3, 384, (3, 3), pad=(1, 1), name="%s_d13" % name)
    b3a = _conv_bn(b3, 384, (1, 3), pad=(0, 1), name="%s_d13a" % name)
    b3b = _conv_bn(b3, 384, (3, 1), pad=(1, 0), name="%s_d13b" % name)
    b4 = _pool(x, (3, 3), (1, 1), "avg", pad=(1, 1), name="%s_pool" % name)
    b4 = _conv_bn(b4, 192, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b2a, b2b, b3a, b3b, b4, name="%s_concat" % name)


def _inception_v3(num_classes):
    data = sym.Variable("data")                       # (N, 3, 299, 299)
    x = _conv_bn(data, 32, (3, 3), stride=(2, 2), name="stem1")
    x = _conv_bn(x, 32, (3, 3), name="stem2")
    x = _conv_bn(x, 64, (3, 3), pad=(1, 1), name="stem3")
    x = _pool(x, (3, 3), (2, 2), "max", name="stem_pool1")
    x = _conv_bn(x, 80, (1, 1), name="stem4")
    x = _conv_bn(x, 192, (3, 3), name="stem5")
    x = _pool(x, (3, 3), (2, 2), "max", name="stem_pool2")
    x = _v3_a(x, 32, "mixed5b")
    x = _v3_a(x, 64, "mixed5c")
    x = _v3_a(x, 64, "mixed5d")
    x = _v3_b(x, "mixed6a")
    x = _v3_c(x, 128, "mixed6b")
    x = _v3_c(x, 160, "mixed6c")
    x = _v3_c(x, 160, "mixed6d")
    x = _v3_c(x, 192, "mixed6e")
    x = _v3_d(x, "mixed7a")
    x = _v3_e(x, "mixed7b")
    x = _v3_e(x, "mixed7c")
    x = sym.Pooling(data=x, global_pool=True, pool_type="avg", kernel=(8, 8),
                    name="global_pool")
    x = sym.Flatten(data=x)
    x = sym.Dropout(data=x, p=0.5, name="drop")
    x = sym.FullyConnected(data=x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")


def get_symbol(num_classes=1000, version="v3", **kwargs):
    """``version``: "v3" (299x299) or "bn" (224x224)."""
    if version == "v3":
        return _inception_v3(num_classes)
    if version == "bn":
        return _inception_bn(num_classes)
    raise ValueError("unknown inception version %r" % version)
