"""ResNet v1/v2 symbol builder.

The port's copy of the reference package's ``models/resnet.py``, over
the port's ``symbol``: the same graph, node names and parameter shapes
(He et al. 2015/2016, the pre-activation variant for v2), NCHW, with
the cifar stem, the imagenet 7x7/2 stem and its space-to-depth form.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "resnet"]

# depth -> (block counts per stage, bottleneck?)
_CONFIGS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def _conv(data, num_filter, kernel, stride, pad, name):
    return sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True, name=name)


def _stem_s2d(data, num_filter, height, name="conv0"):
    """The imagenet 7x7/2 stem rewritten as a mathematically identical
    4x4/1 valid conv on the 2x2 space-to-depth input: 12 input channels
    and no stride. The parameter keeps the (F, 3, 7, 7) shape (same name,
    same checkpoint) and is re-laid-out in the graph: zero-pad 7->8 taps,
    split each spatial index 2a+q, and fold the parity (q, r) planes
    into channels.
    """
    h2 = height // 2 + 3  # padded-by-3 input, halved: conv input extent
    w = sym.Variable(name + "_weight", shape=(num_filter, 3, 7, 7))
    wp = sym.Pad(w, mode="constant", pad_width=(0, 0, 0, 0, 0, 1, 0, 1))
    wr = sym.Reshape(wp, shape=(num_filter, 3, 4, 2, 4, 2))
    wt = sym.transpose(wr, axes=(0, 1, 3, 5, 2, 4))
    wf = sym.Reshape(wt, shape=(num_filter, 12, 4, 4))
    xp = sym.Pad(data, mode="constant", pad_width=(0, 0, 0, 0, 3, 3, 3, 3))
    xr = sym.Reshape(xp, shape=(0, 3, h2, 2, h2, 2))
    xt = sym.transpose(xr, axes=(0, 1, 3, 5, 2, 4))
    xs = sym.Reshape(xt, shape=(0, 12, h2, h2))
    return sym.Convolution(data=xs, weight=wf, num_filter=num_filter,
                           kernel=(4, 4), stride=(1, 1), pad=(0, 0),
                           no_bias=True, name=name)


def _bn(data, name, fix_gamma=False):
    return sym.BatchNorm(data=data, fix_gamma=fix_gamma, eps=2e-5,
                         momentum=0.9, name=name)


def _unit_v1(data, num_filter, stride, dim_match, name, bottleneck):
    """Post-activation residual unit (v1)."""
    if bottleneck:
        b = _conv(data, num_filter // 4, (1, 1), stride, (0, 0), name + "_conv1")
        b = _bn(b, name + "_bn1")
        b = sym.Activation(data=b, act_type="relu", name=name + "_relu1")
        b = _conv(b, num_filter // 4, (3, 3), (1, 1), (1, 1), name + "_conv2")
        b = _bn(b, name + "_bn2")
        b = sym.Activation(data=b, act_type="relu", name=name + "_relu2")
        b = _conv(b, num_filter, (1, 1), (1, 1), (0, 0), name + "_conv3")
        b = _bn(b, name + "_bn3")
    else:
        b = _conv(data, num_filter, (3, 3), stride, (1, 1), name + "_conv1")
        b = _bn(b, name + "_bn1")
        b = sym.Activation(data=b, act_type="relu", name=name + "_relu1")
        b = _conv(b, num_filter, (3, 3), (1, 1), (1, 1), name + "_conv2")
        b = _bn(b, name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv(data, num_filter, (1, 1), stride, (0, 0),
                         name + "_sc")
        shortcut = _bn(shortcut, name + "_sc_bn")
    out = b + shortcut
    return sym.Activation(data=out, act_type="relu", name=name + "_relu")


def _unit_v2(data, num_filter, stride, dim_match, name, bottleneck):
    """Pre-activation residual unit (v2 — the reference's default)."""
    bn1 = _bn(data, name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    if bottleneck:
        b = _conv(act1, num_filter // 4, (1, 1), (1, 1), (0, 0),
                  name + "_conv1")
        b = _bn(b, name + "_bn2")
        b = sym.Activation(data=b, act_type="relu", name=name + "_relu2")
        b = _conv(b, num_filter // 4, (3, 3), stride, (1, 1), name + "_conv2")
        b = _bn(b, name + "_bn3")
        b = sym.Activation(data=b, act_type="relu", name=name + "_relu3")
        b = _conv(b, num_filter, (1, 1), (1, 1), (0, 0), name + "_conv3")
    else:
        b = _conv(act1, num_filter, (3, 3), stride, (1, 1), name + "_conv1")
        b = _bn(b, name + "_bn2")
        b = sym.Activation(data=b, act_type="relu", name=name + "_relu2")
        b = _conv(b, num_filter, (3, 3), (1, 1), (1, 1), name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv(act1, num_filter, (1, 1), stride, (0, 0),
                         name + "_sc")
    return b + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottleneck=True, version=2, stem="7x7"):
    """Assemble a ResNet (reference: symbols/resnet.py resnet()).

    ``stem="s2d"`` lowers the imagenet stem through the space-to-depth
    transform (see ``_stem_s2d``): the same function and parameters;
    it needs a 3-channel, square input of even size."""
    data = sym.Variable("data")
    nchannel, height, _ = image_shape
    unit = _unit_v2 if version == 2 else _unit_v1

    if stem not in ("7x7", "s2d"):
        raise ValueError("stem must be '7x7' or 's2d', got %r" % (stem,))
    if stem == "s2d":
        if height <= 32:
            raise ValueError(
                "stem='s2d' rewrites the imagenet 7x7/2 stem; the cifar "
                "stem (height <= 32) has no 7x7 conv to transform")
        if nchannel != 3 or height % 2 or image_shape[2] != height:
            raise ValueError(
                "stem='s2d' needs a 3-channel, square, even-size input "
                "(got image_shape %s)" % (image_shape,))
    body = data
    if version == 2:
        body = _bn(body, "bn_data", fix_gamma=True)
    if height <= 32:  # cifar-style stem
        body = _conv(body, filter_list[0], (3, 3), (1, 1), (1, 1), "conv0")
    else:             # imagenet stem
        if stem == "s2d":
            body = _stem_s2d(body, filter_list[0], height)
        else:
            body = _conv(body, filter_list[0], (7, 7), (2, 2), (3, 3),
                         "conv0")
        body = _bn(body, "bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max", name="pool0")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 and height > 32 else \
            ((1, 1) if i == 0 else (2, 2))
        body = unit(body, filter_list[i + 1], stride, False,
                    "stage%d_unit1" % (i + 1), bottleneck)
        for j in range(units[i] - 1):
            body = unit(body, filter_list[i + 1], (1, 1), True,
                        "stage%d_unit%d" % (i + 1, j + 2), bottleneck)

    if version == 2:
        body = _bn(body, "bn1")
        body = sym.Activation(data=body, act_type="relu", name="relu1")
    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               version=2, stem="7x7", **kwargs):
    """(reference: symbols/resnet.py get_symbol)."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    if image_shape[1] <= 32:
        # cifar config (reference resnet.py: per-depth unit derivation —
        # any depth with (n-2) % 9 == 0 (bottleneck) or % 6 == 0 works,
        # e.g. resnet-8/20/56/110)
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per = (num_layers - 2) // 9
            units, bottleneck = [per] * 3, True
        elif (num_layers - 2) % 6 == 0:
            per = (num_layers - 2) // 6
            units, bottleneck = [per] * 3, False
        else:
            raise ValueError(
                "unsupported small-image resnet depth %d "
                "(need (n-2) %% 6 == 0)" % num_layers)
        filter_list = [16, 64, 128, 256] if bottleneck else [16, 16, 32, 64]
        num_stages = 3
    else:
        if num_layers not in _CONFIGS:
            raise ValueError("unsupported resnet depth %d" % num_layers)
        units, bottleneck = _CONFIGS[num_layers]
        filter_list = [64, 256, 512, 1024, 2048] if bottleneck else \
            [64, 64, 128, 256, 512]
        num_stages = 4
    return resnet(units=units[:num_stages], num_stages=num_stages,
                  filter_list=filter_list, num_classes=num_classes,
                  image_shape=image_shape, bottleneck=bottleneck,
                  version=version, stem=stem)
