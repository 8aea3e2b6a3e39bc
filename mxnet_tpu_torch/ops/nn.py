"""Neural-network layer ops.

The port's counterpart of the reference's ``ops/nn.py``:
``Activation``, ``LeakyReLU``, ``softmax``, ``log_softmax``,
``SoftmaxActivation``, ``FullyConnected``, ``Convolution`` (and its
legacy name ``Convolution_v1``), ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``InstanceNorm``, ``LayerNorm``, ``L2Normalization``,
``LRN``, ``Dropout``, ``UpSampling`` and the loss heads
(``SoftmaxOutput``, ``{Linear,Logistic,MAE}RegressionOutput``,
``MakeLoss``, ``SVMOutput``, ``IdentityAttachKLSparseReg``), with the
reference's semantics:

* ``FullyConnected`` and ``Convolution`` under amp multiply bf16
  operands with f32 accumulation, return bf16 and add ``bias`` cast to
  bf16 in bf16. A float32 convolution runs in full float32 (TF32 off,
  forward and backward: ``amp.conv_precision``).
* ``Deconvolution`` (a transposed convolution) takes the reference's
  weight layout ``(C_in, num_filter/group, *kernel)``, which is torch's,
  and its ``adj`` as torch's ``output_padding``; it runs through the
  same ``aten.convolution`` route as ``Convolution`` (cuDNN on the card),
  with the same amp and float32 rules.
* ``Dropout`` and ``LeakyReLU(act_type="rrelu")`` draw in training only
  (``_is_train``), from a generator on the data's device seeded from
  the key chain (``random.torch_generator``); the mask is a tensor that
  autograd saves, so backward uses the forward's.
* ``Pooling`` pads max pooling with −∞ and, under
  ``pooling_convention="full"``, pads the high side up to a whole
  stride, as the reference does (which is not torch's ``ceil_mode``:
  that drops a last window that would start in the padding). Average
  pooling divides by the whole window unless ``count_include_pad`` is
  False.
* ``BatchNorm`` follows the reference's aux protocol: inputs
  ``moving_mean`` and ``moving_var`` are aux states, and the op returns
  ``(out, mean, var, new_moving_mean, new_moving_var)``. A training
  pass normalises with the batch statistics (f32, from bf16 data under
  amp; the output in the data's dtype) and blends them into the moving
  ones as ``momentum·old + (1 − momentum)·batch`` with the *biased*
  batch variance; torch's own running-stat update (unbiased variance,
  momentum the weight of the new value) is never used. The moving
  statistics take no part in the gradient. The normalisation runs on
  torch's batch-norm kernels (``native_batch_norm``; cuDNN's, through
  torch, refuses bf16 data with an f32 scale).
* ``LayerNorm`` takes one-pass f32 statistics (``var = max(E[x²] −
  E[x]², 0)``), returns the input's dtype, and has the reference's
  analytic backward (an ``autograd.Function``, not autograd of the
  formula), saving only the input and the per-row statistics.
* ``SoftmaxOutput``'s backward ignores the incoming gradient and
  returns ``(softmax − onehot(label))·grad_scale``, divided by the
  number of rows under ``normalization="batch"``; under amp the head is
  computed in float32. The other loss heads ignore it too and return
  their loss's gradient (``torch.autograd.Function``\\ s, as the
  reference's ``custom_vjp``\\ s); ``IdentityAttachKLSparseReg`` adds the
  KL sparsity penalty's gradient to it and commits its moving average
  of the mean activation as an aux state.
* ``LRN`` sums the squares over a zero-padded window of ``2·(nsize//2)
  + 1`` channels and divides by ``nsize``, in float32 (under amp too);
  the output is in the input's dtype.
* ``UpSampling``'s bilinear mode is ``jax.image.resize``'s
  (half-pixel centres, edges clamped), which for an integer scale is
  torch's ``interpolate(align_corners=False)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp
from .. import config as _config
from ..base import MXNetError
from .registry import register


def _tup(x, n):
    """An attribute as an n-tuple of ints (one value repeats); None and
    ``()`` stay None, for the caller's default."""
    if x is None:
        return None
    t = (int(x),) if isinstance(x, (int, float)) else tuple(int(v) for v in x)
    if len(t) == 1:
        t = t * n
    return t or None

__all__ = []


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    """relu / sigmoid / tanh / softrelu / softsign."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1 + data.abs())
    raise ValueError("unknown act_type %s" % act_type)


@register("LeakyReLU", num_inputs=None)
def leaky_relu(*inputs, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334, _is_train=False):
    """leaky / elu / prelu (a second input, ``gamma``, per channel) /
    rrelu (a slope drawn per sample and channel from U(lower, upper) in
    training, their mean otherwise)."""
    data = inputs[0]
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = inputs[1].reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        if _is_train:
            from .. import random as _random
            s = torch.rand(data.shape[:2], device=data.device,
                           generator=_random.torch_generator(data.device))
            s = (lower_bound + (upper_bound - lower_bound) * s).to(
                data.dtype).reshape(data.shape[:2] + (1,) * (data.dim() - 2))
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, s * data)
    raise ValueError("unknown act_type %s" % act_type)


@register("softmax")
def softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    """Softmax over the flattened trailing axes (``instance``) or over
    axis 1 (``channel``)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


@register("FullyConnected", num_inputs=None, aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x Wᵀ + b, the product in the amp policy's dtype with f32
    accumulation."""
    x = data.reshape(data.shape[0], -1) \
        if (flatten and data.dim() > 2) else data
    x, w = amp.mxu_operands(x, weight)
    out = torch.matmul(x, w.t())
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype)
    return out


# ----------------------------------------------------------------- conv

class _Convolution(torch.autograd.Function):
    """``aten.convolution`` forward and ``aten.convolution_backward``
    (transposed or not), both inside :func:`amp.conv_precision`, so that
    a float32 convolution's backward is float32 too (autograd's own
    backward would run outside the forward's precision scope)."""

    @staticmethod
    def forward(ctx, data, weight, stride, pad, dilate, groups,
                transposed=False, output_pad=None):
        output_pad = output_pad or (0,) * len(stride)
        with amp.conv_precision(data.dtype):
            out = torch.ops.aten.convolution(
                data, weight, None, stride, pad, dilate, transposed,
                output_pad, groups)
        ctx.save_for_backward(data, weight)
        ctx.geometry = (stride, pad, dilate, transposed, output_pad, groups)
        return out

    @staticmethod
    def backward(ctx, grad):
        data, weight = ctx.saved_tensors
        stride, pad, dilate, transposed, output_pad, groups = ctx.geometry
        with amp.conv_precision(data.dtype):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, data, weight, None, stride, pad, dilate, transposed,
                output_pad, groups,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return dx, dw, None, None, None, None, None, None


@register("Convolution", num_inputs=None,
          aliases=("convolution", "Convolution_v1"))
def convolution(data, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False, layout=None):
    """N-d convolution over NC(D)HW data and an (F, C/group, *kernel)
    weight; ``workspace`` and the ``cudnn_*`` attributes are accepted
    for API parity and ignored, as in the reference."""
    if layout is not None and not str(layout).startswith("NC"):
        raise MXNetError("Convolution(layout=%r): only channels-first "
                         "layouts are ported (channels-last is ROADMAP.md "
                         "queue A4)" % (layout,))
    nd = data.dim() - 2
    stride = _tup(stride, nd) or (1,) * nd
    dilate = _tup(dilate, nd) or (1,) * nd
    pad = _tup(pad, nd) or (0,) * nd
    data, weight = amp.mxu_operands(data, weight)
    out = _Convolution.apply(data, weight, stride, pad, dilate,
                             int(num_group))
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd).to(out.dtype)
    return out


@register("Deconvolution", num_inputs=None, aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, workspace=1024,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """N-d transposed convolution over NC(D)HW data and a (C_in,
    num_filter/group, *kernel) weight: output size ``(in - 1)·stride −
    2·pad + dilate·(kernel − 1) + adj + 1``."""
    if layout is not None and not str(layout).startswith("NC"):
        raise MXNetError("Deconvolution(layout=%r): only channels-first "
                         "layouts are ported (channels-last is ROADMAP.md "
                         "queue A4)" % (layout,))
    nd = data.dim() - 2
    stride = _tup(stride, nd) or (1,) * nd
    dilate = _tup(dilate, nd) or (1,) * nd
    pad = _tup(pad, nd) or (0,) * nd
    adj = _tup(adj, nd) or (0,) * nd
    data, weight = amp.mxu_operands(data, weight)
    out = _Convolution.apply(data, weight, stride, pad, dilate,
                             int(num_group), True, adj)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd).to(out.dtype)
    return out


# ----------------------------------------------------------------- pooling

_POOL = {1: (F.max_pool1d, F.avg_pool1d), 2: (F.max_pool2d, F.avg_pool2d),
         3: (F.max_pool3d, F.avg_pool3d)}


@register("Pooling", aliases=("pooling", "Pooling_v1"))
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            cudnn_off=False, count_include_pad=True):
    """Max / avg / sum pooling over NC(D)HW, 1-3 spatial axes."""
    nd = data.dim() - 2
    if nd not in _POOL:
        raise MXNetError("Pooling over %d spatial axes (1-3 are ported)"
                         % nd)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError("unknown pool_type %s" % pool_type)
    max_pool, avg_pool = _POOL[nd]
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd) or (1,) * nd
    pad = _tup(pad, nd) or (0,) * nd
    hi = list(pad)
    if pooling_convention == "full":
        # the output size rounded up: pad the high side to a whole stride
        for i in range(nd):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi[i] += stride[i] - rem
    # torch pads implicitly only symmetrically, up to half the window
    implicit = list(hi) == list(pad) and all(
        p <= k // 2 for p, k in zip(pad, kernel))
    x, padding = data, pad
    if not implicit:
        flat = [p for lo_hi in reversed(list(zip(pad, hi))) for p in lo_hi]
        x = F.pad(data, flat, value=-math.inf if pool_type == "max" else 0.0)
        padding = (0,) * nd
    if pool_type == "max":
        return max_pool(x, kernel, stride, padding)
    if pool_type == "sum" or count_include_pad:
        out = avg_pool(x, kernel, stride, padding, count_include_pad=True)
        return out * math.prod(kernel) if pool_type == "sum" else out
    if implicit:
        return avg_pool(x, kernel, stride, padding, count_include_pad=False)
    # the share of each window that lies on the data, from a padded mask
    ones = F.pad(data.new_ones((1, 1) + tuple(data.shape[2:])), flat)
    return avg_pool(x, kernel, stride) / avg_pool(ones, kernel, stride)


# ----------------------------------------------------------------- norm

@register("BatchNorm", num_inputs=5, num_aux=2, num_hidden_outputs=2,
          aliases=("batch_norm", "BatchNorm_v1"))
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _is_train=False):
    """Batch normalization over every axis but ``axis``. Returns ``(out,
    mean, var, new_moving_mean, new_moving_var)``; outside training (or
    with ``use_global_stats``) it normalises with the moving statistics
    and returns them unchanged, as the same tensors."""
    ax = axis % data.dim()
    x = data.movedim(ax, 1) if ax != 1 else data
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _is_train and not use_global_stats:
        # no running statistics handed to torch: it updates none
        out, mean, invstd = torch.native_batch_norm(
            x, g, beta, None, None, True, 0.0, eps)
        with torch.no_grad():
            # the biased batch variance
            var = (invstd.pow(-2) - eps).clamp(min=0.0)
            new_mm = momentum * moving_mean + (1 - momentum) * mean
            new_mv = momentum * moving_var + (1 - momentum) * var
    else:
        out = torch.native_batch_norm(x, g, beta, moving_mean, moving_var,
                                      False, 0.0, eps)[0]
        mean, var = new_mm, new_mv = moving_mean, moving_var
    if ax != 1:
        out = out.movedim(1, ax)
    return out, mean, var, new_mm, new_mv


@register("Dropout", aliases=("dropout",))
def dropout(data, p=0.5, mode="training", _is_train=False):
    """Inverted dropout: in training (or ``mode="always"``) each element
    is kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``;
    otherwise the identity."""
    if (not _is_train and mode != "always") or p == 0.0:
        return data
    if data.device.type == "meta":
        return torch.empty_like(data)
    from .. import random as _random
    keep = 1.0 - p
    u = torch.rand(data.shape, device=data.device,
                   generator=_random.torch_generator(data.device))
    return torch.where(u < keep, data / keep, torch.zeros_like(data))


@register("UpSampling", num_inputs=None)
def upsampling(*data, scale=2, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=None, workspace=512):
    """Each input resized to the first one's size times ``scale``:
    ``nearest`` repeats pixels, ``bilinear`` interpolates with
    half-pixel centres; several inputs are concatenated along the
    channels (or summed, ``multi_input_mode="sum"``)."""
    scale = int(scale)
    th, tw = data[0].shape[2] * scale, data[0].shape[3] * scale
    outs = []
    for d in data:
        if sample_type == "nearest":
            s = th // d.shape[2]
            o = d.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        else:
            o = F.interpolate(d, size=(th, tw), mode="bilinear",
                              align_corners=False)
        outs.append(o)
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


def _layer_norm_stats(x32, ax, eps):
    """The mean and 1/sqrt(var + eps) over ``ax``. The variance is the
    one-pass E[x²] - E[x]² unless ``MXNET_TPU_LAYERNORM_TWO_PASS`` asks
    for E[(x - mean)²], which re-reads x after the mean and keeps its
    precision when the rows carry a large common offset. The knob is
    read on every call, as the reference reads it."""
    mean = x32.mean(dim=ax, keepdim=True)
    if _config.get("MXNET_TPU_LAYERNORM_TWO_PASS"):
        d = x32 - mean
        var = (d * d).mean(dim=ax, keepdim=True)
    else:
        msq = (x32 * x32).mean(dim=ax, keepdim=True)
        var = torch.clamp(msq - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _bshape(data, ax):
    return tuple(data.shape[ax] if i == ax else 1 for i in range(data.dim()))


def _layer_norm(data, gamma, beta, ax, eps):
    """``(out, mean, rstd)``: the normalized rows in f32, and the
    statistics."""
    x32 = data.float()
    mean, rstd = _layer_norm_stats(x32, ax, eps)
    shp = _bshape(data, ax)
    out = (x32 - mean) * rstd * gamma.reshape(shp).float() \
        + beta.reshape(shp).float()
    return out, mean, rstd


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, gamma, beta, ax, eps):
        out, mean, rstd = _layer_norm(data, gamma, beta, ax, eps)
        ctx.save_for_backward(data, gamma, mean, rstd)
        ctx.ax = ax
        ctx.beta_dtype = beta.dtype
        return out.to(data.dtype)

    @staticmethod
    def backward(ctx, g):
        data, gamma, mean, rstd = ctx.saved_tensors
        ax = ctx.ax
        shp = _bshape(data, ax)
        xhat = (data.float() - mean) * rstd
        gy = g.float()
        gyg = gy * gamma.reshape(shp).float()
        m1 = gyg.mean(dim=ax, keepdim=True)
        m2 = (gyg * xhat).mean(dim=ax, keepdim=True)
        dx = (rstd * (gyg - m1 - xhat * m2)).to(data.dtype)
        red = tuple(i for i in range(data.dim()) if i != ax)
        dgamma = (gy * xhat).sum(dim=red).to(gamma.dtype)
        dbeta = gy.sum(dim=red).to(ctx.beta_dtype)
        return dx, dgamma.reshape(gamma.shape), \
            dbeta.reshape(gamma.shape), None, None


@register("LayerNorm", num_inputs=3,
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var")
          else 1)
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Layer normalization over ``axis``: f32 statistics, output in the
    input's dtype. With ``output_mean_var`` also the mean and variance
    (``axis`` dropped), differentiated through the formula as in the
    reference. Inside a compiled step's capture the output is the
    formula too, whose backward AOT autograd derives: torch 2.11's
    capture of :class:`_LayerNorm` runs its forward and drops its
    backward (every gradient through it zero, found on the card)."""
    ax = axis % data.dim()
    if output_mean_var:
        out, mean, rstd = _layer_norm(data, gamma, beta, ax, eps)
        var = (1.0 / rstd) ** 2 - eps
        return out.to(data.dtype), mean.squeeze(ax), var.squeeze(ax)
    if torch.compiler.is_compiling():
        return _layer_norm(data, gamma, beta, ax, eps)[0].to(data.dtype)
    return _LayerNorm.apply(data, gamma, beta, ax, float(eps))


@register("InstanceNorm", num_inputs=3)
def instance_norm(data, gamma, beta, eps=0.001):
    """Normalization of each (sample, channel) over the spatial axes
    (biased variance), then ``gamma`` and ``beta`` per channel."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = ((data - mean) ** 2).mean(dim=red, keepdim=True)
    shp = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shp) \
        + beta.reshape(shp)


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(Σ data² + eps)`` over every axis but the first
    (``instance``), over axis 1 (``channel``) or over the spatial axes
    (``spatial``)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    return data / torch.sqrt((data * data).sum(dim=red, keepdim=True) + eps)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels: ``x / (knorm +
    alpha·Σ/nsize)^beta``, Σ the sum of squares over the ``2·(nsize//2)
    + 1`` channels around each one (zero beyond the edges), in f32."""
    x32 = data.float()
    half = int(nsize) // 2
    width = 2 * half + 1
    sq = (x32 * x32).reshape(data.shape[0], 1, data.shape[1], -1)
    # the window's mean over channels (zero-padded), times its width
    ssum = F.avg_pool2d(sq, (width, 1), stride=1, padding=(half, 0),
                        count_include_pad=True) * width
    t = knorm + alpha * ssum.reshape(x32.shape) / nsize
    if beta == 0.75:
        r = torch.rsqrt(t)
        out = x32 * r * torch.sqrt(r)
    else:
        out = x32 / torch.pow(t, beta)
    return out.to(data.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, attrs):
        if attrs["multi_output"]:
            out = torch.softmax(data, dim=1)
        elif attrs["preserve_shape"]:
            out = torch.softmax(data, dim=-1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        # the incoming gradient is ignored: this op IS the loss
        out, label = ctx.saved_tensors
        a = ctx.attrs
        orig_shape = out.shape
        if not a["multi_output"] and not a["preserve_shape"] and \
                out.dim() > 2:
            out = out.reshape(out.shape[0], -1)
            label = label.reshape(label.shape[0], -1) \
                if label.dim() > 1 else label
        cls_axis = 1 if a["multi_output"] else out.dim() - 1
        depth = out.shape[cls_axis]
        # label -> out's shape with a class axis of 1
        slot = out.shape[:cls_axis] + (1,) + out.shape[cls_axis + 1:]
        lab = label.to(torch.int64).reshape(slot)
        # softmax - onehot(label), the one-hot never materialised; an
        # out-of-range id has an all-zero one-hot, as in the reference
        in_range = ((lab >= 0) & (lab < depth)).to(out.dtype)
        grad = out.clone()
        grad.scatter_add_(cls_axis, lab.clamp(0, depth - 1), -in_range)
        valid = torch.ones_like(in_range)
        if a["use_ignore"]:
            valid = (label.reshape(slot) != a["ignore_label"]).to(out.dtype)
            grad = grad * valid
        if a["normalization"] == "batch":
            grad = grad / out.shape[0]
        elif a["normalization"] == "valid":
            grad = grad / torch.clamp(valid.sum(), min=1.0)
        grad = grad.reshape(orig_shape)
        return (grad * a["grad_scale"]).to(out.dtype), None, None


@register("SoftmaxOutput", num_inputs=2,
          aliases=("softmax_output", "Softmax"))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, multi_output=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax forward with the cross-entropy gradient as its backward."""
    if amp.active() and data.dtype == amp.compute_dtype():
        data = data.float()     # the loss head runs in f32 under amp
    attrs = {"grad_scale": grad_scale, "ignore_label": ignore_label,
             "use_ignore": use_ignore, "multi_output": multi_output,
             "preserve_shape": preserve_shape,
             "normalization": normalization}
    return _SoftmaxOutput.apply(data, label, attrs)


# ------------------------------------------------------------ loss heads

class _Regression(torch.autograd.Function):
    """Identity (``logistic``: the sigmoid) forward; the backward ignores
    the incoming gradient and returns ``(out − label)`` (``mae``: its
    sign) times ``grad_scale``, over the number of outputs per row."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        n = out.shape[1] if out.dim() > 1 else 1
        diff = out - label
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        return (grad * ctx.grad_scale / n).to(out.dtype), None, None, None


@register("LinearRegressionOutput", num_inputs=2,
          aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale=1.0):
    """Identity forward; squared-error gradient."""
    return _Regression.apply(data, label, "linear", grad_scale)


@register("MAERegressionOutput", num_inputs=2,
          aliases=("mae_regression_output",))
def mae_regression_output(data, label, grad_scale=1.0):
    """Identity forward; absolute-error gradient."""
    return _Regression.apply(data, label, "mae", grad_scale)


@register("LogisticRegressionOutput", num_inputs=2,
          aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale=1.0):
    """Sigmoid forward; cross-entropy gradient ``sigmoid − label``."""
    return _Regression.apply(data, label, "logistic", grad_scale)


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` everywhere (over
    the batch, or over the entries above ``valid_thresh``)."""

    @staticmethod
    def forward(ctx, data, attrs):
        ctx.save_for_backward(data)
        ctx.attrs = attrs
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        a = ctx.attrs
        grad = torch.full_like(data, a["grad_scale"])
        if a["normalization"] == "batch":
            grad = grad / data.shape[0]
        elif a["normalization"] == "valid":
            valid = (data.abs() > a["valid_thresh"]).to(data.dtype)
            grad = grad * valid / torch.clamp(valid.sum(), min=1.0)
        return grad, None


@register("MakeLoss", aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """The input is a loss: identity forward, constant backward."""
    return _MakeLoss.apply(data, {"grad_scale": grad_scale,
                                  "valid_thresh": valid_thresh,
                                  "normalization": normalization})


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the hinge loss's gradient (squared, or linear
    with ``use_linear``) with +1 for the label's class and −1 for the
    others."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        ctx.save_for_backward(data, label)
        ctx.attrs = attrs
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        a = ctx.attrs
        idx = label.to(torch.int64).unsqueeze(-1)
        hot = idx == torch.arange(data.shape[-1], device=data.device)
        sgn = hot.to(data.dtype) * 2.0 - 1.0
        slack = a["margin"] - sgn * data
        if a["use_linear"]:
            grad = -sgn * a["regularization_coefficient"]
        else:
            grad = -2.0 * slack * sgn * a["regularization_coefficient"]
        grad = torch.where(slack > 0, grad, torch.zeros_like(grad))
        return grad.to(data.dtype), None, None


@register("SVMOutput", num_inputs=2, aliases=("svm_output",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity forward; the SVM's hinge-loss gradient."""
    return _SVMOutput.apply(data, label, {
        "margin": margin,
        "regularization_coefficient": regularization_coefficient,
        "use_linear": use_linear})


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds ``penalty·(−ρ/ρ̂ + (1−ρ)/(1−ρ̂))``
    to the incoming gradient, ρ̂ the updated moving average (saved as
    computed: the caller commits it into the aux state in place)."""

    @staticmethod
    def forward(ctx, data, new_ma, attrs):
        ctx.save_for_backward(new_ma)
        ctx.attrs = attrs
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (new_ma,) = ctx.saved_tensors
        a = ctx.attrs
        rho = a["sparseness_target"]
        flat = g.reshape(g.shape[0], -1)
        grad = flat + a["penalty"] * (-rho / new_ma + (1 - rho) / (1 - new_ma))
        return grad.reshape(g.shape).to(g.dtype), None, None


@register("IdentityAttachKLSparseReg", num_inputs=2, num_aux=1)
def identity_attach_kl_sparse_reg(data, moving_avg, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Identity forward whose backward attaches a KL sparsity penalty
    (pair it with sigmoid activations). ``moving_avg`` is an aux state:
    the op returns ``(out, new_moving_avg)``."""
    with torch.no_grad():
        avg = data.reshape(data.shape[0], -1).mean(dim=0)
        new_ma = momentum * moving_avg + (1 - momentum) * avg
    out = _KLSparseReg.apply(data, new_ma, {
        "sparseness_target": sparseness_target, "penalty": penalty,
        "momentum": momentum})
    return out, new_ma
