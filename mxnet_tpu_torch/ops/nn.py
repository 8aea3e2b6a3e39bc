"""Neural-network layer ops of the training path.

The port's counterpart of the reference's ``ops/nn.py`` for
``Activation``, ``softmax``, ``FullyConnected``, ``LayerNorm`` and
``SoftmaxOutput``, with the reference's semantics:

* ``FullyConnected`` under amp multiplies bf16 operands with f32
  accumulation, returns bf16 and adds ``bias`` cast to bf16 in bf16.
* ``LayerNorm`` takes one-pass f32 statistics (``var = max(E[x²] −
  E[x]², 0)``), returns the input's dtype, and has the reference's
  analytic backward (an ``autograd.Function``, not autograd of the
  formula), saving only the input and the per-row statistics.
* ``SoftmaxOutput``'s backward ignores the incoming gradient and
  returns ``(softmax − onehot(label))·grad_scale``, divided by the
  number of rows under ``normalization="batch"``; under amp the head is
  computed in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..base import MXNetError
from .registry import register

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


@register("softmax")
def softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


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


def _layer_norm_stats(x32, ax, eps):
    mean = x32.mean(dim=ax, keepdim=True)
    msq = (x32 * x32).mean(dim=ax, keepdim=True)
    var = torch.clamp(msq - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _bshape(data, ax):
    return tuple(data.shape[ax] if i == ax else 1 for i in range(data.dim()))


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, gamma, beta, ax, eps):
        x32 = data.float()
        mean, rstd = _layer_norm_stats(x32, ax, eps)
        shp = _bshape(data, ax)
        out = (x32 - mean) * rstd * gamma.reshape(shp).float() \
            + beta.reshape(shp).float()
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


@register("LayerNorm", num_inputs=3)
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Layer normalization over ``axis``: f32 statistics, output in the
    input's dtype."""
    if output_mean_var:
        raise MXNetError("LayerNorm(output_mean_var=True) is not ported "
                         "yet (ROADMAP.md queue A1)")
    ax = axis % data.dim()
    return _LayerNorm.apply(data, gamma, beta, ax, float(eps))


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
