"""Matrix and shape ops.

The port's counterpart of the reference's ``ops/matrix.py``: ``dot``,
``batch_dot``, ``transpose``, ``expand_dims``, ``Reshape`` (with
MXNet's special codes), ``Flatten``, ``slice`` (begin, end and step per
axis, ``None`` for the default), ``slice_axis``, ``repeat``, ``tile``,
``reverse`` / ``flip``, ``Crop``, ``SwapAxis``, ``Concat``, ``stack``,
``SliceChannel`` (``split``, one output per chunk), ``where``,
``squeeze``, ``zeros_like``, ``ones_like``, ``add_n``, ``Pad``,
``khatri_rao`` and the ``linalg_*`` family (leading axes are batch
axes).

``dot`` contracts the last axis of ``lhs`` with the first of ``rhs``;
``transpose_a`` / ``transpose_b`` swap the last two axes of an operand
first. Its operands are cast under the amp policy, as FullyConnected's
are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp
from .registry import register

__all__ = ["reshape_shape"]


@register("batch_dot", num_inputs=2)
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched product over the leading axis, operands cast under the
    amp policy like FullyConnected."""
    a = lhs.transpose(1, 2) if transpose_a else lhs
    b = rhs.transpose(1, 2) if transpose_b else rhs
    a, b = amp.mxu_operands(a, b)
    return torch.bmm(a, b)


@register("dot", num_inputs=2)
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The product over the last axis of ``lhs`` and the first of
    ``rhs`` (after the requested transposes of their last two axes)."""
    a = lhs.transpose(-1, -2) if transpose_a and lhs.dim() > 1 else lhs
    b = rhs.transpose(-1, -2) if transpose_b and rhs.dim() > 1 else rhs
    a, b = amp.mxu_operands(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("transpose")
def transpose(data, axes=None):
    """Permute axes (all reversed when ``axes`` is empty)."""
    if axes is None or tuple(axes) == ():
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("expand_dims")
def expand_dims(data, axis=0):
    """Insert an axis of length 1 at ``axis``."""
    return data.unsqueeze(axis)


def reshape_shape(in_shape, shape, reverse=False):
    """The output shape of ``Reshape`` for input shape ``in_shape``,
    resolving the special codes:

      0  -> copy this dim from input
      -1 -> infer from remaining elements
      -2 -> copy all remaining input dims
      -3 -> merge two consecutive input dims
      -4 -> split one input dim into the next two listed dims (may
            contain -1)
    """
    in_shape = list(in_shape)
    spec = list(shape)
    if reverse:
        in_shape = in_shape[::-1]
        spec = spec[::-1]
    out = []
    src = 0
    i = 0
    while i < len(spec):
        s = spec[i]
        if s == 0:
            out.append(in_shape[src])
            src += 1
        elif s == -1:
            out.append(-1)
            src += 1
        elif s == -2:
            out.extend(in_shape[src:])
            src = len(in_shape)
        elif s == -3:
            out.append(in_shape[src] * in_shape[src + 1])
            src += 2
        elif s == -4:
            d1, d2 = spec[i + 1], spec[i + 2]
            whole = in_shape[src]
            src += 1
            if d1 == -1:
                d1 = whole // d2
            if d2 == -1:
                d2 = whole // d1
            out.extend([d1, d2])
            i += 2
        else:
            out.append(int(s))
            if src < len(in_shape):
                src += 1
        i += 1
    if reverse:
        out = out[::-1]
    total = math.prod(in_shape)
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def reshape(data, shape=None, reverse=False, target_shape=None,
            keep_highest=False):
    """Reshape with MXNet's special codes (see :func:`reshape_shape`)."""
    if shape is None or len(tuple(shape)) == 0:
        return data.reshape(tuple(target_shape))
    return data.reshape(reshape_shape(data.shape, shape, reverse))


@register("Flatten", aliases=("flatten",))
def flatten(data):
    """Collapse all but the first axis."""
    return data.reshape(data.shape[0], -1)


def _axis_index(n, begin, end, step):
    """A Python slice of an axis of length ``n`` as a ``slice`` (positive
    step) or the positions it selects (negative step, which torch's
    slicing lacks)."""
    sl = slice(begin, end, step)
    if step is None or step > 0:
        return sl
    return list(range(*sl.indices(n)))


@register("slice", aliases=("crop",))
def slice_op(data, begin=None, end=None, step=None):
    """``data[b0:e0:s0, b1:e1:s1, ...]`` over the leading axes, ``None``
    meaning the default of each."""
    begin = tuple(begin) if begin is not None else (None,) * data.dim()
    end = tuple(end) if end is not None else (None,) * len(begin)
    step = tuple(step) if step else ()
    step = step + (None,) * (len(begin) - len(step))
    out = data
    for axis, (b, e, st) in enumerate(zip(begin, end, step)):
        ix = _axis_index(data.shape[axis], b, e, st)
        if isinstance(ix, slice):
            out = out[(slice(None),) * axis + (ix,)]
        else:
            out = out.index_select(axis, torch.tensor(ix, dtype=torch.int64,
                                                      device=data.device))
    return out


@register("repeat")
def repeat(data, repeats=1, axis=None):
    """Each element repeated ``repeats`` times along ``axis`` (of the
    flattened array without one)."""
    return torch.repeat_interleave(data, int(repeats), dim=axis)


@register("tile")
def tile(data, reps=()):
    """The array repeated ``reps`` times along each axis (numpy's
    ``tile``)."""
    return torch.tile(data, tuple(int(r) for r in reps))


@register("reverse", aliases=("flip",))
def reverse(data, axis=0):
    """The order of ``axis`` (an int or a tuple) reversed."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axes)


@register("Crop", num_inputs=None)
def crop_like(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
              num_args=None):
    """A window of the trailing two axes: of ``h_w`` with one input
    (0 keeps an axis), of the second input's size with two; at
    ``offset``, or centred."""
    data = inputs[0]
    H, W = data.shape[-2], data.shape[-1]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[-2], inputs[1].shape[-1]
    else:
        th, tw = int(h_w[0]) or H, int(h_w[1]) or W
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    if y0 + th > H or x0 + tw > W:
        raise ValueError("Crop: window %dx%d at (%d, %d) exceeds input "
                         "%dx%d" % (th, tw, y0, x0, H, W))
    return data[..., y0:y0 + th, x0:x0 + tw]


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    """Slice one axis."""
    axis = axis % data.dim()
    ix = [slice(None)] * data.dim()
    ix[axis] = slice(begin, end)
    return data[tuple(ix)]


@register("SwapAxis", aliases=("swapaxes",))
def swapaxes(data, dim1=0, dim2=0):
    """Swap two axes."""
    return data.transpose(dim1, dim2)


@register("Concat", num_inputs=None, aliases=("concat",))
def concat(*data, dim=1, num_args=None):
    """Concatenate along ``dim``."""
    return torch.cat(data, dim=dim)


@register("stack", num_inputs=None)
def stack(*data, axis=0, num_args=None):
    """Stack along a new axis ``axis``."""
    return torch.stack(data, dim=axis)


@register("SliceChannel", num_inputs=1, aliases=("split",),
          num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)))
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """Split into ``num_outputs`` equal chunks along ``axis``, one output
    each; ``squeeze_axis`` drops that axis from every chunk."""
    num_outputs = int(num_outputs)
    if data.shape[axis] % num_outputs:
        raise ValueError("SliceChannel: axis %d of length %d does not "
                         "split into %d equal parts"
                         % (axis, data.shape[axis], num_outputs))
    parts = torch.chunk(data, num_outputs, dim=axis)
    if squeeze_axis:
        parts = tuple(p.squeeze(axis) for p in parts)
    return tuple(parts)


@register("where", num_inputs=3)
def where(condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y``; a 1-d condition
    selects whole rows of ``x``."""
    if condition.dim() == 1 and x.dim() > 1:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)


@register("squeeze")
def squeeze(data, axis=None):
    """Drop the axes of length 1 (all of them, or those of ``axis``)."""
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return data.squeeze(tuple(a % data.dim() for a in axes))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("add_n", num_inputs=None,
          aliases=("ElementWiseSum", "element_wise_sum"))
def add_n(*args, num_args=None):
    """The sum of the arrays, left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("khatri_rao", num_inputs=None)
def khatri_rao(*args, num_args=None):
    """The column-wise Khatri-Rao product of matrices with equal column
    counts."""
    out = args[0]
    for b in args[1:]:
        out = torch.einsum("ir,jr->ijr", out, b).reshape(-1, out.shape[1])
    return out


# ----------------------------------------------------------------- linalg

def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


@register("linalg_gemm", num_inputs=3)
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    """``alpha·op(A)·op(B) + beta·C``."""
    return alpha * (_t(A, transpose_a) @ _t(B, transpose_b)) + beta * C


@register("linalg_gemm2", num_inputs=2)
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    """``alpha·op(A)·op(B)``."""
    return alpha * (_t(A, transpose_a) @ _t(B, transpose_b))


@register("linalg_potrf")
def linalg_potrf(A):
    """The lower Cholesky factor of the symmetric positive definite
    ``A``."""
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(A):
    """``A⁻¹`` of the symmetric positive definite ``A``, through its
    Cholesky factor: ``L⁻ᵀ·L⁻¹``."""
    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype,
                    device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


@register("linalg_trsm", num_inputs=2)
def linalg_trsm(A, B, transpose=False, rightside=False, alpha=1.0):
    """``X`` with ``op(A)·X = alpha·B`` (``X·op(A)`` with ``rightside``)
    for the lower triangle of ``A``."""
    return torch.linalg.solve_triangular(_t(A, transpose), alpha * B,
                                         upper=bool(transpose),
                                         left=not rightside)


@register("linalg_trmm", num_inputs=2)
def linalg_trmm(A, B, transpose=False, rightside=False, alpha=1.0):
    """``alpha·op(A)·B`` (``alpha·B·op(A)`` with ``rightside``)."""
    a = _t(A, transpose)
    return alpha * (B @ a if rightside else a @ B)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    """The sum of the logarithms of the diagonal."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source positions of an axis of length ``n`` padded by ``lo`` and
    ``hi``: clamped (``edge``) or mirrored without repeating the border
    (``reflect``, numpy's), any number of times over."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    return (n - 1) - ((i.abs() % period) - (n - 1)).abs()


@register("Pad", aliases=("pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """Pad every axis: ``pad_width`` is the flat ``2*ndim`` tuple
    ``(before_0, after_0, before_1, ...)``; ``mode`` is ``constant``
    (with ``constant_value``), ``edge`` or ``reflect``."""
    pw = tuple(int(p) for p in pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
        return F.pad(data, flat, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %s" % mode)
    out = data
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            out = out.index_select(axis, _pad_index(
                data.shape[axis], lo, hi, mode, data.device))
    return out
