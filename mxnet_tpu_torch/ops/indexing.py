"""Indexing and ordering ops: ``Embedding``, ``take``, ``batch_take``,
``one_hot``, ``pick``, ``gather_nd``, ``sort``, ``argsort`` and
``topk``.

The port's counterpart of the reference's ``ops/indexing.py``, with
``jnp.take`` / ``jnp.take_along_axis``'s treatment of indices that lie
outside the axis:

* ``Embedding``, ``pick``, ``batch_take``: a negative index counts from
  the end once (-1 is the last), and an index still outside the axis
  gives NaN; the gradient of such an entry is dropped.
* ``take``: ``clip`` (and ``raise``, which the reference treats as
  ``clip``) clamps into the axis, ``wrap`` takes the index modulo its
  length.
* ``one_hot``: an index outside ``[0, depth)`` gives a row of
  ``off_value``.
* ``gather_nd``: a negative index counts from the end once, then every
  index is clamped into its axis; an entry that needed the clamp passes
  no gradient back.

No index outside its axis reaches ``torch.gather``, ``index_select`` or
``F.embedding``: each is clamped first and the result masked with
``torch.where`` (on the card an out-of-range index would be a device-side
assert, which ends the process's CUDA context). Ids and indices may
arrive as floats (a float32 batch) and are truncated to integers;
indices come back as float32.

The ordering ops follow the reference's ties: ascending ``sort`` /
``argsort`` are stable, and descending ones are the *flip* of the
stable ascending order (equal values in reverse index order);
``topk`` takes equal values lower index first, as ``lax.top_k`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ndarray.ndarray import to_torch_dtype
from .registry import register

__all__ = []


def _in_axis(index, n):
    """``(safe, valid)``: ``index`` as int64 with a negative index counted
    from the end once, clamped into ``[0, n)``, and where it was in
    range."""
    idx = index.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return idx.clamp(0, max(n - 1, 0)), valid


def _nan_where(valid, values):
    """``values`` where ``valid`` (broadcast from the left), else NaN."""
    v = valid.reshape(valid.shape + (1,) * (values.dim() - valid.dim()))
    return torch.where(v, values, values.new_tensor(float("nan")))


@register("Embedding", num_inputs=2, aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32"):
    """Rows of ``weight`` by id; an id outside the table (after one wrap
    of a negative id) gives a row of NaN."""
    idx, valid = _in_axis(data, weight.shape[0])
    return _nan_where(valid, F.embedding(idx, weight))


@register("take", num_inputs=2)
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` by ``indices`` (the indices' shape
    replaces that axis): ``clip`` / ``raise`` clamp the index, ``wrap``
    takes it modulo the axis."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _take_along(data, idx, axis):
    """``jnp.take_along_axis``: one element per position along ``axis``,
    NaN where the index lies outside it."""
    safe, valid = _in_axis(idx, data.shape[axis])
    return _nan_where(valid, torch.gather(data, axis, safe))


@register("batch_take", num_inputs=2)
def batch_take(a, indices):
    """``a[i, indices[i]]`` for every row ``i``."""
    return _take_along(a, indices.reshape(-1, 1), 1).squeeze(1)


@register("one_hot")
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """A trailing axis of ``depth``: ``on_value`` at the index, else
    ``off_value`` (the whole row for an index outside ``[0, depth)``)."""
    idx = indices.to(torch.int64).unsqueeze(-1)
    hot = idx == torch.arange(int(depth), device=indices.device)
    dt = to_torch_dtype(dtype)
    return torch.where(hot, torch.tensor(on_value, dtype=dt,
                                         device=indices.device),
                       torch.tensor(off_value, dtype=dt,
                                    device=indices.device))


@register("pick", num_inputs=2)
def pick(data, index, axis=-1, keepdims=False):
    """One element per position along ``axis``, chosen by ``index``: the
    backbone of cross-entropy. An index outside the axis (after one wrap
    of a negative index) gives NaN."""
    axis = axis % data.dim()
    idx = index.to(torch.int64)
    if idx.dim() < data.dim():
        idx = idx.unsqueeze(axis)
    out = _take_along(data, idx, axis)
    return out if keepdims else out.squeeze(axis)


@register("gather_nd", num_inputs=2)
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``: the indices' first axis
    runs over the leading axes of ``data``."""
    idx, valid = [], True
    for i in range(indices.shape[0]):
        j, ok = _in_axis(indices[i], data.shape[i])
        idx.append(j)
        valid = ok & valid
    out = data[tuple(idx)]
    # a clamped index reads the edge but passes no gradient back
    valid = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    return torch.where(valid, out, out.detach())


def _ascending(data, axis):
    """Values and indices of a stable ascending sort along ``axis``."""
    return torch.sort(data, dim=axis, stable=True)


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    """Sorted along ``axis``; descending is the flip of ascending."""
    out = _ascending(data, axis)[0]
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True):
    """The indices that sort ``data`` along ``axis``, as float32;
    descending is the flip of the stable ascending order."""
    out = _ascending(data, axis)[1]
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch.float32)


@register("topk", num_outputs=lambda attrs: 2 if attrs.get(
    "ret_typ", "indices") == "both" else 1)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    """The ``k`` largest (``is_ascend``: smallest) elements along
    ``axis``, equal values lower index first: their values, indices
    (float32), a 0/1 mask in the data's dtype, or values and indices
    (``both``)."""
    axis = axis % data.dim()
    k = int(k)
    key = data if is_ascend else -data
    _, idx = torch.sort(key, dim=axis, stable=True)
    idx = idx.narrow(axis, 0, k)
    vals = torch.gather(data, axis, idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch.float32)
    if ret_typ == "mask":
        mask = torch.zeros_like(data)
        return mask.scatter(axis, idx, torch.ones_like(vals))
    return idx.to(torch.float32)
