"""Sequence ops over time-major data (TNC), with optional per-batch
lengths.

The port's counterpart of the reference's ``ops/sequence.py``
(``SequenceLast``, ``SequenceMask``, ``SequenceReverse``): axis 0 is
time and axis 1 the batch; ``sequence_length`` holds one length per
batch element and is read only with ``use_sequence_length``. Each is a
gather or a select with static shapes, so it differentiates through
``torch.autograd`` with respect to ``data``.
"""
from __future__ import annotations

import torch

from .registry import register


def _lengths(sequence_length, ndim):
    """The lengths as int64, shaped to broadcast over (T, N, ...)."""
    return sequence_length.to(torch.int64).reshape((1, -1) + (1,) * (ndim - 2))


@register("SequenceLast", num_inputs=None, aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False):
    """The last valid step of each batch element."""
    if not use_sequence_length or sequence_length is None:
        return data[-1]
    idx = (_lengths(sequence_length, data.dim()) - 1).clamp(
        0, data.shape[0] - 1)
    return torch.take_along_dim(data, idx.expand((1,) + data.shape[1:]),
                                dim=0)[0]


@register("SequenceMask", num_inputs=None, aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0):
    """``value`` at the steps past each element's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    t = torch.arange(data.shape[0], device=data.device).reshape(
        (-1, 1) + (1,) * (data.dim() - 2))
    keep = t < _lengths(sequence_length, data.dim())
    return torch.where(keep, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse", num_inputs=None, aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False):
    """Reverse along time, within each element's length (the steps past
    it stay where they are)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    t = torch.arange(T, device=data.device).reshape(-1, 1)
    L = sequence_length.to(torch.int64).reshape(1, -1)
    src = torch.where(t < L, L - 1 - t, t)
    src = src.reshape((T, -1) + (1,) * (data.dim() - 2))
    return torch.take_along_dim(data, src.expand(data.shape), dim=0)
