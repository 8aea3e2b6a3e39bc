"""The fused RNN op (RNN / LSTM / GRU, several layers, bidirectional).

The port's counterpart of the reference's ``ops/rnn_op.py``. The packed
parameter vector keeps the reference's (cuDNN's) layout: for each layer
and direction ``W_x (G*H, in)`` and ``W_h (G*H, H)``, then for each
layer and direction ``b_x (G*H)`` and ``b_h (G*H)``. Gate orders are
cuDNN's and torch's: LSTM i, f, g, o; GRU r, z, n, whose n gate takes
``r * (W_hn h + b_hn)``, as the reference's does.

The reference runs each layer and direction as a ``lax.scan``. Here each
layer is one call of torch's fused RNN (``torch._VF.lstm`` / ``gru`` /
``rnn_tanh`` / ``rnn_relu``, both directions in the call), which runs
on cuDNN on the card and on torch's own kernels on the CPU; the weights
handed to it are views of the packed vector, so gradients flow back
into it. The layers run one at a time, as the reference loops over
them, so that the dropout between layers (``p``, training only) draws
its mask from the port's generator (``random.torch_generator``), not
from cuDNN's dropout state.

A float32 op runs in full float32: cuDNN's TF32 is off in the forward
and in the backward (``amp.conv_precision``), whatever the global
``torch.backends.cudnn.allow_tf32`` says when autograd runs the backward
(:class:`_GuardedLayer`). Under amp the data, the packed
parameters and the states are cast to the compute dtype, as in the
reference. ``lstm_state_clip_min`` / ``_max`` are accepted and ignored,
as the reference's op ignores them.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import amp
from .registry import register

__all__ = ["rnn_param_size", "rnn_unpack_params"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False):
    """Length of the packed parameter vector."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_sz + state_size + 2)
    return size


def rnn_unpack_params(params, num_layers, input_size, state_size, mode,
                      bidirectional=False):
    """Views of the packed vector: ``([(Wx, Wh)], [(bx, bh)])`` per layer
    and direction, in the packed order."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    G = gates * state_size
    weights, biases = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        for _ in range(dirs):
            wx = params[off:off + G * in_sz].reshape(G, in_sz)
            off += G * in_sz
            wh = params[off:off + G * state_size].reshape(G, state_size)
            off += G * state_size
            weights.append((wx, wh))
    for layer in range(num_layers):
        for _ in range(dirs):
            bx = params[off:off + G]
            off += G
            bh = params[off:off + G]
            off += G
            biases.append((bx, bh))
    return weights, biases


def _fused(mode, x, h0, c0, flat, bidirectional, train):
    """One layer, both directions, through torch's fused RNN: (output,
    h_last, c_last or None), the final states (dirs, N, H). ``train``
    keeps cuDNN's state for a backward; its own dropout stays 0."""
    if mode == "lstm":
        return torch._VF.lstm(x, (h0, c0), flat, True, 1, 0.0, train,
                              bidirectional, False)
    fused = {"gru": torch._VF.gru, "rnn_tanh": torch._VF.rnn_tanh,
             "rnn_relu": torch._VF.rnn_relu}[mode]
    out, h_last = fused(x, h0, flat, True, 1, 0.0, train, bidirectional,
                        False)
    return out, h_last, None


class _GuardedLayer(torch.autograd.Function):
    """:func:`_fused` with its backward, too, inside
    :func:`amp.conv_precision`. Autograd would run cuDNN's RNN backward
    after the forward's scope has closed, reading the global TF32 switch
    (on by default); here the forward records its own graph on detached
    inputs, and the backward differentiates that graph inside the guard,
    so cuDNN's backward runs once, on the forward's saved state. There
    is no second derivative (cuDNN's RNN backward has none)."""

    @staticmethod
    def forward(ctx, mode, bidirectional, x, h0, c0, *flat):
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip((x, h0, c0, *flat),
                                  ctx.needs_input_grad[2:])]
        with torch.enable_grad(), amp.conv_precision(x.dtype):
            outs = _fused(mode, ins[0], ins[1], ins[2], ins[3:],
                          bidirectional, True)
        outs = [o for o in outs if o is not None]
        ctx.graph = (ins, outs)
        ctx.dtype = x.dtype
        return tuple(o.detach() for o in outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        ins, outs = ctx.graph
        del ctx.graph
        wanted = [t for t in ins if t is not None and t.requires_grad]
        with amp.conv_precision(ctx.dtype):
            got = iter(torch.autograd.grad(outs, wanted, grads,
                                           allow_unused=True))
        return (None, None) + tuple(
            next(got) if t is not None and t.requires_grad else None
            for t in ins)


def _layer(mode, x, h0, c0, flat, bidirectional, train):
    """One layer, both directions: :func:`_fused` under the precision
    guard, through :class:`_GuardedLayer` when a gradient may be asked
    for (``train``)."""
    if not train:
        with amp.conv_precision(x.dtype):
            return _fused(mode, x, h0, c0, flat, bidirectional, False)
    outs = _GuardedLayer.apply(mode, bidirectional, x, h0, c0, *flat)
    return (*outs, None) if mode != "lstm" else outs


def _meta(data, parameters, state, state_cell=None, state_size=None,
          num_layers=1, mode="lstm", bidirectional=False, p=0.0,
          state_outputs=False, lstm_state_clip_min=None,
          lstm_state_clip_max=None, _is_train=False):
    """Output shapes without running the recurrence."""
    T, N, _ = data.shape
    H, dirs = int(state_size), 2 if bidirectional else 1
    out = data.new_empty((T, N, H * dirs))
    if not state_outputs:
        return out
    h = data.new_empty((int(num_layers) * dirs, N, H))
    return (out, h, data.new_empty(h.shape)) if mode == "lstm" else (out, h)


@register("RNN", num_inputs=None, aliases=("rnn",), meta_fn=_meta,
          num_outputs=lambda attrs: (
              1 if not attrs.get("state_outputs") else
              (3 if attrs.get("mode", "lstm") == "lstm" else 2)))
def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, _is_train=False):
    """Fused multi-layer RNN. ``data`` is (T, N, input_size) and
    ``state`` (and ``state_cell``, LSTM) (layers*dirs, N, H); returns
    the output (T, N, H*dirs) and, with ``state_outputs``, the final
    states (h, and c for an LSTM)."""
    if mode not in _GATES:
        raise ValueError("unknown RNN mode %r" % (mode,))
    T, N, input_size = data.shape
    H, L = int(state_size), int(num_layers)
    dirs = 2 if bidirectional else 1
    data, parameters = amp.cast_compute(data, parameters)
    state = amp.cast_compute(state)
    if state_cell is not None:
        state_cell = amp.cast_compute(state_cell)
    elif mode == "lstm":
        state_cell = torch.zeros_like(state)
    weights, biases = rnn_unpack_params(parameters, L, input_size, H, mode,
                                        bidirectional)
    # cuDNN keeps what its backward needs only in training mode: taken
    # whenever a gradient may be asked for, whatever ``_is_train`` says
    # (which decides the dropout alone)
    for_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (data, parameters, state, state_cell))
    gen = None
    x = data
    h_finals, c_finals = [], []
    for layer in range(L):
        flat = []
        for d in range(dirs):
            idx = layer * dirs + d
            flat += [*weights[idx], *biases[idx]]
        rows = slice(layer * dirs, (layer + 1) * dirs)
        x, h_last, c_last = _layer(
            mode, x, state[rows],
            state_cell[rows] if mode == "lstm" else None, flat,
            bool(bidirectional), for_grad)
        h_finals.append(h_last)
        if c_last is not None:
            c_finals.append(c_last)
        if p > 0.0 and _is_train and layer < L - 1:
            if gen is None:
                from .. import random as _random
                gen = _random.torch_generator(x.device)
            keep = 1.0 - p
            u = torch.rand(x.shape, device=x.device, generator=gen)
            x = torch.where(u < keep, x / keep, torch.zeros_like(x))
    if not state_outputs:
        return x
    h_out = torch.cat(h_finals)
    if mode == "lstm":
        return x, h_out, torch.cat(c_finals)
    return x, h_out
