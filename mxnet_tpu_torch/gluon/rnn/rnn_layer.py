"""Gluon's fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU``.

The port's counterpart of the reference's ``gluon/rnn/rnn_layer.py``
(MXNet's ``python/mxnet/gluon/rnn/rnn_layer.py``). Each layer and
direction owns ``l<k>_`` / ``r<k>_`` ``i2h_weight``, ``h2h_weight``,
``i2h_bias`` and ``h2h_bias``; every call packs them into the fused
op's vector (weights of every layer and direction, then the biases) and
runs ``nd.RNN``, cuDNN's RNN on the card, so gradients reach each
parameter through the concatenation. Biases start at zero whatever
initializer is passed, as in the reference. The input size may be left
0 and is set from the first input (``shape_update``).
"""
from __future__ import annotations

from ... import ndarray as nd
from ...ops.rnn_op import _GATES
from ..block import HybridBlock
from ..parameter import DeferredInitializationError

__all__ = ["RNN", "LSTM", "GRU"]


def _zero_init():
    from ... import initializer as init_mod
    return init_mod.Zero()


class _RNNLayer(HybridBlock):
    """(reference: rnn_layer.py _RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer

        # per-layer named params (reference rnn_layer.py naming: l0_i2h_*,
        # r0_* for the reverse direction), packed into the fused-op vector
        # at forward time
        gates = _GATES[mode]
        self._rnn_params = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * self._dir
            for d in range(self._dir):
                pfx = ("l%d_" if d == 0 else "r%d_") % layer
                quad = (
                    self.params.get(pfx + "i2h_weight",
                                    shape=(gates * hidden_size, in_sz),
                                    init=i2h_weight_initializer,
                                    allow_deferred_init=True),
                    self.params.get(pfx + "h2h_weight",
                                    shape=(gates * hidden_size, hidden_size),
                                    init=h2h_weight_initializer,
                                    allow_deferred_init=True),
                    self.params.get(pfx + "i2h_bias",
                                    shape=(gates * hidden_size,),
                                    init=_zero_init(),
                                    allow_deferred_init=True),
                    self.params.get(pfx + "h2h_bias",
                                    shape=(gates * hidden_size,),
                                    init=_zero_init(),
                                    allow_deferred_init=True),
                )
                self._rnn_params.append(quad)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _gates(self):
        return _GATES[self._mode]

    def shape_update(self, inputs, *states):
        input_size = inputs.shape[2]
        self._input_size = input_size
        gates = self._gates()
        for idx in range(self._dir):  # layer 0 (both directions)
            wx = self._rnn_params[idx][0]
            wx.shape = (gates * self._hidden_size, input_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """(reference: rnn_layer.py begin_state)."""
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info.update(kwargs)
            states.append(func(**info))
        return states

    def __call__(self, inputs, states=None):
        """Accept optional states (reference: rnn_layer.py forward)."""
        return super().__call__(inputs, *([states] if states is not None
                                          else []))

    def forward(self, inputs, states=None):
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, nd.NDArray):
            states = [states]
        for info, state in zip(self.state_info(batch_size), states):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s."
                    % (str(info["shape"]), str(state.shape)))
        try:
            params = self._packed_params()
        except DeferredInitializationError:
            self.shape_update(
                inputs if self._layout == "TNC"
                else nd.swapaxes(inputs, 0, 1))
            for quad in self._rnn_params:
                for p in quad:
                    p._finish_deferred_init()
            params = self._packed_params()
        out = self._forward_kernel(inputs, params, states)
        return out[0] if skip_states else out

    def _packed_params(self):
        """Pack per-layer params into the fused-op vector (weights of all
        layers/directions, then biases — ops/rnn_op.py layout)."""
        flats = [nd.reshape(q[i].data(), (-1,))
                 for q in self._rnn_params for i in (0, 1)]
        flats += [q[i].data() for q in self._rnn_params for i in (2, 3)]
        return nd.concat(*flats, dim=0)

    def _forward_kernel(self, inputs, params, states):
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, 0, 1)
        if self._mode == "lstm":
            h, c = states
            ret = nd.RNN(inputs, params, h, c, state_size=self._hidden_size,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._dir == 2, p=self._dropout,
                         state_outputs=True)
            outputs, h_out, c_out = ret
            new_states = [h_out, c_out]
        else:
            ret = nd.RNN(inputs, params, states[0],
                         state_size=self._hidden_size,
                         num_layers=self._num_layers, mode=self._mode,
                         bidirectional=self._dir == 2, p=self._dropout,
                         state_outputs=True)
            outputs, h_out = ret
            new_states = [h_out]
        if self._layout == "NTC":
            outputs = nd.swapaxes(outputs, 0, 1)
        return outputs, new_states

    def hybrid_forward(self, F, inputs, *args, **kwargs):
        raise NotImplementedError  # forward() fully overridden


class RNN(_RNNLayer):
    """Elman RNN layer (reference: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class LSTM(_RNNLayer):
    """LSTM layer (reference: rnn_layer.py LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]


class GRU(_RNNLayer):
    """GRU layer (reference: rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size)}]
