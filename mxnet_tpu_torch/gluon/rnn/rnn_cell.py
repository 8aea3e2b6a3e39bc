"""Gluon recurrent cells.

The port's counterpart of the reference's ``gluon/rnn/rnn_cell.py`` (and
of MXNet's ``python/mxnet/gluon/rnn/rnn_cell.py``): ``RecurrentCell``
with ``begin_state`` and ``unroll``, ``RNNCell``, ``LSTMCell``,
``GRUCell``, ``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
``ResidualCell`` and ``BidirectionalCell``, with the reference's
parameter names and gate orders (LSTM i, f, c, o; GRU r, z, n). A step
is a few ``nd`` ops (``FullyConnected``, ``SliceChannel``,
``Activation``), recorded by the autograd tape like any other.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "HybridRecurrentCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Normalize inputs to a list of (N, C) steps or a merged tensor
    (reference: rnn_cell.py _format_sequence)."""
    assert layout in ("TNC", "NTC")
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        in_list = list(inputs)
        if merge:
            merged = nd.stack(*in_list, axis=axis)
            return merged, axis
        return in_list, axis
    if length is None:
        length = inputs.shape[axis]
    if merge:
        return inputs, axis
    steps = [nd.squeeze(s, axis=axis)
             for s in nd.split(inputs, num_outputs=length, axis=axis)]
    return steps, axis


class RecurrentCell(HybridBlock):
    """Abstract recurrent cell (reference: rnn_cell.py RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children:
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (reference: rnn_cell.py begin_state)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name="%sbegin_state_%d" % (self._prefix,
                                                    self._init_counter),
                         **info) if "name" in _fn_params(func) else \
                func(**info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell over ``length`` steps (reference: rnn_cell.py
        unroll)."""
        self.reset()
        inputs, axis = _format_sequence(length, inputs, layout, False)
        if begin_state is None:
            batch_size = inputs[0].shape[0]
            begin_state = self.begin_state(batch_size=batch_size)

        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)

        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


def _fn_params(func):
    import inspect
    try:
        return inspect.signature(func).parameters
    except (TypeError, ValueError):
        return {}


HybridRecurrentCell = RecurrentCell  # later-era alias


class RNNCell(RecurrentCell):
    """Elman cell (reference: rnn_cell.py:362 RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer as init_mod
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=init_mod.Zero(),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=init_mod.Zero(),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    @property
    def _gate_names(self):
        return ("",)

    def _alias(self):
        return "rnn"

    def shape_update(self, inputs, states):
        self.i2h_weight.shape = (self._hidden_size, inputs.shape[1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(RecurrentCell):
    """(reference: rnn_cell.py:408 LSTMCell). Gate order i,f,g,o."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer as init_mod
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init=init_mod.Zero(),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init=init_mod.Zero(),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def _alias(self):
        return "lstm"

    def shape_update(self, inputs, states):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4)
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = F.Activation(slice_gates[2], act_type="tanh")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    """(reference: rnn_cell.py:469 GRUCell). Gate order r,z,n (cuDNN)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer as init_mod
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,), init=init_mod.Zero(),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,), init=init_mod.Zero(),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def _alias(self):
        return "gru"

    def shape_update(self, inputs, states):
        self.i2h_weight.shape = (3 * self._hidden_size, inputs.shape[1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (reference: rnn_cell.py SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]

    def forward(self, inputs, states):
        return self.__call__(inputs, states)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class _ModifierCell(RecurrentCell):
    """Base for cells wrapping another cell (reference: rnn_cell.py
    ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias() + "_",
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(RecurrentCell):
    """Apply dropout on input (reference: rnn_cell.py DropoutCell)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, float)
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states


class ZoneoutCell(_ModifierCell):
    """Zoneout regularization (reference: rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. Apply zoneout to " \
            "the cells underneath instead."
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: nd.Dropout(nd.ones_like(like), p=p)  # noqa
        prev_output = self._prev_output if self._prev_output is not None \
            else nd.zeros_like(next_output)
        output = nd.where(mask(self.zoneout_outputs, next_output),
                          next_output, prev_output) \
            if self.zoneout_outputs > 0.0 else next_output
        states = [nd.where(mask(self.zoneout_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0.0 else next_states
        self._prev_output = output
        return output, states

    def forward(self, inputs, states):
        return self.__call__(inputs, states)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class ResidualCell(_ModifierCell):
    """Residual connection around a cell (reference: rnn_cell.py
    ResidualCell)."""

    def _alias(self):
        return "residual"

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def forward(self, inputs, states):
        return self.__call__(inputs, states)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class BidirectionalCell(RecurrentCell):
    """Run two cells over both directions (reference: rnn_cell.py
    BidirectionalCell:998-era)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _format_sequence(length, inputs, layout, False)
        if begin_state is None:
            batch_size = inputs[0].shape[0]
            begin_state = self.begin_state(batch_size=batch_size)

        states = begin_state
        l_cell, r_cell = self._children
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)

        outputs = [nd.concat(l_o, r_o, dim=1) for l_o, r_o in
                   zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError
