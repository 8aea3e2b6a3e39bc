"""Symbolic recurrent cells, over the port's Symbol.

The port's counterpart of the reference's ``rnn/rnn_cell.py`` (and of
MXNet's ``python/mxnet/rnn/rnn_cell.py``): ``RNNParams``,
``BaseRNNCell`` with ``begin_state`` and ``unroll``, ``RNNCell``,
``LSTMCell``, ``GRUCell``, ``FusedRNNCell`` (``unfuse``,
``pack_weights`` / ``unpack_weights``) and the modifiers
``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
``ResidualCell`` and ``BidirectionalCell``. The same cell code builds
the same graph as the reference: parameter names (``<prefix>i2h_weight``
...), node names, gate orders and state layouts are the reference's, so
Symbol JSON, checkpoints and ``unpack_weights`` round trips move between
the two packages.

``FusedRNNCell`` emits one ``RNN`` op (cuDNN's RNN on the card,
``ops/rnn_op.py``); the per-step cells build one graph per unrolled
length, which ``BucketingModule`` binds once per bucket. The packed
layout is described once, by ``FusedRNNCell._packed_segments``.
"""
from __future__ import annotations

from .. import symbol
from .. import initializer as init_mod
from ..ops.rnn_op import rnn_param_size

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "RNNParams"]

# gate-name suffixes per mode, in the packed (cuDNN) order
_GATES = {"rnn_relu": ("",), "rnn_tanh": ("",),
          "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}

_MODIFIED_ERR = ("this cell has been wrapped by a modifier (Dropout/Zoneout/"
                 "Residual); drive the modifier, not the wrapped cell")


class RNNParams(object):
    """Lazily-created, shareable weight Variables (reference:
    rnn_cell.py:78). Two cells given the same RNNParams share weights."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        try:
            return self._params[full]
        except KeyError:
            v = symbol.Variable(full, **kwargs)
            self._params[full] = v
            return v


def _as_step_inputs(inputs, length, layout, input_prefix=""):
    """Normalize unroll() input forms to a per-step symbol list.

    Accepts None (auto Variables), one [N,T,C]/[T,N,C] symbol (split on the
    time axis), or an explicit list of per-step symbols.
    """
    if inputs is None:
        return [symbol.Variable("%st%d_data" % (input_prefix, t))
                for t in range(length)]
    if isinstance(inputs, symbol.Symbol):
        if len(inputs.list_outputs()) != 1:
            raise ValueError(
                "unroll needs a single-output symbol to split over time; "
                "pass a list of per-step symbols instead")
        t_axis = layout.find("T")
        return list(symbol.SliceChannel(inputs, axis=t_axis,
                                        num_outputs=length, squeeze_axis=1))
    inputs = list(inputs)
    if len(inputs) != length:
        raise ValueError("unroll got %d inputs for length %d"
                         % (len(inputs), length))
    return inputs


def _merge_time(outputs, t_axis=1):
    """Stack per-step outputs into one symbol with time at ``t_axis``
    (axis 1 = NTC, axis 0 = TNC) so a stacked layer can re-split what the
    previous layer merged under the same layout."""
    return symbol.Concat(*[symbol.expand_dims(o, axis=t_axis)
                           for o in outputs], dim=t_axis)


class BaseRNNCell(object):
    """Stepping/unrolling interface shared by every cell (reference:
    rnn_cell.py:108)."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params
        self._modified = False
        self.reset()

    def reset(self):
        """Forget step counters so the cell can build a fresh graph."""
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        """One time step: (input symbol, state symbols) -> (output, states)."""
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        """Per-state dicts: shape (0 = batch wildcard) and layout."""
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.Variable, **kwargs):
        """Create initial-state symbols (reference: rnn_cell.py begin_state).
        With the default func they are zero-initialized Variables whose batch
        dim resolves at bind time."""
        if self._modified:
            raise AssertionError(_MODIFIED_ERR)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is symbol.Variable:
                kw = {k: info[k] for k in ("shape", "__layout__")
                      if info and info.get(k)}
                states.append(func(name, init=init_mod.Zero(), **kw))
            else:
                states.append(func(name=name, **(info or {})))
        return states

    # --- packed <-> per-gate weight views -------------------------------
    def _gate_param_names(self, group):
        return [("%s%s%s_weight" % (self._prefix, group, g),
                 "%s%s%s_bias" % (self._prefix, group, g))
                for g in self._gate_names]

    def unpack_weights(self, args):
        """Explode fused i2h/h2h tensors into per-gate entries (reference:
        rnn_cell.py unpack_weights; inverse of :meth:`pack_weights`)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            w = args.pop("%s%s_weight" % (self._prefix, group))
            b = args.pop("%s%s_bias" % (self._prefix, group))
            for j, (wname, bname) in enumerate(self._gate_param_names(group)):
                args[wname] = w[j * h:(j + 1) * h].copy()
                args[bname] = b[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Concatenate per-gate entries back into fused tensors."""
        from .. import ndarray as nd
        args = dict(args)
        if not self._gate_names:
            return args
        for group in ("i2h", "h2h"):
            names = self._gate_param_names(group)
            args["%s%s_weight" % (self._prefix, group)] = \
                nd.concatenate([args.pop(w) for w, _ in names])
            args["%s%s_bias" % (self._prefix, group)] = \
                nd.concatenate([args.pop(b) for _, b in names])
        return args

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Unroll `length` steps into a symbol graph (reference:
        rnn_cell.py unroll)."""
        self.reset()
        inputs = _as_step_inputs(inputs, length, layout, input_prefix)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        outputs = []
        for t in range(length):
            out, states = self(inputs[t], states)
            outputs.append(out)
        if merge_outputs:
            outputs = _merge_time(outputs, max(layout.find("T"), 0))
        return outputs, states


def _linear(name, data, weight, bias, num_hidden):
    """Gate projection: one FullyConnected."""
    return symbol.FullyConnected(data=data, weight=weight, bias=bias,
                                 num_hidden=num_hidden, name=name)


class RNNCell(BaseRNNCell):
    """Vanilla Elman cell: h' = act(W_i x + W_h h) (reference:
    rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        p = self.params
        self._iW, self._iB = p.get("i2h_weight"), p.get("i2h_bias")
        self._hW, self._hB = p.get("h2h_weight"), p.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        n = "%st%d_" % (self._prefix, self._counter)
        pre = _linear(n + "i2h", inputs, self._iW, self._iB,
                      self._num_hidden) \
            + _linear(n + "h2h", states[0], self._hW, self._hB,
                      self._num_hidden)
        out = symbol.Activation(pre, act_type=self._activation,
                                name=n + "out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM, gate order i,f,c,o (reference: rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        p = self.params
        self._iW = p.get("i2h_weight")
        self._hW = p.get("h2h_weight")
        # forget-gate bias offset lives in the initializer so a fresh model
        # starts remembering (reference: LSTMBias)
        self._iB = p.get("i2h_bias",
                         init=init_mod.LSTMBias(forget_bias=forget_bias))
        self._hB = p.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        n = "%st%d_" % (self._prefix, self._counter)
        h = self._num_hidden
        pre = _linear(n + "i2h", inputs, self._iW, self._iB, 4 * h) \
            + _linear(n + "h2h", states[0], self._hW, self._hB, 4 * h)
        gi, gf, gc, go = symbol.SliceChannel(pre, num_outputs=4,
                                             name=n + "slice")
        i = symbol.Activation(gi, act_type="sigmoid", name=n + "i")
        f = symbol.Activation(gf, act_type="sigmoid", name=n + "f")
        c_tilde = symbol.Activation(gc, act_type="tanh", name=n + "c")
        o = symbol.Activation(go, act_type="sigmoid", name=n + "o")
        c = f * states[1] + i * c_tilde
        h_out = o * symbol.Activation(c, act_type="tanh", name=n + "state")
        return h_out, [h_out, c]


class GRUCell(BaseRNNCell):
    """GRU, gate order r,z,o (reference: rnn_cell.py:469)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        p = self.params
        self._iW, self._iB = p.get("i2h_weight"), p.get("i2h_bias")
        self._hW, self._hB = p.get("h2h_weight"), p.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        n = "%st%d_" % (self._prefix, self._counter)
        h_prev = states[0]
        xi = _linear(n + "i2h", inputs, self._iW, self._iB,
                     3 * self._num_hidden)
        hi = _linear(n + "h2h", h_prev, self._hW, self._hB,
                     3 * self._num_hidden)
        xr, xz, xn = symbol.SliceChannel(xi, num_outputs=3,
                                         name=n + "i2h_slice")
        hr, hz, hn = symbol.SliceChannel(hi, num_outputs=3,
                                         name=n + "h2h_slice")
        r = symbol.Activation(xr + hr, act_type="sigmoid", name=n + "r_act")
        z = symbol.Activation(xz + hz, act_type="sigmoid", name=n + "z_act")
        cand = symbol.Activation(xn + r * hn, act_type="tanh",
                                 name=n + "h_act")
        h_new = (1.0 - z) * cand + z * h_prev
        return h_new, [h_new]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer fused cell over the RNN op (reference: rnn_cell.py:536).

    One ``RNN`` op (ops/rnn_op.py): cuDNN's RNN on the card, torch's on
    the CPU.
    All weights live in ONE packed Variable in the cuDNN layout.
    """

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix="%s_" % mode if prefix is None else prefix,
                         params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get(
            "parameters", init=init_mod.FusedRNN(
                None, num_hidden, num_layers, mode, bidirectional,
                forget_bias))

    @property
    def state_info(self):
        first = self._num_layers * len(self._directions)
        n_states = 2 if self._mode == "lstm" else 1
        return [{"shape": (first, 0, self._num_hidden),
                 "__layout__": "LNC"}] * n_states

    @property
    def _gate_names(self):
        return list(_GATES[self._mode])

    @property
    def _num_gates(self):
        return len(_GATES[self._mode])

    # --- packed layout: the single source of truth ----------------------
    def _packed_segments(self, input_size):
        """Yield ``(kind, name, rows, cols)`` for every segment of the packed
        vector in order — weights for all layers/directions first, then
        biases (the fused op's cuDNN-style convention, ops/rnn_op.py
        rnn_unpack_params). ``name`` is the per-gate parameter name."""
        h = self._num_hidden
        ndir = len(self._directions)
        for section in ("weight", "bias"):
            for layer in range(self._num_layers):
                in_sz = input_size if layer == 0 else h * ndir
                for d in self._directions:
                    for group, cols in (("i2h", in_sz), ("h2h", h)):
                        for gate in _GATES[self._mode]:
                            name = "%s%s%d_%s%s_%s" % (
                                self._prefix, d, layer, group, gate, section)
                            if section == "weight":
                                yield ("weight", name, h, cols)
                            else:
                                yield ("bias", name, h, 1)

    def _solve_input_size(self, total):
        """Invert rnn_param_size for the layer-0 input width."""
        h, g = self._num_hidden, self._num_gates
        ndir = len(self._directions)
        deeper = sum(ndir * g * h * (h * ndir + h + 2)
                     for _ in range(self._num_layers - 1))
        return (total - deeper) // (ndir * g * h) - h - 2

    def unpack_weights(self, args):
        args = dict(args)
        packed = args.pop("%sparameters" % self._prefix)
        in_sz = self._solve_input_size(packed.size)
        pos = 0
        for kind, name, rows, cols in self._packed_segments(in_sz):
            n = rows * cols
            seg = packed[pos:pos + n]
            args[name] = (seg.reshape((rows, cols)) if kind == "weight"
                          else seg).copy()
            pos += n
        if pos != packed.size:
            raise ValueError(
                "packed parameter vector has %d values; layout expects %d"
                % (packed.size, pos))
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd
        args = dict(args)
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        in_sz = w0.shape[1]
        chunks = [nd.reshape(args.pop(name), (-1,))
                  for _, name, _, _ in self._packed_segments(in_sz)]
        packed = nd.concatenate(chunks)
        expect = rnn_param_size(self._num_layers, in_sz, self._num_hidden,
                                self._mode, self._bidirectional)
        if packed.size != expect:
            raise ValueError("packed %d values, layout expects %d"
                             % (packed.size, expect))
        args["%sparameters" % self._prefix] = packed
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "the fused cell is a whole-sequence op; use unroll() (or "
            "unfuse() for a steppable stack)")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Emit ONE fused RNN op instead of a per-step graph."""
        self.reset()
        batch_major = layout.find("T") == 1
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != length:
                raise ValueError("unroll got %d inputs for length %d"
                                 % (len(inputs), length))
            inputs = _merge_time(list(inputs))
            batch_major = True
        elif inputs is None:
            inputs = symbol.Variable("%sdata" % input_prefix)
        if batch_major:
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)  # -> TNC

        if begin_state is None:
            begin_state = self.begin_state(
                func=lambda name, **kw: symbol.Variable(name))
        state_kw = {"state": begin_state[0]}
        if self._mode == "lstm":
            state_kw["state_cell"] = begin_state[1]

        out = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **state_kw)

        if not self._get_next_state:
            outputs, states = out, []
        else:
            outputs = out[0]
            states = [out[1], out[2]] if self._mode == "lstm" else [out[1]]
        if batch_major:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            t_axis = 1 if batch_major else 0
            outputs = list(symbol.SliceChannel(
                outputs, axis=t_axis, num_outputs=length, squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """Equivalent steppable stack of unrolled cells (reference:
        rnn_cell.py unfuse)."""
        factories = {
            "rnn_relu": lambda pfx: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pfx),
            "rnn_tanh": lambda pfx: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pfx),
            "lstm": lambda pfx: LSTMCell(self._num_hidden, prefix=pfx),
            "gru": lambda pfx: GRUCell(self._num_hidden, prefix=pfx),
        }
        make = factories[self._mode]
        stack = SequentialRNNCell()
        for layer in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, layer)),
                    make("%sr%d_" % (self._prefix, layer)),
                    output_prefix="%sbi_l%d_" % (self._prefix, layer)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, layer)))
            if self._dropout > 0 and layer + 1 < self._num_layers:
                stack.add(DropoutCell(
                    self._dropout,
                    prefix="%s_dropout%d_" % (self._prefix, layer)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Vertically stacked cells stepped together (reference: rnn_cell.py
    SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            if not cell._own_params:
                raise AssertionError(
                    "give params to the stack or to its cells, not both")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        if self._modified:
            raise AssertionError(_MODIFIED_ERR)
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        out_states = []
        pos = 0
        for cell in self._cells:
            if isinstance(cell, BidirectionalCell):
                raise TypeError("a bidirectional cell cannot be stepped "
                                "inside a sequential stack; unroll it")
            n = len(cell.state_info)
            inputs, new_s = cell(inputs, states[pos:pos + n])
            pos += n
            out_states.extend(new_s)
        return inputs, out_states

    def reset(self):
        super().reset()
        for cell in getattr(self, "_cells", []):
            cell.reset()


class DropoutCell(BaseRNNCell):
    """Stateless dropout-on-output step (reference: rnn_cell.py
    DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class _ModifierCell(BaseRNNCell):
    """Wraps a cell, delegating params/state; the wrapped cell is locked
    against direct use (reference: rnn_cell.py ModifierCell)."""

    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.Variable, **kwargs):
        if self._modified:
            raise AssertionError(_MODIFIED_ERR)
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(_ModifierCell):
    """Zoneout: randomly keep previous output/state (reference: rnn_cell.py
    ZoneoutCell; paper arXiv:1606.01305)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, FusedRNNCell):
            raise TypeError("zoneout needs per-step access: unfuse() the "
                            "fused cell first")
        if isinstance(base_cell, BidirectionalCell):
            raise TypeError("wrap the directional sub-cells with zoneout, "
                            "not the bidirectional composite")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        out, new_states = self.base_cell(inputs, states)

        def keep_mask(p, like):
            # Dropout of ones: 1/(1-p) with prob (1-p), else 0 — nonzero
            # means "take the new value"
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(out)
        if self.zoneout_outputs > 0.0:
            out = symbol.where(keep_mask(self.zoneout_outputs, out),
                               out, prev)
        if self.zoneout_states > 0.0:
            new_states = [
                symbol.where(keep_mask(self.zoneout_states, s_new), s_new,
                             s_old)
                for s_new, s_old in zip(new_states, states)]
        self.prev_output = out
        return out, new_states


class ResidualCell(_ModifierCell):
    """Adds the step input to the step output (reference: rnn_cell.py
    ResidualCell)."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return symbol.elemwise_add(out, inputs), states


class BidirectionalCell(BaseRNNCell):
    """Runs one cell forward and one backward over the sequence,
    concatenating outputs per step (reference: rnn_cell.py
    BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            if not (l_cell._own_params and r_cell._own_params):
                raise AssertionError(
                    "give params to the bidirectional composite or to its "
                    "sub-cells, not both")
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "a bidirectional cell consumes the whole sequence; use unroll()")

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        if self._modified:
            raise AssertionError(_MODIFIED_ERR)
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        inputs = _as_step_inputs(inputs, length, layout, input_prefix)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        fwd, bwd = self._cells
        n_fwd = len(fwd.state_info)
        f_out, f_states = fwd.unroll(length, inputs=inputs,
                                     begin_state=states[:n_fwd],
                                     layout=layout, merge_outputs=False)
        b_out, b_states = bwd.unroll(length,
                                     inputs=list(reversed(inputs)),
                                     begin_state=states[n_fwd:],
                                     layout=layout, merge_outputs=False)
        outputs = [
            symbol.Concat(f, b, dim=1,
                          name="%st%d" % (self._output_prefix, t))
            for t, (f, b) in enumerate(zip(f_out, reversed(b_out)))]
        if merge_outputs:
            outputs = _merge_time(outputs, max(layout.find("T"), 0))
        return outputs, f_states + b_states
