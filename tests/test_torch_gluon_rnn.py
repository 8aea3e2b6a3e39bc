"""The port's ``gluon.rnn`` against the reference's.

* the RNN cases of ``tests/test_gluon.py`` (the fused LSTM layer equal
  to an unrolled ``LSTMCell`` with the same weights, the GRU and RNN
  layers, a sequential stack with a residual cell), run in both
  packages on the same numpy-drawn weights and inputs;
* parameter names of the fused layers and the cells equal the
  reference's for the same construction;
* the fused layers in every mode, one and two layers, one and two
  directions: outputs, final states and the gradients of every
  parameter, the input and the initial states under ``autograd``;
* the cells (``RNNCell``, ``LSTMCell``, ``GRUCell``) and the modifiers
  (``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``,
  ``ResidualCell``, ``BidirectionalCell``) unrolled in both packages;
* the word language model of ``examples/word_language_model.py`` at a
  small width with the upstream example's tied decoder (``Dense(...,
  params=embedding.params)``): 3 truncated-BPTT steps with ``detach``
  between segments, ``clip_global_norm`` and ``Trainer('sgd')``.

Tolerances are 1e-5 of max(1, the largest magnitude) of each array:
the same f32 recurrences summed in another order.
"""
import contextlib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = 1e-5


def _scope(pkg):
    return mt.device_scope("cpu") if pkg is mt else contextlib.nullcontext()


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _nd(pkg, x):
    return pkg.nd.array(x, ctx=pkg.cpu()) if pkg is mt else pkg.nd.array(x)


def _draw_params(block, seed=0):
    """Every parameter of ``block`` (initialized) from one numpy seed, in
    name order: {name: array}."""
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-0.5, 0.5, p.shape).astype(np.float32)
            for k, p in sorted(block.collect_params().items())}


def _set_params(block, values):
    for k, p in block.collect_params().items():
        p.set_data(values[k])


def _grads(block):
    return {k: p.grad().asnumpy() for k, p in block.collect_params().items()
            if p.grad_req != "null"}


def _build(pkg, make, x, seed=0):
    """``make(pkg)`` initialized (deferred shapes resolved by one call on
    ``x``) and given the seed's parameters."""
    block = make(pkg)
    if pkg is mt:
        block.initialize(mt.init.Zero(), ctx=mt.cpu())
    else:
        block.initialize(mx.init.Zero())
    block(_nd(pkg, x))
    return block


# ------------------------------------------------------------- fused layers

LAYERS = [(kind, layers, bidir)
          for kind in ("lstm", "gru", "rnn_tanh", "rnn_relu")
          for layers in (1, 2) for bidir in (False, True)]


def _layer(pkg, kind, layers, bidir, layout="TNC", dropout=0.0):
    rnn = pkg.gluon.rnn
    kw = dict(num_layers=layers, bidirectional=bidir, layout=layout,
              dropout=dropout, prefix="%s%d%d_" % (kind, layers, bidir))
    if kind == "lstm":
        return rnn.LSTM(6, **kw)
    if kind == "gru":
        return rnn.GRU(6, **kw)
    return rnn.RNN(6, activation=kind[4:], **kw)


@pytest.mark.parametrize("kind,layers,bidir", LAYERS)
def test_fused_layer_matches_reference(kind, layers, bidir):
    """Outputs, final states and every gradient of the fused layer
    against the reference's, from the same parameters and states."""
    rng = np.random.RandomState(1)
    T, N, C = 5, 3, 4
    x = rng.randn(T, N, C).astype(np.float32)
    dirs = 2 if bidir else 1
    n_states = 2 if kind == "lstm" else 1
    states = [rng.randn(layers * dirs, N, 6).astype(np.float32)
              for _ in range(n_states)]
    head = rng.randn(T, N, 6 * dirs).astype(np.float32)
    runs = {}
    for pkg in (mx, mt):
        with _scope(pkg):
            layer = _build(pkg, lambda p: _layer(p, kind, layers, bidir), x)
            if pkg is mx:
                values = _draw_params(layer)
            assert sorted(layer.collect_params().keys()) == sorted(values)
            _set_params(layer, values)
            xs = _nd(pkg, x)
            xs.attach_grad()
            ss = [_nd(pkg, s) for s in states]
            for s in ss:
                s.attach_grad()
            with pkg.autograd.record():
                out, new = layer(xs, ss)
                loss = (out * _nd(pkg, head)).sum() + sum(
                    (s * s).sum() for s in new)
            loss.backward()
            runs[pkg] = (out.asnumpy(), [s.asnumpy() for s in new],
                         _grads(layer), xs.grad.asnumpy(),
                         [s.grad.asnumpy() for s in ss])
    (o_m, s_m, g_m, dx_m, ds_m), (o_t, s_t, g_t, dx_t, ds_t) = \
        runs[mx], runs[mt]
    _close(o_t, o_m, "output")
    for a, b in zip(s_t, s_m):
        _close(a, b, "final state")
    assert sorted(g_t) == sorted(g_m)
    for k in g_m:
        _close(g_t[k], g_m[k], "grad " + k)
    _close(dx_t, dx_m, "input grad")
    for a, b in zip(ds_t, ds_m):
        _close(a, b, "state grad")


def test_layer_parameter_names_and_ntc():
    """A 2-layer bidirectional LSTM in NTC: the reference's parameter
    names and shapes (deferred input size), and its output."""
    x = np.random.RandomState(2).randn(3, 4, 5).astype(np.float32)
    outs, names = {}, {}
    for pkg in (mx, mt):
        with _scope(pkg):
            layer = _build(pkg, lambda p: _layer(p, "lstm", 2, True, "NTC"),
                           x)
            if pkg is mx:
                values = _draw_params(layer)
            _set_params(layer, values)
            names[pkg] = {k: p.shape
                          for k, p in layer.collect_params().items()}
            outs[pkg] = layer(_nd(pkg, x)).asnumpy()
    assert names[mt] == names[mx]
    assert "lstm21_l0_i2h_weight" in names[mt]
    assert names[mt]["lstm21_r1_i2h_weight"] == (24, 12)
    _close(outs[mt], outs[mx], "NTC output")
    assert outs[mt].shape == (3, 4, 12)


def test_layer_biases_start_at_zero():
    """Biases are zero whatever initializer is passed, as in the
    reference."""
    with mt.device_scope("cpu"):
        layer = mt.gluon.rnn.LSTM(4, input_size=3, prefix="zb_")
        layer.initialize(mt.init.One())
        params = layer.collect_params()
        np.testing.assert_array_equal(
            params["zb_l0_i2h_bias"].data().asnumpy(), 0.0)
        np.testing.assert_array_equal(
            params["zb_l0_h2h_bias"].data().asnumpy(), 0.0)
        np.testing.assert_array_equal(
            params["zb_l0_i2h_weight"].data().asnumpy(), 1.0)


def test_layer_rejects_wrong_state_shape():
    with mt.device_scope("cpu"):
        layer = mt.gluon.rnn.GRU(4, input_size=3, prefix="ws_")
        layer.initialize()
        with pytest.raises(ValueError, match="Invalid recurrent state"):
            layer(mt.nd.ones((2, 5, 3)), [mt.nd.zeros((1, 4, 4))])


# ---------------------------------------------- the RNN cases of test_gluon

def test_fused_lstm_matches_cell_unroll():
    """gluon.rnn.LSTM (the fused op) equals LSTMCell unrolled with the
    same weights, in the port; both equal the reference's."""
    T, N, I, H = 4, 3, 5, 6
    x = np.random.RandomState(0).randn(T, N, I).astype(np.float32)
    outs = {}
    for pkg in (mx, mt):
        with _scope(pkg):
            layer = pkg.gluon.rnn.LSTM(hidden_size=H, num_layers=1,
                                       input_size=I, prefix="fl_")
            layer.initialize(pkg.init.Zero())
            if pkg is mx:
                values = _draw_params(layer, 3)
            _set_params(layer, values)
            out = layer(_nd(pkg, x)).asnumpy()
            cell = pkg.gluon.rnn.LSTMCell(H, input_size=I, prefix="fc_")
            cell.initialize(pkg.init.Zero())
            for part in ("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias"):
                getattr(cell, part).set_data(values["fl_l0_" + part])
            steps, _ = cell.unroll(T, _nd(pkg, x), layout="TNC",
                                   merge_outputs=True)
            _close(steps.asnumpy(), out, "cell vs layer")
            outs[pkg] = out
    _close(outs[mt], outs[mx], "port vs reference")


def test_gru_and_rnn_layers_run():
    x = np.random.RandomState(4).rand(3, 2, 4).astype(np.float32)
    with mt.device_scope("cpu"):
        for layer in (mt.gluon.rnn.GRU(5, num_layers=2, bidirectional=True),
                      mt.gluon.rnn.RNN(5, activation="tanh")):
            layer.initialize(mt.init.Xavier())
            out = layer(mt.nd.array(x))
            assert out.shape[0] == 3 and out.shape[1] == 2


# ------------------------------------------------------------------ cells

def _stack(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "sequential":
        cell = rnn.SequentialRNNCell(prefix="sq_")
        with cell.name_scope():
            cell.add(rnn.LSTMCell(4, input_size=3))
            cell.add(rnn.ResidualCell(rnn.GRUCell(4, input_size=4)))
            cell.add(rnn.DropoutCell(0.5))
            cell.add(rnn.RNNCell(4, activation="relu", input_size=4))
        return cell
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(4, prefix="bl_"),
                                     rnn.GRUCell(4, prefix="br_"))
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(4, prefix="zl_"),
                               zoneout_outputs=0.3, zoneout_states=0.2)
    return {"rnn": lambda: rnn.RNNCell(4, prefix="c_"),
            "lstm": lambda: rnn.LSTMCell(4, prefix="c_"),
            "gru": lambda: rnn.GRUCell(4, prefix="c_")}[kind]()


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "bidirectional", "zoneout"])
def test_cells_unroll_match_reference(kind):
    """Unrolled over 5 steps in NTC (training mode off, so dropout and
    zoneout pass values through): outputs, final states and parameter
    gradients equal the reference's; the parameter names too."""
    T, N, C = 5, 2, 3
    rng = np.random.RandomState(5)
    x = rng.randn(N, T, C).astype(np.float32)
    head = rng.randn(N, T, 8 if kind == "bidirectional" else 4).astype(
        np.float32)
    runs = {}
    for pkg in (mx, mt):
        with _scope(pkg):
            cell = _stack(pkg, kind)
            cell.initialize(pkg.init.Zero())
            cell.unroll(T, _nd(pkg, x), layout="NTC", merge_outputs=True)
            if pkg is mx:
                values = _draw_params(cell, 6)
            assert sorted(cell.collect_params().keys()) == sorted(values)
            _set_params(cell, values)
            with pkg.autograd.record(train_mode=False):
                outs, states = cell.unroll(T, _nd(pkg, x), layout="NTC",
                                           merge_outputs=True)
                loss = (outs * _nd(pkg, head)).sum()
            loss.backward()
            runs[pkg] = (outs.asnumpy(), [s.asnumpy() for s in states],
                         _grads(cell))
    (o_m, s_m, g_m), (o_t, s_t, g_t) = runs[mx], runs[mt]
    _close(o_t, o_m, "outputs")
    assert len(s_t) == len(s_m)
    for a, b in zip(s_t, s_m):
        _close(a, b, "state")
    for k in g_m:
        _close(g_t[k], g_m[k], "grad " + k)


def test_sequential_rnn_cell_and_modifiers():
    with mt.device_scope("cpu"):
        cell = mt.gluon.rnn.SequentialRNNCell()
        cell.add(mt.gluon.rnn.LSTMCell(4, input_size=3))
        cell.add(mt.gluon.rnn.ResidualCell(mt.gluon.rnn.GRUCell(
            4, input_size=4)))
        cell.initialize(mt.init.Xavier())
        x = mt.nd.array(np.random.rand(2, 5, 3).astype(np.float32))
        outs, states = cell.unroll(5, x, layout="NTC", merge_outputs=True)
        assert outs.shape == (2, 5, 4)
        assert len(states) == 3  # lstm h,c + gru h


def test_dropout_cell_trains_by_distribution():
    """DropoutCell in training: a keep share near 1 - p, kept values
    scaled by 1 / (1 - p)."""
    with mt.device_scope("cpu"):
        mt.random.seed(0)
        cell = mt.gluon.rnn.DropoutCell(0.25)
        x = mt.nd.ones((200, 50))
        with mt.autograd.record():
            out, _ = cell(x, [])
        v = out.asnumpy()
        kept = (v != 0).mean()
        assert abs(kept - 0.75) < 3 * np.sqrt(0.75 * 0.25 / v.size)
        np.testing.assert_allclose(v[v != 0], 1 / 0.75, rtol=1e-6)


# ----------------------------------------------------------- word LM

VOCAB, EMBED, BPTT, BATCH = 50, 16, 5, 4


def _word_lm(pkg):
    gluon, nn, rnn = pkg.gluon, pkg.gluon.nn, pkg.gluon.rnn

    class RNNModel(gluon.Block):
        """The upstream example's model: embedding, dropout, LSTM,
        dropout, a decoder tied to the embedding."""

        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = nn.Dropout(0.0)
                self.encoder = nn.Embedding(VOCAB, EMBED)
                self.rnn = rnn.LSTM(EMBED, num_layers=2, dropout=0.0,
                                    input_size=EMBED)
                self.decoder = nn.Dense(VOCAB, in_units=EMBED,
                                        params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, EMBED)))
            return decoded, hidden

    return RNNModel(prefix="wordlm_")


def _run_word_lm(pkg, values, tokens):
    with _scope(pkg):
        model = _word_lm(pkg)
        model.initialize(pkg.init.Zero())
        _set_params(model, values)
        trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                    {"learning_rate": 1.0, "momentum": 0,
                                     "wd": 0})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        hidden = model.rnn.begin_state(batch_size=BATCH, ctx=pkg.cpu())
        losses, norms = [], []
        for i in range(3):
            x = _nd(pkg, tokens[i * BPTT:(i + 1) * BPTT])
            y = _nd(pkg, tokens[i * BPTT + 1:(i + 1) * BPTT + 1])
            hidden = [h.detach() for h in hidden]
            with pkg.autograd.record():
                out, hidden = model(x, hidden)
                loss = loss_fn(out, y.reshape((-1,)))
            loss.backward()
            grads = [p.grad() for p in model.collect_params().values()
                     if p.grad_req != "null"]
            norms.append(pkg.gluon.utils.clip_global_norm(
                grads, 0.2 * BPTT * BATCH))
            trainer.step(BPTT * BATCH)
            losses.append(float(loss.mean().asnumpy()))
        params = {k: p.data().asnumpy()
                  for k, p in model.collect_params().items()}
        return losses, norms, params, [h.asnumpy() for h in hidden], model


def test_word_lm_tied_truncated_bptt():
    """Three truncated-BPTT steps of the tied word LM: losses, gradient
    norms, parameters and the carried states equal the reference's, and
    the decoder holds the embedding's weight itself."""
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, VOCAB, size=(3 * BPTT + 1, BATCH)).astype(
        np.float32)
    with mt.device_scope("cpu"):
        probe = _word_lm(mt)
    params = probe.collect_params()
    assert probe.decoder.weight is probe.encoder.weight
    assert "wordlm_embedding0_weight" in params.keys()
    assert "wordlm_embedding0_bias" in params.keys()   # the decoder's
    values = {k: np.random.RandomState(8).uniform(-0.3, 0.3, p.shape)
              .astype(np.float32) for k, p in sorted(params.items())
              if p.shape is not None and 0 not in p.shape}
    want = _run_word_lm(mx, values, tokens)
    got = _run_word_lm(mt, values, tokens)
    for a, b in zip(got[0], want[0]):
        _close(a, b, "loss")
    for a, b in zip(got[1], want[1]):
        _close(a, b, "gradient norm")
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], "param " + k)
    for a, b in zip(got[3], want[3]):
        _close(a, b, "hidden")
    assert got[0][-1] != got[0][0]
    model = got[4]
    assert model.decoder.weight.data() is model.encoder.weight.data()
