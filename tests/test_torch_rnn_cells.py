"""The port's symbolic recurrent cells (``mt.rnn``) and bucketing iterator
against the reference's ``mx.rnn``.

The oracles of ``tests/test_rnn.py`` run in both packages — unroll
shapes, the fused cell against its ``unfuse()`` stack, the pack /
unpack round trip, bidirectional and residual stacks,
``encode_sentences`` and ``BucketSentenceIter`` — and besides:

* the graphs the same cell code builds are the reference's: the Symbol
  JSON of a 2-layer ``LSTMCell`` unroll has the same nodes (names, ops,
  inputs, attributes), arguments and inferred shapes, and a graph
  written by the reference runs in the port to the same outputs;
* forward passes of the unrolled cells, the modifiers and
  ``FusedRNNCell`` in every mode equal the reference's on the same
  weights; ``unpack_weights`` gives the reference's per-gate arrays;
* ``BucketSentenceIter`` delivers the reference's batches bit for bit,
  in both layouts, over two epochs;
* the initializers ``Orthogonal``, ``LSTMBias`` and ``FusedRNN`` draw
  the reference's values bit for bit from the same numpy state.

Tolerances are 1e-5 of max(1, the largest magnitude).
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

TOL = 1e-5
PKGS = [mx, mt]


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _names(pkg):
    return pkg.sym.NameManager() if pkg is mt else mx.name.NameManager()


def _run(pkg, sym, values, shapes, batch=None):
    """Bind ``sym`` on the CPU with ``values`` (zeros where absent) and
    run one inference forward."""
    kw = dict(shapes)
    if batch is not None:
        kw["__batch_size__"] = batch
    ex = sym.simple_bind(pkg.cpu(), **kw)
    for name, arr in ex.arg_dict.items():
        arr[:] = values[name] if name in values else 0.0
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def _draw(sym, shapes, seed, batch=None):
    kw = dict(shapes)
    if batch is not None:
        kw["__batch_size__"] = batch
    args, _, _ = sym.infer_shape(**kw)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), args)
            if "begin_state" not in n}


# ------------------------------------------------------ oracles, both pkgs

@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_rnn_cell_unroll_shapes(pkg):
    rnn = pkg.rnn
    for cell, n_states in ((rnn.RNNCell(8, prefix="r_"), 1),
                           (rnn.LSTMCell(8, prefix="l_"), 2),
                           (rnn.GRUCell(8, prefix="g_"), 1)):
        outputs, states = cell.unroll(3, input_prefix="x_")
        assert len(outputs) == 3
        assert len(states) == n_states
        g = pkg.sym.Group(outputs)
        shapes = {"x_t%d_data" % t: (4, 5) for t in range(3)}
        _, out_shapes, _ = g.infer_shape(__batch_size__=4, **shapes)
        assert all(s == (4, 8) for s in out_shapes)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_pack_unpack_roundtrip(pkg):
    for mode, bidir in (("lstm", False), ("gru", True), ("rnn_tanh", False)):
        cell = pkg.rnn.FusedRNNCell(6, num_layers=2, mode=mode,
                                    bidirectional=bidir, prefix="f_")
        n = rnn_param_size(2, 4, 6, mode, bidir)
        packed = pkg.nd.array(np.random.RandomState(0).uniform(
            -1, 1, (n,)).astype(np.float32), ctx=pkg.cpu())
        unpacked = cell.unpack_weights({"f_parameters": packed})
        assert "f_parameters" not in unpacked
        repacked = cell.pack_weights(unpacked)
        np.testing.assert_array_equal(repacked["f_parameters"].asnumpy(),
                                      packed.asnumpy())


def test_unpack_weights_match_reference():
    n = rnn_param_size(2, 4, 6, "lstm", True)
    flat = np.random.RandomState(1).uniform(-1, 1, n).astype(np.float32)
    out = {}
    for pkg in PKGS:
        cell = pkg.rnn.FusedRNNCell(6, num_layers=2, mode="lstm",
                                    bidirectional=True, prefix="u_")
        args = cell.unpack_weights({"u_parameters": pkg.nd.array(
            flat, ctx=pkg.cpu())})
        out[pkg] = {k: v.asnumpy() for k, v in args.items()}
    assert sorted(out[mt]) == sorted(out[mx])
    for k in out[mx]:
        np.testing.assert_array_equal(out[mt][k], out[mx][k])


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_bidirectional_residual_stack(pkg):
    rnn = pkg.rnn
    stack = rnn.SequentialRNNCell()
    stack.add(rnn.BidirectionalCell(rnn.LSTMCell(4, prefix="fl_"),
                                    rnn.LSTMCell(4, prefix="fr_"),
                                    output_prefix="bi_"))
    outputs, _ = stack._cells[0].unroll(3, input_prefix="x_",
                                        merge_outputs=True)
    shapes = {"x_t%d_data" % t: (2, 5) for t in range(3)}
    _, out_shapes, _ = outputs.infer_shape(__batch_size__=2, **shapes)
    assert out_shapes == [(2, 3, 8)]

    res = rnn.ResidualCell(rnn.RNNCell(5, prefix="rr_"))
    outputs, _ = res.unroll(2, input_prefix="y_")
    shapes = {"y_t%d_data" % t: (2, 5) for t in range(2)}
    _, out_shapes, _ = pkg.sym.Group(outputs).infer_shape(__batch_size__=2,
                                                          **shapes)
    assert all(s == (2, 5) for s in out_shapes)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_encode_sentences_and_bucket_iter(pkg):
    sents = [["a", "b", "c"], ["a", "b"], ["b", "c"], ["a", "b", "c", "d"],
             ["a", "c"], ["b", "a"], ["c", "b", "a"]]
    encoded, vocab = pkg.rnn.encode_sentences(sents, start_label=1)
    assert all(isinstance(i, int) for s in encoded for i in s)
    assert len(set(vocab.values())) == len(vocab)
    it = pkg.rnn.BucketSentenceIter(encoded, batch_size=2, buckets=[2, 3],
                                    invalid_label=-1, seed=7)
    assert it.default_bucket_key == 3
    seen = 0
    for batch in it:
        seen += 1
        d = batch.data[0].asnumpy()
        lab = batch.label[0].asnumpy()
        assert d.shape == (2, batch.bucket_key)
        np.testing.assert_array_equal(lab[:, :-1], d[:, 1:])
        assert np.all(lab[:, -1] == -1)
    assert seen >= 2
    it.reset()
    assert sum(1 for _ in it) == seen


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_iter_batches_match_reference(layout):
    """Two epochs of seeded batches, bit for bit, with the auto buckets
    and with given ones."""
    rng = np.random.RandomState(3)
    sents = [list(rng.randint(1, 30, size=rng.randint(2, 12)))
             for _ in range(90)]
    for buckets in (None, [4, 8, 12]):
        got = {}
        for pkg in PKGS:
            it = pkg.rnn.BucketSentenceIter(sents, 5, buckets=buckets,
                                            invalid_label=0, seed=4,
                                            layout=layout)
            epochs = []
            for _ in range(2):
                epochs.append([(b.bucket_key, b.data[0].asnumpy(),
                                b.label[0].asnumpy(),
                                b.provide_data[0].shape) for b in it])
                it.reset()
            got[pkg] = (it.buckets, it.provide_data[0].shape, epochs)
        assert got[mt][:2] == got[mx][:2]
        for e_t, e_m in zip(got[mt][2], got[mx][2]):
            assert len(e_t) == len(e_m)
            for (k_t, d_t, l_t, s_t), (k_m, d_m, l_m, s_m) in zip(e_t, e_m):
                assert (k_t, s_t) == (k_m, s_m)
                np.testing.assert_array_equal(d_t, d_m)
                np.testing.assert_array_equal(l_t, l_m)


# ------------------------------------------------------ graphs and values

def _lstm_lm(pkg, seq_len):
    """The bucketing LM's graph: embedding, a 2-layer LSTMCell stack
    unrolled, the decoder and the softmax head."""
    with _names(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(pkg.rnn.LSTMCell(num_hidden=8, prefix="lstm_l%d_" % i))
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=20, output_dim=6,
                                  name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, 8))
        pred = pkg.sym.FullyConnected(pred, num_hidden=20, name="pred")
        lab = pkg.sym.Reshape(label, shape=(-1,))
        return pkg.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                     ignore_label=0, normalization="valid",
                                     name="softmax")


def test_lstm_unroll_json_matches_reference():
    """The same cell code builds the reference's graph: nodes, ops,
    inputs and attributes of the JSON, the arguments and their
    inferred shapes."""
    shapes = {"data": (3, 4), "softmax_label": (3, 4)}
    graphs = {pkg: _lstm_lm(pkg, 4) for pkg in PKGS}
    js = {pkg: json.loads(g.tojson()) for pkg, g in graphs.items()}
    strip = [[(n["op"], n["name"], n["inputs"], n["param"],
               n.get("attr", {})) for n in j["nodes"]] for j in
             (js[mt], js[mx])]
    assert strip[0] == strip[1]
    assert js[mt]["heads"] == js[mx]["heads"]
    assert js[mt]["arg_nodes"] == js[mx]["arg_nodes"]
    info = {pkg: (g.list_arguments(), g.list_outputs(),
                  g.infer_shape(**shapes)[0])
            for pkg, g in graphs.items()}
    assert info[mt] == info[mx]
    assert "lstm_l1_begin_state_1" in info[mt][0]


def test_reference_json_runs_in_the_port():
    shapes = {"data": (3, 4), "softmax_label": (3, 4)}
    ref = _lstm_lm(mx, 4)
    values = _draw(ref, shapes, 2)
    values["data"] = np.random.RandomState(5).randint(0, 20, (3, 4)).astype(
        np.float32)
    want = _run(mx, ref, values, shapes)
    got = _run(mt, mt.sym.load_json(ref.tojson()), values, shapes)
    _close(got[0], want[0], "softmax of the reference's graph")


MODES = [("lstm", False), ("lstm", True), ("gru", False), ("gru", True),
         ("rnn_tanh", True), ("rnn_relu", False)]


@pytest.mark.parametrize("mode,bidir", MODES)
def test_fused_cell_matches_reference_and_unfused(mode, bidir):
    """A 2-layer FusedRNNCell in NTC: the port's forward equals the
    reference's on the same packed vector, and (one direction) equals
    the port's own unfuse() stack fed the unpacked and repacked
    weights."""
    T, N, C, Hd = 4, 2, 3, 5
    shapes = {"data": (N, T, C)}
    values = None
    outs = {}
    for pkg in PKGS:
        with _names(pkg):
            fused = pkg.rnn.FusedRNNCell(Hd, num_layers=2, mode=mode,
                                         bidirectional=bidir, prefix="f_",
                                         get_next_state=True)
            f_out, f_states = fused.unroll(T, inputs=pkg.sym.Variable("data"),
                                           layout="NTC", merge_outputs=True)
            g = pkg.sym.Group([f_out] + f_states)
        if values is None:
            values = _draw(g, shapes, 7)
        outs[pkg] = _run(pkg, g, values, shapes)
        if pkg is mt and not bidir:
            # (an unfused bidirectional stack cannot be stepped, in
            # either package)
            unfused = fused.unfuse()
            with _names(pkg):
                u_out, _ = unfused.unroll(T, inputs=pkg.sym.Variable("data"),
                                          layout="NTC", merge_outputs=True)
            cell_args = unfused.pack_weights(fused.unpack_weights(
                {"f_parameters": mt.nd.array(values["f_parameters"],
                                             ctx=mt.cpu())}))
            u_vals = {k: v.asnumpy() for k, v in cell_args.items()}
            u_vals["data"] = values["data"]
            got = _run(mt, u_out, u_vals, shapes, batch=N)
            _close(got[0], outs[mt][0], "unfused vs fused")
    assert len(outs[mt]) == len(outs[mx])
    for a, b in zip(outs[mt], outs[mx]):
        _close(a, b, "fused port vs reference")


@pytest.mark.parametrize("kind", ["gru", "rnn_relu", "bidirectional",
                                  "residual", "zoneout", "dropout"])
def test_cells_forward_match_reference(kind):
    """Unrolled graphs of the other cells and modifiers (inference, so
    dropout and zoneout pass values through) equal the reference's."""
    T, N, C = 3, 2, 5
    shapes = {"x_t%d_data" % t: (N, C) for t in range(T)}
    values = None
    outs = {}
    for pkg in PKGS:
        rnn = pkg.rnn
        with _names(pkg):
            cell = {
                "gru": lambda: rnn.GRUCell(5, prefix="g_"),
                "rnn_relu": lambda: rnn.RNNCell(5, activation="relu",
                                                prefix="r_"),
                "bidirectional": lambda: rnn.BidirectionalCell(
                    rnn.GRUCell(5, prefix="bl_"),
                    rnn.LSTMCell(5, prefix="br_")),
                "residual": lambda: rnn.ResidualCell(
                    rnn.LSTMCell(5, prefix="res_")),
                "zoneout": lambda: rnn.ZoneoutCell(
                    rnn.LSTMCell(5, prefix="z_"), zoneout_outputs=0.3,
                    zoneout_states=0.4),
                "dropout": lambda: _dropout_stack(rnn),
            }[kind]()
            outputs, states = cell.unroll(T, input_prefix="x_")
            g = pkg.sym.Group(list(outputs) + list(states))
        if values is None:
            values = _draw(g, shapes, 8, batch=N)
        outs[pkg] = _run(pkg, g, values, shapes, batch=N)
    for a, b in zip(outs[mt], outs[mx]):
        _close(a, b, kind)


def _dropout_stack(rnn):
    stack = rnn.SequentialRNNCell()
    stack.add(rnn.LSTMCell(5, prefix="d0_"))
    stack.add(rnn.DropoutCell(0.5, prefix="drop_"))
    stack.add(rnn.LSTMCell(5, prefix="d1_"))
    return stack


# ------------------------------------------------------------ initializers

INITS = [
    ("orthogonal", lambda pkg: pkg.init.Orthogonal(), (12, 6), "x_weight"),
    ("orthogonal-normal",
     lambda pkg: pkg.init.Orthogonal(scale=0.5, rand_type="normal"),
     (6, 2, 3), "x_weight"),
    ("lstm-bias", lambda pkg: pkg.init.LSTMBias(forget_bias=2.0), (24,),
     "x_bias"),
    ("fused-lstm", lambda pkg: pkg.init.FusedRNN(None, 6, 2, "lstm", True,
                                                 1.5),
     (rnn_param_size(2, 4, 6, "lstm", True),), "x_weight"),
    ("fused-gru", lambda pkg: pkg.init.FusedRNN(pkg.init.Uniform(0.3), 6, 1,
                                                "gru"),
     (rnn_param_size(1, 4, 6, "gru"),), "x_weight"),
]


@pytest.mark.parametrize("what,make,shape,name", INITS,
                         ids=[c[0] for c in INITS])
def test_initializers_match_reference_bitwise(what, make, shape, name):
    got = {}
    for pkg in PKGS:
        arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
        np.random.seed(21)
        make(pkg)(pkg.init.InitDesc(name), arr)
        got[pkg] = arr.asnumpy()
    np.testing.assert_array_equal(got[mt], got[mx])
    assert np.abs(got[mt]).max() > 0


def test_fused_cell_initializer_through_the_variable():
    """A FusedRNNCell's parameter carries its FusedRNN initializer (the
    ``__init__`` attribute) and a module initializes it as the
    reference does; LSTMCell's i2h bias carries LSTMBias."""
    got = {}
    for pkg in PKGS:
        with _names(pkg):
            cell = pkg.rnn.FusedRNNCell(4, num_layers=1, mode="lstm",
                                        prefix="fi_")
            out, _ = cell.unroll(3, inputs=pkg.sym.Variable("data"),
                                 layout="TNC", merge_outputs=True)
            lstm = pkg.rnn.LSTMCell(4, prefix="li_", forget_bias=3.0)
            o2, _ = lstm.unroll(2, input_prefix="y_")
        attrs = out.attr_dict()
        init = pkg.init.Xavier()
        np.random.seed(5)
        arr = pkg.nd.zeros((rnn_param_size(1, 2, 4, "lstm"),),
                           ctx=pkg.cpu())
        init(pkg.init.InitDesc("fi_parameters", attrs["fi_parameters"]),
             arr)
        bias = pkg.nd.zeros((16,), ctx=pkg.cpu())
        init(pkg.init.InitDesc(
            "li_i2h_bias", pkg.sym.Group(o2).attr_dict()["li_i2h_bias"]),
            bias)
        got[pkg] = (arr.asnumpy(), bias.asnumpy())
    np.testing.assert_array_equal(got[mt][0], got[mx][0])
    np.testing.assert_array_equal(got[mt][1], got[mx][1])
    assert got[mt][1][4:8].tolist() == [3.0] * 4
