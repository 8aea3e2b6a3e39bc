"""The port's fused ``RNN`` op and the ops the recurrent cells call,
against the reference's on the same numpy-drawn inputs.

* ``RNN`` in every mode (``lstm``, ``gru``, ``rnn_tanh``,
  ``rnn_relu``), one and two layers, one and two directions, with and
  without ``state_outputs``, at T 5, N 3, input 4, H 6: the outputs,
  the final states and the gradients of the data, the packed vector and
  the initial states (the reference's under ``jax.vjp``);
* ``rnn_param_size`` and ``rnn_unpack_params`` (the packed layout);
* the dropout between layers, by its distribution (a keep share within
  3 sigma of 1 - p), and p = 0 exactly the op without dropout;
* ``SequenceLast``, ``SequenceMask``, ``SequenceReverse``,
  ``SliceChannel``, ``SwapAxis``, ``where`` and ``expand_dims``,
  values and gradients under ``jax.vjp``;
* ``nd.RNN`` / ``sym.RNN`` through the port's front ends.

Tolerances are 1e-5 of max(1, the largest magnitude): the same f32
recurrence summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import matrix as ref_matrix
from mxnet_tpu.ops import rnn_op as ref_rnn
from mxnet_tpu.ops import sequence as ref_seq
from mxnet_tpu_torch.ops import matrix as port_matrix
from mxnet_tpu_torch.ops import rnn_op as port_rnn
from mxnet_tpu_torch.ops import sequence as port_seq

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

TOL = 1e-5
T, N, I, H = 5, 3, 4, 6


def _close(got, want, what="", tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _ref_vjp(fn, inputs, heads, **attrs):
    """The reference function's outputs and the gradients of
    sum(out * head) with respect to every input."""
    outs, pullback = jax.vjp(lambda *xs: fn(*xs, **attrs),
                             *[jnp.asarray(x) for x in inputs])
    tup = outs if isinstance(outs, tuple) else (outs,)
    cot = tuple(jnp.asarray(h) for h in heads)
    grads = pullback(cot if isinstance(outs, tuple) else cot[0])
    return [np.asarray(o) for o in tup], [np.asarray(g) for g in grads]


def _port_vjp(fn, inputs, heads, **attrs):
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs = fn(*xs, **attrs)
    tup = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(
        tup, xs, grad_outputs=[torch.tensor(h) for h in heads],
        allow_unused=True)
    return ([o.detach().numpy() for o in tup],
            [np.zeros_like(x) if g is None else g.numpy()
             for g, x in zip(grads, inputs)])


CASES = [(mode, layers, bidir, state_outputs)
         for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu")
         for layers in (1, 2) for bidir in (False, True)
         for state_outputs in (False, True)]


@pytest.mark.parametrize("mode,layers,bidir,state_outputs", CASES)
def test_rnn_op_matches_reference(mode, layers, bidir, state_outputs):
    rng = np.random.RandomState(layers * 10 + bidir)
    dirs = 2 if bidir else 1
    n = port_rnn.rnn_param_size(layers, I, H, mode, bidir)
    assert n == ref_rnn.rnn_param_size(layers, I, H, mode, bidir)
    inputs = [rng.randn(T, N, I).astype(np.float32),
              rng.uniform(-0.4, 0.4, n).astype(np.float32),
              rng.randn(layers * dirs, N, H).astype(np.float32)]
    if mode == "lstm":
        inputs.append(rng.randn(layers * dirs, N, H).astype(np.float32))
    attrs = dict(state_size=H, num_layers=layers, mode=mode,
                 bidirectional=bidir, state_outputs=state_outputs)
    shapes = [(T, N, H * dirs)]
    if state_outputs:
        shapes += [(layers * dirs, N, H)] * (2 if mode == "lstm" else 1)
    heads = [rng.randn(*s).astype(np.float32) for s in shapes]
    want_o, want_g = _ref_vjp(ref_rnn.rnn.fn, inputs, heads, **attrs)
    got_o, got_g = _port_vjp(port_rnn.rnn.fn, inputs, heads, **attrs)
    assert len(got_o) == len(want_o) == len(shapes)
    for what, g, w in zip(("output", "h", "c"), got_o, want_o):
        _close(g, w, what)
    for what, g, w in zip(("data", "parameters", "state", "state_cell"),
                          got_g, want_g):
        _close(g, w, "grad of " + what)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_backward_runs_with_tf32_off(mode, monkeypatch):
    """A float32 op's backward runs with cuDNN's TF32 switch off even
    when it is on globally (torch's default) as autograd runs it: the
    recurrence's own backward, seen from a hook on its output, finds the
    switch off, and the gradients match the reference's."""
    fused, seen = port_rnn._fused, []

    def hooked(*args):
        outs = fused(*args)
        if outs[0].requires_grad:
            outs[0].register_hook(lambda g: seen.append(
                torch.backends.cudnn.allow_tf32))
        return outs
    monkeypatch.setattr(port_rnn, "_fused", hooked)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.RandomState(7)
    n = port_rnn.rnn_param_size(2, I, H, mode)
    inputs = [rng.randn(T, N, I).astype(np.float32),
              rng.uniform(-0.4, 0.4, n).astype(np.float32),
              rng.randn(2, N, H).astype(np.float32)]
    heads = [rng.randn(T, N, H).astype(np.float32)]
    attrs = dict(state_size=H, num_layers=2, mode=mode)
    _, want_g = _ref_vjp(ref_rnn.rnn.fn, inputs, heads, **attrs)
    _, got_g = _port_vjp(port_rnn.rnn.fn, inputs, heads, **attrs)
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32
    for what, g, w in zip(("data", "parameters", "state"), got_g, want_g):
        _close(g, w, "grad of " + what)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True),
                                        ("rnn_relu", True)])
def test_unpack_layout(mode, bidir):
    """The views follow the packed order (all weights, then all biases)
    and cover the vector exactly, as the reference's slices do."""
    layers = 2
    n = port_rnn.rnn_param_size(layers, I, H, mode, bidir)
    flat = np.arange(n, dtype=np.float32)
    pw, pb = port_rnn.rnn_unpack_params(torch.tensor(flat), layers, I, H,
                                        mode, bidir)
    rw, rb = ref_rnn.rnn_unpack_params(jnp.asarray(flat), layers, I, H,
                                       mode, bidir)
    assert len(pw) == len(rw) == layers * (2 if bidir else 1)
    for (pa, pbh), (ra, rbh) in zip(pw + pb, rw + rb):
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(pbh.numpy(), np.asarray(rbh))
    seen = np.concatenate([t.numpy().ravel() for pair in pw + pb
                           for t in pair])
    np.testing.assert_array_equal(np.sort(seen), flat)


def _dropout_probe(p, train):
    """Two rnn_relu layers whose weights pass the input through (W_x the
    identity, W_h and the biases 0) on positive data: the output is the
    inter-layer dropout applied to the data."""
    size = port_rnn.rnn_param_size(2, 8, 8, "rnn_relu")
    params = torch.zeros(size)
    (w0, _), (w1, _) = port_rnn.rnn_unpack_params(params, 2, 8, 8,
                                                  "rnn_relu")[0]
    w0.copy_(torch.eye(8))
    w1.copy_(torch.eye(8))
    data = torch.tensor(np.random.RandomState(4).rand(40, 50, 8)
                        .astype(np.float32) + 0.5)
    out = port_rnn.rnn.fn(data, params, torch.zeros(2, 50, 8),
                          state_size=8, num_layers=2, mode="rnn_relu",
                          p=p, _is_train=train)
    return data, out


def test_dropout_between_layers_by_distribution():
    mt.random.seed(3)
    p = 0.3
    data, out = _dropout_probe(p, True)
    kept = (out != 0).double().mean().item()
    sigma = np.sqrt(p * (1 - p) / out.numel())
    assert abs(kept - (1 - p)) < 3 * sigma, kept
    mask = out != 0
    _close(out[mask].numpy(), (data[mask] / (1 - p)).numpy(), "kept values")
    # inference, and p = 0 in training: the op without dropout
    for p_, train in ((p, False), (0.0, True)):
        data, out = _dropout_probe(p_, train)
        np.testing.assert_array_equal(out.numpy(), data.numpy())


def test_dropout_draws_from_the_seeded_chain():
    mt.random.seed(11)
    _, a = _dropout_probe(0.5, True)
    mt.random.seed(11)
    _, b = _dropout_probe(0.5, True)
    _, c = _dropout_probe(0.5, True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(b.numpy(), c.numpy())


# ------------------------------------------------------ the ops cells call

def _seq_cases():
    rng = np.random.RandomState(9)
    data = rng.randn(6, 4, 3).astype(np.float32)
    lengths = np.array([6, 1, 3, 4], np.float32)
    return [
        ("SequenceLast", ref_seq.sequence_last, port_seq.sequence_last,
         [data, lengths], dict(use_sequence_length=True)),
        ("SequenceLast (all)", ref_seq.sequence_last, port_seq.sequence_last,
         [data], {}),
        ("SequenceMask", ref_seq.sequence_mask, port_seq.sequence_mask,
         [data, lengths], dict(use_sequence_length=True, value=-2.0)),
        ("SequenceMask (off)", ref_seq.sequence_mask,
         port_seq.sequence_mask, [data], {}),
        ("SequenceReverse", ref_seq.sequence_reverse,
         port_seq.sequence_reverse, [data, lengths],
         dict(use_sequence_length=True)),
        ("SequenceReverse (all)", ref_seq.sequence_reverse,
         port_seq.sequence_reverse, [data], {}),
        ("SliceChannel", ref_matrix.slice_channel, port_matrix.slice_channel,
         [data], dict(num_outputs=3, axis=2)),
        ("SliceChannel squeeze", ref_matrix.slice_channel,
         port_matrix.slice_channel, [data],
         dict(num_outputs=6, axis=0, squeeze_axis=True)),
        ("SwapAxis", ref_matrix.swapaxes, port_matrix.swapaxes, [data],
         dict(dim1=0, dim2=2)),
        ("expand_dims", ref_matrix.expand_dims, port_matrix.expand_dims,
         [data], dict(axis=1)),
        ("where", ref_matrix.where, port_matrix.where,
         [(data > 0).astype(np.float32), data, -data], {}),
        ("where (rows)", ref_matrix.where, port_matrix.where,
         [np.array([1, 0, 0, 1, 1, 0], np.float32), data, 2 * data], {}),
        ("squeeze", ref_matrix.squeeze, port_matrix.squeeze,
         [data[:, :1]], dict(axis=1)),
    ]


@pytest.mark.parametrize("case", _seq_cases(), ids=lambda c: c[0])
def test_cell_ops_match_reference(case):
    what, ref_op, port_op, inputs, attrs = case
    rng = np.random.RandomState(1)
    ref_outs = ref_op.fn(*[jnp.asarray(x) for x in inputs], **attrs)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    heads = [rng.randn(*o.shape).astype(np.float32) for o in ref_outs]
    want_o, want_g = _ref_vjp(ref_op.fn, inputs, heads, **attrs)
    got_o, got_g = _port_vjp(port_op.fn, inputs, heads, **attrs)
    assert len(got_o) == len(want_o)
    for g, w in zip(got_o, want_o):
        _close(g, w, what + " output", tol=0)
    for g, w in zip(got_g, want_g):
        _close(g, w, what + " gradient")


def test_front_ends():
    """``nd.RNN`` runs the op; ``sym.RNN`` infers the packed vector and
    the states from the data shape and has the reference's outputs."""
    rng = np.random.RandomState(2)
    x = rng.randn(T, N, I).astype(np.float32)
    n = port_rnn.rnn_param_size(2, I, H, "gru", True)
    params = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    h0 = np.zeros((4, N, H), np.float32)
    with mt.device_scope("cpu"):
        out = mt.nd.RNN(mt.nd.array(x), mt.nd.array(params),
                        mt.nd.array(h0), state_size=H, num_layers=2,
                        mode="gru", bidirectional=True)
    want = mx.nd.RNN(mx.nd.array(x), mx.nd.array(params), mx.nd.array(h0),
                     state_size=H, num_layers=2, mode="gru",
                     bidirectional=True)
    _close(out.asnumpy(), want.asnumpy(), "nd.RNN")
    shapes = {}
    for pkg in (mx, mt):
        s = pkg.sym.RNN(data=pkg.sym.Variable("data"), state_size=H,
                        num_layers=2, mode="lstm", state_outputs=True,
                        name="rnn")
        args, outs, _ = s.infer_shape(data=(T, N, I))
        shapes[pkg] = (s.list_arguments(), s.list_outputs(), args, outs)
    assert shapes[mt] == shapes[mx]
    assert shapes[mt][2][1] == (port_rnn.rnn_param_size(2, I, H, "lstm"),)
