"""The port's legacy custom-op frontend (``operator.PythonOp`` /
``NumpyOp`` / ``NDArrayOp``) against the reference's, on the CPU.

The two ops of the reference's oracles (``tests/test_custom_op.py``
``test_legacy_numpy_op_softmax`` and ``test_legacy_ndarray_op_scale``),
written once against each package's classes, at the oracles' sizes:

* the ``NumpyOp`` softmax head (upstream MXNet's ``example/numpy-ops``)
  over ``FullyConnected(4)`` on a (16, 8) batch: forward outputs and the
  input gradients through ``simple_bind`` within rtol 1e-5 / atol 1e-6
  of the reference's (f32 softmax in another order: measured gaps
  ~1e-7), and ``Module.fit`` over 1 and 12 epochs (SGD 0.5, one batch
  of 8 at a time) from the same initial weights: the loss curve (each
  epoch's cross-entropy, float64 numpy over that epoch's weights), the
  outputs and every parameter within rtol 1e-5 / atol 1e-6 of the
  reference's, the loss falling, and the oracle's accuracy gate;
* the ``NDArrayOp`` scale (x3): forward and gradient exact, as the
  oracle holds them; its inputs arrive as NDArrays on the caller's
  device, never as numpy arrays.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def softmax_op(pkg):
    """The oracle's NumpyOp softmax head, on ``pkg``'s classes."""
    class NumpySoftmax(pkg.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            y = out_data[0]
            y[:] = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            y = out_data[0]
            dx = in_grad[0]
            dx[:] = y
            dx[np.arange(lab.shape[0]), lab] -= 1.0

    return NumpySoftmax()


def scale_op(pkg, seen=None):
    """The oracle's NDArrayOp (x3); ``seen`` collects the types and
    devices of what forward receives."""
    class Scale(pkg.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            if seen is not None:
                seen.extend(in_data)
            out_data[0][:] = in_data[0] * 3.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 3.0

    return Scale()


def softmax_net(pkg):
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
    return softmax_op(pkg).get_symbol(fc, pkg.sym.Variable("softmax_label"),
                                      name="softmax")


def batch():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    return x, y


def weights():
    rng = np.random.RandomState(1)
    return {"fc_weight": (rng.randn(4, 8) * 0.3).astype(np.float32),
            "fc_bias": (rng.randn(4) * 0.1).astype(np.float32)}


def test_numpy_op_softmax_forward_and_gradients():
    x, y = batch()
    w = weights()
    ref = softmax_net(mx)
    ex = ref.simple_bind(ctx=mx.cpu(0), data=(16, 8))
    for k, v in dict(w, data=x, softmax_label=y).items():
        ex.arg_dict[k][:] = v
    want = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    want_grads = {k: ex.grad_dict[k].asnumpy()
                  for k in ("data", "fc_weight", "fc_bias")}

    net = softmax_net(mt)
    assert net.list_arguments() == ref.list_arguments()
    et = net.simple_bind(ctx=mt.cpu(0), data=(16, 8))
    for k, v in dict(w, data=x, softmax_label=y).items():
        et.arg_dict[k][:] = v
    got = et.forward(is_train=True)[0].asnumpy()
    et.backward()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    for k, v in want_grads.items():
        np.testing.assert_allclose(et.grad_dict[k].asnumpy(), v,
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def cross_entropy(args):
    """The batch's mean cross-entropy under ``args``, in float64 numpy."""
    x, y = batch()
    z = x.astype(np.float64) @ args["fc_weight"].T + args["fc_bias"]
    z -= z.max(1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(1, keepdims=True))
    return float(-logp[np.arange(len(y)), y.astype(int)].mean())


def fit(pkg, epochs):
    """``Module.fit`` of the softmax net: the cross-entropy after each
    epoch, the outputs on the first batch and the final weights."""
    x, y = batch()
    it = pkg.io.NDArrayIter(x, y, batch_size=8)
    mod = pkg.mod.Module(softmax_net(pkg), context=pkg.cpu(0))
    w = weights()
    curve = []
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.5},
            arg_params={k: pkg.nd.array(v) for k, v in w.items()}
            if pkg is mx else
            {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in w.items()},
            num_epoch=epochs,
            epoch_end_callback=lambda e, s, args, aux: curve.append(
                cross_entropy({k: v.asnumpy() for k, v in args.items()})))
    it.reset()
    mod.forward(next(it), is_train=False)
    p = mod.get_outputs()[0].asnumpy()
    args, _ = mod.get_params()
    return curve, p, {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("epochs", [1, 12])
def test_numpy_op_module_fit_matches_the_reference(epochs):
    want_curve, want_p, want = fit(mx, epochs)
    with mt.cpu():
        got_curve, got_p, got = fit(mt, epochs)
    assert len(got_curve) == len(want_curve) == epochs
    np.testing.assert_allclose(got_curve, want_curve, rtol=RTOL, atol=ATOL)
    assert got_curve[-1] < cross_entropy(weights())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=ATOL)
    if epochs == 12:                # the oracle's gate
        _, y = batch()
        assert (got_p.argmax(1) == y[:8]).mean() >= 0.75


def test_ndarray_op_scale_forward_and_gradient():
    seen = []
    x = mt.sym.Variable("data")
    net = scale_op(mt, seen).get_symbol(x, name="scale3")
    ex = net.simple_bind(ctx=mt.cpu(0), data=(2, 3))
    ex.arg_dict["data"][:] = np.ones((2, 3), np.float32)
    out = ex.forward(is_train=True)[0].asnumpy()
    np.testing.assert_array_equal(out, 3.0)
    ex.backward(mt.nd.array(np.full((2, 3), 2.0, np.float32), ctx=mt.cpu()))
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), 6.0)
    # the op saw NDArrays on the caller's device, not host copies
    assert seen and all(isinstance(a, mt.nd.NDArray) for a in seen)
    assert all(a.data.device == torch.device("cpu") for a in seen)

    # and the reference's, on the same input
    jx = mx.sym.Variable("data")
    jex = scale_op(mx).get_symbol(jx, name="scale3").simple_bind(
        ctx=mx.cpu(0), data=(2, 3))
    jex.arg_dict["data"][:] = np.ones((2, 3), np.float32)
    np.testing.assert_array_equal(jex.forward(is_train=True)[0].asnumpy(),
                                  out)


def test_legacy_ops_register_distinct_types_and_keep_their_names():
    a, b = softmax_op(mt), scale_op(mt)
    sa = a.get_symbol(mt.sym.Variable("d"), mt.sym.Variable("l"), name="sa")
    sb = b.get_symbol(mt.sym.Variable("d"), name="sb")
    assert a._op_type != b._op_type
    assert a.get_symbol(mt.sym.Variable("d"), mt.sym.Variable("l"),
                        name="sa2") is not None
    assert a._op_type == a._ensure_registered()
    assert sa.list_arguments() == ["d", "l"]
    assert sb.list_outputs() == ["sb_output"]
    assert mt.operator.get_prop_class(a._op_type)().need_top_grad() is False
    with pytest.raises(NotImplementedError):
        mt.operator.PythonOp().get_symbol(mt.sym.Variable("d"))
