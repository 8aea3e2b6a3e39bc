"""The port's custom operators (``mxnet_tpu_torch.operator``) against the
reference's (``mxnet_tpu.operator``), on the CPU.

The reference's own Props of ``tests/test_custom_op.py`` (``test_softmax``
and ``test_scale2`` on the host path, ``traced_gelu`` and
``traced_softmax_loss`` on the traced path) are held against the port's
ports of them, registered here under the same names in the port's
registry, and against ``rtc_softmax_loss``: the same loss head on the
two user kernels of ``rtc_examples`` (``softmax_rows``,
``softmax_ce_grad``), which on the CPU run their plain versions. Inputs
are drawn with numpy from the seeds in each test. Forward outputs and
input gradients agree to rtol 1e-5 (f32 softmax/gelu formulas in
another order; measured gaps ~1e-7); five ``Module._fit_step``\\ s from
the same parameters give the same outputs and parameters within 1e-5.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc_examples
# the reference's Props, registered in the reference's registry
from tests.test_custom_op import (Scale2Prop, SoftmaxProp,  # noqa: F401
                                  TracedGeluProp, TracedSoftmaxLossProp)

RTOL, ATOL = 1e-5, 1e-6
N, C = 12, 3        # test_traced_custom_loss_module_fit's batch and classes


# ------------------------------------------------- the port's Props

@mt.operator.register("test_softmax")
class PortSoftmaxProp(mt.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return PortSoftmax()


class PortSoftmax(mt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].asnumpy()
        y = np.exp(x - x.max(axis=1, keepdims=True))
        y /= y.sum(axis=1, keepdims=True)
        self.assign(out_data[0], req[0], mt.nd.array(y))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        lab = in_data[1].asnumpy().ravel().astype(np.int64)
        y = out_data[0].asnumpy()
        y[np.arange(lab.shape[0]), lab] -= 1.0
        self.assign(in_grad[0], req[0], mt.nd.array(y))
        self.assign(in_grad[1], req[1], mt.nd.zeros(in_data[1].shape))


@mt.operator.register("test_scale2")
class PortScale2Prop(mt.operator.CustomOpProp):
    def __init__(self, factor="2.0"):
        super().__init__(need_top_grad=True)
        self.factor = float(factor)

    def create_operator(self, ctx, shapes, dtypes):
        factor = self.factor

        class Scale(mt.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], in_data[0] * factor)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0], out_grad[0] * factor)

        return Scale()


@mt.operator.register("traced_gelu")
class PortTracedGeluProp(mt.operator.CustomOpProp):
    def forward_traced(self, in_data, is_train):
        return (F.gelu(in_data[0], approximate="tanh"),)


@mt.operator.register("traced_softmax_loss")
class PortTracedSoftmaxLossProp(mt.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def forward_traced(self, in_data, is_train):
        return (torch.softmax(in_data[0], dim=1),)

    def backward_traced(self, out_grad, in_data, out_data):
        x, label = in_data
        oh = F.one_hot(label.long(), x.shape[1]).to(out_data[0].dtype)
        return (out_data[0] - oh, torch.zeros_like(label))


SOFTMAX_ROWS = rtc_examples.softmax_rows(N, C)
SOFTMAX_CE_GRAD = rtc_examples.softmax_ce_grad(N, C)
mt.operator.register("rtc_softmax_loss")(
    rtc_examples.softmax_loss_prop(SOFTMAX_ROWS, SOFTMAX_CE_GRAD))


@mt.operator.register("loss_without_backward")
class LossWithoutBackwardProp(mt.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def forward_traced(self, in_data, is_train):
        return (torch.softmax(in_data[0], dim=1),)


@mt.operator.register("first_row_only")
class FirstRowOnlyProp(mt.operator.CustomOpProp):
    def forward_traced(self, in_data, is_train):
        return (in_data[0][:1],)


# ------------------------------------------------- forward and gradients

def _labels(rng, n, c):
    return rng.randint(0, c, n).astype(np.float32)


def _reference(op_type, xs, head, attrs):
    nds = [mx.nd.array(x) for x in xs]
    for a in nds:
        a.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(*nds, op_type=op_type, **attrs)
    y.backward(mx.nd.array(head))
    return y.asnumpy(), [a.grad.asnumpy() for a in nds]


def _port(op_type, xs, head, attrs):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    y = mt.nd.Custom(*[mt.nd.NDArray(t) for t in ts], op_type=op_type,
                     **attrs)
    grads = torch.autograd.grad(y.data, ts, torch.from_numpy(head))
    return y.asnumpy(), [g.numpy() for g in grads]


CASES = [
    # (port op_type, reference op_type, input shapes, labels?, attrs)
    ("test_softmax", "test_softmax", (4, 5), True, {}),
    ("test_scale2", "test_scale2", (2, 3), False, {"factor": "3.0"}),
    ("traced_gelu", "traced_gelu", (3, 4), False, {}),
    ("traced_softmax_loss", "traced_softmax_loss", (N, C), True, {}),
    ("rtc_softmax_loss", "traced_softmax_loss", (N, C), True, {}),
]


@pytest.mark.parametrize("port_op,ref_op,shape,labels,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_custom_forward_and_input_grads_match_reference(port_op, ref_op,
                                                        shape, labels, attrs):
    rng = np.random.RandomState(0)
    xs = [rng.randn(*shape).astype(np.float32)]
    if labels:
        xs.append(_labels(rng, shape[0], shape[1]))
    head = rng.randn(*shape).astype(np.float32)
    want, want_grads = _reference(ref_op, xs, head, attrs)
    got, got_grads = _port(port_op, xs, head, attrs)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert len(got_grads) == len(want_grads)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# ------------------------------------------------- through Module

def _traced_loss_net(sym, op_type):
    data = sym.Variable("data")
    label = sym.Variable("label")
    h = sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = sym.Activation(h, act_type="tanh")
    h = sym.FullyConnected(h, num_hidden=C, name="fc2")
    return sym.Custom(h, label, op_type=op_type, name="loss")


def _host_loss_net(sym):
    data = sym.Variable("data")
    f1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    a1 = sym.Activation(f1, act_type="tanh")
    f2 = sym.FullyConnected(a1, num_hidden=2, name="fc2")
    return sym.Custom(data=f2, name="softmax", op_type="test_softmax")


def _fit_pair(jsym, psym, label_name, shapes, lr):
    bind = dict(data_shapes=[("data", shapes[0])],
                label_shapes=[(label_name, shapes[1])])
    jm = mx.mod.Module(jsym, context=mx.cpu(), data_names=["data"],
                       label_names=[label_name])
    jm.bind(**bind)
    jm.init_params(mx.init.Xavier())
    jm.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": lr})
    pm = mt.mod.Module(psym, context=mt.cpu(), data_names=["data"],
                       label_names=[label_name])
    pm.bind(**bind)
    pm.set_params({k: v.asnumpy() for k, v in jm.get_params()[0].items()})
    pm.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": lr})
    return jm, pm


def _steps_match(jm, pm, x, y, steps):
    for _ in range(steps):
        jm._fit_step(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]))
        pm._fit_step(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                     [mt.nd.array(y, ctx=mt.cpu())]))
        np.testing.assert_allclose(pm.get_outputs()[0].asnumpy(),
                                   jm.get_outputs()[0].asnumpy(), atol=1e-5)
    ja, pa = jm.get_params()[0], pm.get_params()[0]
    assert sorted(ja) == sorted(pa)
    for name in ja:
        np.testing.assert_allclose(pa[name].asnumpy(), ja[name].asnumpy(),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("port_op", ["traced_softmax_loss",
                                     "rtc_softmax_loss"])
def test_traced_loss_five_fit_steps_match_reference(port_op):
    """test_traced_custom_loss_module_fit's network, five steps."""
    jm, pm = _fit_pair(_traced_loss_net(mx.sym, "traced_softmax_loss"),
                       _traced_loss_net(mt.sym, port_op), "label",
                       [(N, 6), (N,)], 0.5)
    rng = np.random.RandomState(0)
    x = rng.randn(N, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0).astype(np.float32)
    _steps_match(jm, pm, x, y, 5)


def test_host_loss_fit_steps_match_reference():
    """test_custom_symbol_module_fit's network (host path, the label
    input made by the Custom symbol), three steps."""
    jsym, psym = _host_loss_net(mx.sym), _host_loss_net(mt.sym)
    assert psym.list_arguments() == jsym.list_arguments()
    assert "softmax_label" in psym.list_arguments()
    jm, pm = _fit_pair(jsym, psym, "softmax_label", [(50, 2), (50,)], 0.5)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.float32)
    _steps_match(jm, pm, x, y, 3)


# ------------------------------------------------- symbol and errors

def test_custom_infer_shape_through_symbol():
    data = mt.sym.Variable("data")
    out = mt.sym.Custom(data=data, op_type="test_softmax", name="cs")
    arg_shapes, out_shapes, _ = out.infer_shape(data=(8, 5))
    args = out.list_arguments()
    assert args == ["data", "cs_label"]
    assert arg_shapes[args.index("cs_label")] == (8,)
    assert out_shapes == [(8, 5)]
    assert out.list_outputs() == ["cs_output"]


def test_unregistered_op_type_raises():
    with pytest.raises(KeyError, match="no_such_custom"):
        mt.nd.Custom(mt.nd.zeros((2, 2), ctx=mt.cpu()),
                     op_type="no_such_custom")
    with pytest.raises(KeyError, match="no_such_custom"):
        mt.sym.Custom(mt.sym.Variable("data"), op_type="no_such_custom")


def test_register_expects_a_prop_class():
    with pytest.raises(TypeError, match="CustomOpProp"):
        mt.operator.register("not_a_prop")(object)
    with pytest.raises(KeyError, match="not_a_prop"):
        mt.operator.get_prop_class("not_a_prop")


def test_loss_without_backward_traced_raises():
    x = mt.nd.array(np.zeros((2, 3)), ctx=mt.cpu())
    with pytest.raises(ValueError, match="need_top_grad=False"):
        mt.nd.Custom(x, op_type="loss_without_backward")


def test_traced_forward_is_held_to_infer_shape():
    with pytest.raises(ValueError, match="infer_shape"):
        mt.nd.Custom(mt.nd.array(np.zeros((2, 3)), ctx=mt.cpu()),
                     op_type="first_row_only")
