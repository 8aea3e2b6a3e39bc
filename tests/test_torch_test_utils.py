"""The port's testing oracles (``mxnet_tpu_torch.test_utils``) against
the reference's (``mxnet_tpu.test_utils``), on the CPU.

Each function runs in both packages on the same numpy inputs: the
comparisons (``same``, ``almost_equal``, ``assert_almost_equal``) give
the same verdicts and name the same worst element; ``random_arrays`` /
``rand_ndarray`` draw the same values from the same global numpy state;
``numeric_grad`` is exact (the same float64 arithmetic);
``check_numeric_gradient``, ``check_symbolic_forward`` and
``check_symbolic_backward`` pass on a right function and raise
``AssertionError`` on a wrong one in both; ``check_consistency``
returns what the reference returns, to 1e-6 (f32 ops in another
order). ``default_context`` follows the current context and never falls
back to the host.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import MXNetError

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_the_host():
    with mt.cpu():
        yield


def both(fn):
    """``fn(pkg, tu)`` for each package: (reference, port)."""
    return fn(mx, jtu), fn(mt, tu)


@pytest.mark.parametrize("rtol,atol", [(1e-5, 1e-8), (1e-2, 1e-3)])
def test_comparisons_agree(rtol, atol):
    rng = np.random.RandomState(0)
    a = rng.randn(4, 5).astype(np.float32)
    b = a + rng.randn(4, 5).astype(np.float32) * 1e-3
    assert tu.same(a, a.copy()) and not tu.same(a, b)
    assert tu.same(a, b) == jtu.same(a, b)
    assert tu.almost_equal(a, b, rtol, atol) == \
        jtu.almost_equal(a, b, rtol, atol)
    assert tu.almost_equal(mt.nd.array(a), a)

    def verdict(t):
        try:
            t.assert_almost_equal(a, b, rtol=rtol, atol=atol)
        except AssertionError as exc:
            return str(exc)
        return None

    assert verdict(tu) == verdict(jtu)
    with pytest.raises(AssertionError, match="shape mismatch"):
        tu.assert_almost_equal(a, a[:2])


def test_random_arrays_and_rand_ndarray_draw_the_same_values():
    def draw(pkg, t):
        np.random.seed(7)
        arrays = t.random_arrays((2, 3), (), (4,))
        return arrays + [t.rand_ndarray((3, 2)).asnumpy()]

    want, got = both(draw)
    assert [a.shape for a in got] == [(2, 3), (), (4,), (3, 2)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_numeric_grad_is_exact():
    loc = {"x": np.linspace(-1, 1, 6).reshape(2, 3)}

    def f(v):
        return float(np.sum(np.sin(v["x"]) * v["x"]))

    want = jtu.numeric_grad(f, {"x": loc["x"].copy()}, ["x"], eps=1e-4)
    got = tu.numeric_grad(f, {"x": loc["x"].copy()}, ["x"], eps=1e-4)
    np.testing.assert_array_equal(got["x"], want["x"])
    np.testing.assert_allclose(got["x"], np.sin(loc["x"]) +
                               loc["x"] * np.cos(loc["x"]), rtol=1e-6)


def fc_symbol(pkg):
    x = pkg.sym.Variable("x")
    h = pkg.sym.FullyConnected(x, num_hidden=3, name="fc")
    return pkg.sym.Activation(h, act_type="tanh", name="act")


def fc_location():
    rng = np.random.RandomState(2)
    return {"x": rng.randn(2, 4).astype(np.float32),
            "fc_weight": rng.randn(3, 4).astype(np.float32) * 0.5,
            "fc_bias": rng.randn(3).astype(np.float32) * 0.1}


def test_check_numeric_gradient_of_a_symbol_and_a_callable():
    both(lambda pkg, t: t.check_numeric_gradient(fc_symbol(pkg),
                                                 fc_location()))
    both(lambda pkg, t: t.check_numeric_gradient(
        lambda a, b: pkg.nd.dot(a, b),
        [np.random.RandomState(3).randn(2, 3),
         np.random.RandomState(4).randn(3, 2)]))


def _register_wrong(pkg, name):
    """A custom op ``x * x`` whose backward is twice the true gradient,
    in ``pkg``'s registry."""
    @pkg.operator.register(name)
    class Prop(pkg.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Op(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * in_data[0] * 4.0)
            return Op()
    return Prop


def test_check_numeric_gradient_fails_where_the_reference_fails():
    _register_wrong(mx, "tu_wrong_square")
    _register_wrong(mt, "tu_wrong_square")
    loc = {"x": np.random.RandomState(5).randn(3, 2).astype(np.float32)}
    for pkg, t in ((mx, jtu), (mt, tu)):
        s = pkg.sym.Custom(pkg.sym.Variable("x"), op_type="tu_wrong_square")
        with pytest.raises(AssertionError, match="autograd\\[x\\]"):
            t.check_numeric_gradient(s, loc)


def test_check_symbolic_forward_and_backward():
    loc = fc_location()
    x, w, b = loc["x"], loc["fc_weight"], loc["fc_bias"]
    pre = x @ w.T + b
    out = np.tanh(pre)
    head = np.random.RandomState(6).randn(*out.shape).astype(np.float32)
    dpre = head * (1 - out ** 2)
    grads = {"x": dpre @ w, "fc_weight": dpre.T @ x, "fc_bias": dpre.sum(0)}

    def run(pkg, t):
        s = fc_symbol(pkg)
        t.check_symbolic_forward(s, loc, [out], rtol=1e-5, atol=1e-6)
        t.check_symbolic_backward(s, loc, [head], grads, rtol=1e-5,
                                  atol=1e-6)
        t.check_symbolic_backward(s, loc, [head], [grads["fc_bias"]],
                                  grad_nodes=["fc_bias"], rtol=1e-5,
                                  atol=1e-6)
        with pytest.raises(AssertionError):
            t.check_symbolic_forward(s, loc, [out * 1.01])
        with pytest.raises(AssertionError):
            t.check_symbolic_backward(s, loc, [head],
                                      dict(grads, x=grads["x"] + 0.1))
        with pytest.raises(AssertionError, match="shape mismatch"):
            t.check_symbolic_forward(s, loc, [out[:1]])

    both(run)


def test_check_consistency_matches_the_reference():
    rng = np.random.RandomState(8)
    loc = {"a": rng.randn(3, 4).astype(np.float32),
           "b": rng.randn(4, 2).astype(np.float32)}
    want, got = both(lambda pkg, t: t.check_consistency(
        lambda a, b: pkg.nd.relu(pkg.nd.dot(a, b)), loc,
        ctx_list=[pkg.cpu(0), pkg.cpu(0)]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    # a disagreement between contexts fails
    calls = []

    def drifting(a):
        calls.append(1)
        return a * (1.0 + 0.1 * len(calls))

    with pytest.raises(AssertionError):
        tu.check_consistency(drifting, {"a": loc["a"]},
                             ctx_list=[mt.cpu(0), mt.cpu(0)])


def test_check_consistency_runs_fn_inside_each_context():
    seen = []

    def fn(a):
        seen.append(mt.current_context())
        return a + mt.nd.ones(a.shape)     # made on the scope's device

    tu.check_consistency(fn, {"a": np.zeros((2, 2), np.float32)},
                         ctx_list=[mt.cpu(0)])
    assert seen == [mt.cpu(0)]


def test_default_context_follows_the_current_context(monkeypatch):
    monkeypatch.delenv("MXNET_TEST_DEFAULT_CTX", raising=False)
    assert tu.default_context() == mt.cpu(0)          # the autouse scope
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CTX", "cpu:0")
    assert tu.default_context() == mt.cpu(0)
    tu.set_default_context(mt.gpu(0))
    try:
        assert tu.default_context() == mt.gpu(0)
    finally:
        tu.set_default_context(None)


def test_default_context_never_falls_back_to_the_host(monkeypatch):
    """Outside a CPU scope and without a card, the reference falls back
    to ``cpu(0)``; the port raises."""
    monkeypatch.delenv("MXNET_TEST_DEFAULT_CTX", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import threading
    box = {}

    def outside_any_scope():       # scopes are per thread
        try:
            box["ctx"] = tu.default_context()
        except MXNetError as exc:
            box["exc"] = exc

    t = threading.Thread(target=outside_any_scope)
    t.start()
    t.join(30)
    assert "exc" in box and "no CUDA device" in str(box["exc"])
