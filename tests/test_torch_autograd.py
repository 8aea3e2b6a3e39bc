"""The port's imperative autograd (``mxnet_tpu_torch.autograd``) against
the reference's.

Each case of ``tests/test_autograd.py`` and
``tests/test_autograd_semantics.py`` whose ops the port has runs the
same numpy-seeded inputs through both packages (the port on the CPU,
``device_scope("cpu")``); gradients agree within 1e-6 of their largest
magnitude (f32: the same formulas, at most a few hundred terms summed
in another order). The reference's tape-pruning case has no counterpart
(the port keeps no tape) and its ``IdentityAttachKLSparseReg`` case is
held by ``tests/test_torch_ops_nn_heads.py``. Its
``stochastic_activation_pruning`` case draws from each package's own
generator, so it holds the port to the reference's rule (the gradient
into ``act`` is the forward's mask, into ``prob`` zeros) and, where the
draw is forced (one-hot ``prob`` rows), to the reference's values.

Dropout cannot draw jax's bits, so it is held by distribution: the kept
share within a binomial bound, the kept values scaled by 1/(1-p), and
the backward through the forward's mask. Error cases are held by
exception type. Last, a small HybridBlock calling ``F.FlashAttention``
under ``autograd.record()`` against the reference's ``nd.FlashAttention``
(its Pallas kernels in interpret mode): on the CPU the port runs the
kernels' plain versions; ``chip_smoke.py`` runs the same block on the
card through the CUDA kernels.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.device_scope("cpu"):
        yield


def _both(case):
    """Run ``case(pkg)`` in both packages; returns (reference, port) as
    lists of numpy arrays."""
    def run(pkg):
        out = case(pkg)
        out = out if isinstance(out, (list, tuple)) else [out]
        return [np.asarray(o.asnumpy() if hasattr(o, "asnumpy") else o,
                           dtype=np.float64) for o in out]
    return run(mx), run(mt)


def _agree(case, rtol=RTOL):
    want, got = _both(case)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale)
    return got


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------ tests/test_autograd.py

def test_simple_grad():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x + 2 * x
        y.backward()
        return x.grad
    got = _agree(case)
    np.testing.assert_allclose(got[0], [4.0, 6.0, 8.0])


def test_chain_rule_through_ops():
    xs = np.random.default_rng(1).random((3, 4)).astype(np.float32)

    def case(pkg):
        x = pkg.nd.array(xs)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.exp(pkg.nd.sum(x * x))
        y.backward()
        return x.grad
    _agree(case)


def test_head_grads():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = 3 * x
        y.backward(pkg.nd.array([10.0, 100.0]))
        return x.grad
    got = _agree(case)
    np.testing.assert_allclose(got[0], [30.0, 300.0])


def test_grad_req_add_and_null():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        gx = pkg.nd.zeros((2,))
        pkg.autograd.mark_variables([x], [gx], grad_reqs="add")
        for k in (2, 3):
            with pkg.autograd.record():
                y = x * k
            y.backward()
        z = pkg.nd.array([1.0])
        gz = pkg.nd.zeros((1,))
        pkg.autograd.mark_variables([z], [gz], grad_reqs="null")
        with pkg.autograd.record():
            w = z * 5
        w.backward()
        return gx, gz
    got = _agree(case)
    np.testing.assert_allclose(got[0], [5.0, 5.0])
    np.testing.assert_allclose(got[1], [0.0])


def test_multiple_variables():
    def case(pkg):
        a = pkg.nd.array([2.0])
        b = pkg.nd.array([3.0])
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            c = a * b + a
        c.backward()
        return a.grad, b.grad
    got = _agree(case)
    assert got[0][0] == 4.0 and got[1][0] == 2.0


def test_training_mode_flags():
    for pkg in (mx, mt):
        ag = pkg.autograd
        assert not ag.is_training() and not ag.is_recording()
        with ag.record():
            assert ag.is_training() and ag.is_recording()
            with ag.pause():
                assert not ag.is_recording() and not ag.is_training()
            with ag.pause(train_mode=True):
                assert not ag.is_recording() and ag.is_training()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        with ag.train_mode():
            assert ag.is_training()
            with ag.predict_mode():
                assert not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True


def test_retain_graph():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy().copy()
        y.backward()
        return g1, x.grad
    got = _agree(case)
    np.testing.assert_allclose(got[0], got[1])


def test_softmax_output_backward_semantics():
    xs = _rand((4, 5), 2)

    def case(pkg):
        x = pkg.nd.array(xs)
        label = pkg.nd.array([0, 1, 2, 3])
        x.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.SoftmaxOutput(x, label)
        out.backward()
        return out, x.grad
    _agree(case)


def test_stochastic_activation_pruning_backward():
    """The reference's case (``tests/test_autograd.py``): backward gives
    ``act`` the forward's mask (out / act) and ``prob`` zeros. Each
    package draws its own sample, so each is held to that rule, and on
    one-hot ``prob`` rows (a forced draw) to each other's values."""
    rng = np.random.RandomState(0)
    act_np = rng.rand(4, 20).astype("f") + 1
    for prob_np in (np.full((4, 20), 0.05, dtype="f"),
                    np.eye(4, 20, 3, dtype="f")):
        def case(pkg):
            act, prob = pkg.nd.array(act_np), pkg.nd.array(prob_np)
            act.attach_grad()
            prob.attach_grad()
            with pkg.autograd.record():
                out = pkg.nd.stochastic_activation_pruning(act, prob,
                                                           frac=0.5)
            out.backward()
            mask = out.asnumpy() / act.asnumpy()
            np.testing.assert_allclose(act.grad.asnumpy(), mask, rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(prob.grad.asnumpy(), 0.0, atol=1e-6)
            return out, act.grad
        if prob_np[0].max() == 1.0:
            _agree(case)
        else:
            _both(case)


def test_attach_grad_detach():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * 2).detach()
            z = x * 3
        z.backward()
        return x.grad, y
    got = _agree(case)
    np.testing.assert_allclose(got[0], [3.0, 3.0])


def test_positional_const_args():
    def case(pkg):
        x = pkg.nd.array(np.arange(12, dtype=np.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.reshape(x, shape=(3, 4))
            loss = (y * y).sum()
        loss.backward()
        return x.grad
    got = _agree(case)
    np.testing.assert_allclose(got[0], 2 * np.arange(12))


# ---------------------------------------- tests/test_autograd_semantics.py

def test_post_record_mutation_uses_recorded_value():
    def case(pkg):
        p = pkg.nd.array([2.0])
        p.attach_grad()
        with pkg.autograd.record():
            q = p * p
        p[:] = 100.0
        q.backward()
        return p.grad, p
    got = _agree(case)
    assert got[0][0] == 4.0 and got[1][0] == 100.0


def test_inplace_mul_chains_gradient():
    def case(pkg):
        w = pkg.nd.array([2.0])
        w.attach_grad()
        with pkg.autograd.record():
            x = w * 3.0
            x *= 2.0
            y = x.sum()
        y.backward()
        return w.grad, x
    got = _agree(case)
    assert got[0][0] == 6.0


def test_inplace_add_ndarray_chains_gradient():
    def case(pkg):
        w = pkg.nd.array([1.0, 2.0])
        w.attach_grad()
        with pkg.autograd.record():
            x = w * 2.0
            x += w
            y = (x * x).sum()
        y.backward()
        return w.grad
    got = _agree(case)
    np.testing.assert_allclose(got[0], [18.0, 36.0])


def test_setitem_outside_tape_does_not_corrupt():
    def case(pkg):
        p = pkg.nd.array([3.0])
        p.attach_grad()
        with pkg.autograd.record():
            q = p * p
            p[:] = 7.0
            r = p * p
            y = q + r
        y.backward()
        return p.grad
    got = _agree(case)
    assert got[0][0] == 20.0


def test_backward_only_consumes_own_subgraph():
    def case(pkg):
        a = pkg.nd.array([2.0])
        b = pkg.nd.array([3.0])
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            x = a * a
            y = b * b * b
        x.backward()
        ga = a.grad.asnumpy().copy()
        y.backward()
        return ga, b.grad
    got = _agree(case)
    assert got[0][0] == 4.0 and got[1][0] == 27.0


def test_retain_graph_allows_double_backward():
    def case(pkg):
        a = pkg.nd.array([2.0])
        a.attach_grad()
        with pkg.autograd.record():
            x = a * a
        x.backward(retain_graph=True)
        g1 = a.grad.asnumpy().copy()
        x.backward()
        return g1, a.grad
    got = _agree(case)
    assert got[0][0] == 4.0 and got[1][0] == 4.0


def test_grad_req_add_accumulates():
    def case(pkg):
        a = pkg.nd.array([2.0])
        grad = pkg.nd.zeros((1,))
        pkg.autograd.mark_variables([a], [grad], "add")
        for _ in range(3):
            with pkg.autograd.record():
                x = a * a
            x.backward()
        return a.grad
    got = _agree(case)
    assert got[0][0] == 12.0


def test_aux_state_recorded_before_commit():
    xs = _rand((4, 3), 3)

    def case(pkg):
        data = pkg.nd.array(xs)
        gamma = pkg.nd.ones((3,))
        beta = pkg.nd.zeros((3,))
        mmean = pkg.nd.zeros((3,))
        mvar = pkg.nd.ones((3,))
        data.attach_grad()
        with pkg.autograd.record(train_mode=False):
            out = pkg.nd.BatchNorm(data, gamma, beta, mmean, mvar,
                                   use_global_stats=True, fix_gamma=False)
            loss = (out * out).sum()
        mmean[:] = 5.0
        mvar[:] = 9.0
        loss.backward()
        return data.grad, mmean, mvar
    got = _agree(case)
    np.testing.assert_allclose(got[0], 2 * xs / (1 + 1e-3), rtol=1e-4)
    assert (got[1] == 5.0).all() and (got[2] == 9.0).all()


def test_aux_commit_under_training_record():
    """A training BatchNorm under record commits its moving statistics
    once, and the gradient is the batch-statistics one."""
    xs = _rand((6, 3), 4)

    def case(pkg):
        data = pkg.nd.array(xs)
        gamma = pkg.nd.array([0.5, 1.0, 2.0])
        beta = pkg.nd.zeros((3,))
        mmean = pkg.nd.zeros((3,))
        mvar = pkg.nd.ones((3,))
        data.attach_grad()
        gamma.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.BatchNorm(data, gamma, beta, mmean, mvar,
                                   fix_gamma=False, momentum=0.9)
            loss = (out * out * out).sum()
        loss.backward()
        return data.grad, gamma.grad, mmean, mvar
    _agree(case, rtol=1e-5)


def test_custom_function():
    def case(pkg):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = 1.0 / (1.0 + pkg.nd.exp(-x))
                self.saved = y
                return y

            def backward(self, dy):
                y = self.saved
                return dy * y * (1.0 - y)

        x = pkg.nd.array([0.0, 1.0, -2.0])
        x.attach_grad()
        with pkg.autograd.record():
            z = Sigmoid()(x).sum()
        z.backward()
        return x.grad
    got = _agree(case)
    s = 1.0 / (1.0 + np.exp(-np.array([0.0, 1.0, -2.0])))
    np.testing.assert_allclose(got[0], s * (1 - s), rtol=1e-6)


def test_function_backward_differs_from_derivative():
    """The port's Function uses the user's backward, not autograd of the
    forward: a straight-through round."""
    class RoundST(mt.autograd.Function):
        def forward(self, x):
            return mt.nd.round(x)

        def backward(self, dy):
            return dy * 1.0

    x = mt.nd.array([0.2, 1.7, -2.6])
    x.attach_grad()
    with mt.autograd.record():
        y = (RoundST()(x) * mt.nd.array([1.0, 2.0, 3.0])).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [1.0, 2.0, 3.0])
    np.testing.assert_allclose(RoundST()(x).asnumpy(), [0.0, 2.0, -3.0])


def test_elemwise_chain_gradient():
    xs, ys = _rand((3, 4), 5), _rand((3, 4), 6)

    def case(pkg):
        x, y = pkg.nd.array(xs), pkg.nd.array(ys)
        x.attach_grad()
        y.attach_grad()
        with pkg.autograd.record():
            z = (x * y + pkg.nd.tanh(x)).sum()
        z.backward()
        return x.grad, y.grad
    _agree(case)


def test_fully_connected_gradient():
    d, w, b = _rand((2, 5), 7), _rand((4, 5), 8), _rand((4,), 9)

    def case(pkg):
        arrs = [pkg.nd.array(a) for a in (d, w, b)]
        for a in arrs:
            a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.FullyConnected(*arrs, num_hidden=4)
            loss = (out * out).sum()
        loss.backward()
        return [out] + [a.grad for a in arrs]
    _agree(case)


def test_convolution_gradient():
    d, w, b = _rand((1, 2, 5, 5), 10), _rand((2, 2, 3, 3), 11), \
        _rand((2,), 12)

    def case(pkg):
        arrs = [pkg.nd.array(a) for a in (d, w, b)]
        for a in arrs:
            a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.Convolution(*arrs, kernel=(3, 3), num_filter=2,
                                     pad=(1, 1))
            loss = (out * out).sum()
        loss.backward()
        return [out] + [a.grad for a in arrs]
    _agree(case)


def test_batchnorm_train_mode_gradient():
    d = _rand((8, 3), 13)
    g = np.random.default_rng(14).random(3).astype(np.float32) + 0.5
    b = _rand((3,), 15)

    def case(pkg):
        arrs = [pkg.nd.array(a) for a in (d, g, b)]
        for a in arrs:
            a.attach_grad()
        mm, mv = pkg.nd.zeros((3,)), pkg.nd.ones((3,))
        with pkg.autograd.record(train_mode=False):
            with pkg.autograd.train_mode():
                out = pkg.nd.BatchNorm(*arrs, mm, mv, fix_gamma=False,
                                       momentum=0.9)
            loss = (out * out * out).sum()
        loss.backward()
        return [out, mm, mv] + [a.grad for a in arrs]
    _agree(case, rtol=1e-5)


def test_softmax_output_matches_ce_gradient_3d():
    rng = np.random.RandomState(0)
    data = rng.randn(2, 3, 4).astype(np.float32)
    label = rng.randint(0, 12, size=(2,)).astype(np.float32)

    def case(pkg):
        d = pkg.nd.array(data)
        d.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.SoftmaxOutput(d, pkg.nd.array(label))
        out.backward()
        return d.grad
    _agree(case)


def test_grad_leaves_buffers_untouched():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x).sum()
        g = pkg.autograd.grad(y, [x])[0]
        return g, x.grad
    got = _agree(case)
    np.testing.assert_allclose(got[0], [3.0, 12.0, 27.0])
    np.testing.assert_allclose(got[1], [0.0, 0.0, 0.0])


def test_grad_create_graph_second_order():
    x = mt.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mt.autograd.record():
        y = (x * x * x).sum()
        g = mt.autograd.grad(y, x, create_graph=True)
        z = g.sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [6.0, 12.0, 18.0])


# ------------------------------------------------------------- the gate

def test_nothing_records_outside_record():
    x = mt.nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 2 + mt.nd.exp(x)
    assert not y.data.requires_grad
    with mt.autograd.record():
        z = x * 2 + mt.nd.exp(x)
        with mt.autograd.pause():
            w = x * 3
    assert z.data.requires_grad and not w.data.requires_grad


def test_trainer_like_inplace_update_after_backward():
    """An in-place update of a marked leaf after backward (what a
    Trainer does) leaves the next step's gradient right."""
    w = mt.nd.array([1.0, 2.0])
    w.attach_grad()
    for _ in range(2):
        with mt.autograd.record():
            y = (w * w).sum()
        y.backward()
        with torch.no_grad():
            w.data.sub_(0.1 * w.grad.data)
    np.testing.assert_allclose(w.grad.asnumpy(), [1.6, 3.2], rtol=1e-6)


# ------------------------------------------------------------- dropout

@pytest.mark.parametrize("p", [0.5, 0.2])
def test_dropout_by_distribution(p):
    n = 20000
    mt.random.seed(3)
    x = mt.nd.array(np.ones((100, n // 100), np.float32))
    x.attach_grad()
    with mt.autograd.record():
        y = mt.nd.Dropout(x, p=p)
        loss = (y * mt.nd.array(np.arange(n, dtype=np.float32)
                                .reshape(100, -1))).sum()
    loss.backward()
    yv = y.asnumpy()
    kept = yv != 0
    # the kept share within 5 standard deviations of a binomial(n, 1-p)
    sd = np.sqrt(n * p * (1 - p))
    assert abs(kept.sum() - n * (1 - p)) < 5 * sd
    np.testing.assert_allclose(yv[kept], 1.0 / (1 - p), rtol=1e-6)
    # backward through the forward's mask
    want = np.where(kept, np.arange(n).reshape(100, -1) / (1 - p), 0.0)
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-6)
    # a seeded run draws the same mask again
    mt.random.seed(3)
    with mt.autograd.record():
        y2 = mt.nd.Dropout(x, p=p)
    np.testing.assert_array_equal(y2.asnumpy(), yv)


def test_dropout_follows_the_training_flag():
    x = mt.nd.array(np.ones((50, 50), np.float32))
    with mt.autograd.record(train_mode=False):
        np.testing.assert_array_equal(mt.nd.Dropout(x, p=0.5).asnumpy(), 1.0)
    with mt.autograd.pause(train_mode=True):
        y = mt.nd.Dropout(x, p=0.5)
    assert (y.asnumpy() == 0).any() and not y.data.requires_grad
    np.testing.assert_array_equal(mt.nd.Dropout(x, p=0.5).asnumpy(), 1.0)
    assert (mt.nd.Dropout(x, p=0.5, mode="always").asnumpy() == 0).any()


# ------------------------------------------------------------- errors

@pytest.mark.parametrize("pkg", [mx, mt], ids=["reference", "port"])
def test_backward_without_marked_variable_raises(pkg):
    x = pkg.nd.array([1.0, 2.0])
    with pkg.autograd.record():
        y = x * 2
    with pytest.raises(ValueError):
        y.backward()


@pytest.mark.parametrize("pkg", [mx, mt], ids=["reference", "port"])
def test_backward_of_unrecorded_head_raises(pkg):
    x = pkg.nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 2
    with pytest.raises(ValueError):
        y.backward()


@pytest.mark.parametrize("pkg", [mx, mt], ids=["reference", "port"])
def test_second_backward_without_retain_raises(pkg):
    x = pkg.nd.array([1.0, 2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x).sum()
    y.backward()
    with pytest.raises(ValueError):
        y.backward()


@pytest.mark.parametrize("pkg", [mx, mt], ids=["reference", "port"])
def test_function_with_wrong_gradient_count_raises(pkg):
    class Two(pkg.autograd.Function):
        def forward(self, a, b):
            return a * b

        def backward(self, dy):
            return dy

    a, b = pkg.nd.array([1.0]), pkg.nd.array([2.0])
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        y = Two()(a, b)
    with pytest.raises(ValueError):
        y.backward()


def test_port_error_types():
    x = mt.nd.array([1.0])
    with pytest.raises(ValueError):
        mt.autograd.mark_variables([x], [mt.nd.zeros((1,))], "sum")
    with pytest.raises(ValueError):
        mt.nd.array([1, 2], dtype="int32").attach_grad()
    with pytest.raises(ValueError):
        mt.autograd.grad(x * 2, [x])
    with pytest.raises(ValueError):
        bool(mt.nd.array([1.0, 2.0]))
    with pytest.raises(ValueError):
        mt.nd.array([1.0, 2.0]).asscalar()


# ------------------------------------------- the tape drives attention

def test_flash_attention_block_under_record_matches_reference():
    """A HybridBlock calling ``F.FlashAttention(q, k, v, causal=True)``,
    recorded and differentiated, against the reference's
    ``nd.FlashAttention`` (Pallas kernels in interpret mode) under its
    ``autograd.record``: outputs and the gradients of q, k and v."""
    b, h, s, d = 1, 2, 64, 32
    qkv = [_rand((b, h, s, d), 20 + i) for i in range(3)]
    head = _rand((b, h, s, d), 23)

    class Attn(mt.gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v):
            return F.FlashAttention(q, k, v, causal=True)

    block = Attn(prefix="attn_")
    block.hybridize()
    arrs = [mt.nd.array(a) for a in qkv]
    for a in arrs:
        a.attach_grad()
    with mt.autograd.record():
        out = block(*arrs)
    out.backward(mt.nd.array(head))
    got = [out.asnumpy()] + [a.grad.asnumpy() for a in arrs]

    jarrs = [mx.nd.array(a) for a in qkv]
    for a in jarrs:
        a.attach_grad()
    with mx.autograd.record():
        jout = mx.nd.FlashAttention(*jarrs, causal=True, interpret=True)
    jout.backward(mx.nd.array(head))
    want = [jout.asnumpy()] + [a.grad.asnumpy() for a in jarrs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_entry_points_raise_without_a_gpu():
    """Outside a device scope, an array made without ``ctx`` lands on
    the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with mt.device_scope("cpu"):
        pass
    import mxnet_tpu_torch.context as context
    stack = context._stack()
    saved = list(stack)
    stack.clear()
    try:
        with pytest.raises(MXNetError):
            mt.nd.array([1.0])
        with pytest.raises(MXNetError):
            mt.nd.ones((2,))
    finally:
        stack.extend(saved)
