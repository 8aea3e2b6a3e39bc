"""``autograd.backward`` through ops without a gradient (ROADMAP C8),
against the reference's tape.

The reference makes every marked array that a recorded op consumed on
the way to the heads a seed of its ``jax.vjp``: an array that reaches
the heads only through ``argmax``, a comparison or ``BlockGrad`` gets a
zero gradient, written under ``grad_req="write"`` and added (so the
buffer keeps its values) under ``"add"``. Before the repair the port
skipped such an array, so its buffer kept the previous backward's
values, and raised when no marked array reached the heads
differentiably. A sampler is not recorded in either package, and an
array used outside ``record()`` reaches nothing.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def _arrays(pkg, req, *values):
    kw = {"ctx": mt.cpu()} if pkg is mt else {}
    out = []
    for v in values:
        a = pkg.nd.array(v, **kw)
        a.attach_grad(req)
        out.append(a)
    return out


def _both(fn):
    """``fn(pkg)`` in both packages; returns (reference, port)."""
    return fn(mx), fn(mt)


def _assert_same(pair):
    want, got = pair
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("req", ["write", "add"])
def test_repro_argmax_after_a_differentiable_pass(req):
    """backward of sum(x*x) + sum(y*y), then of sum(x*x) + argmax(y): the
    reference gives y.grad = [0, 0, 0] under write and keeps [2, 6, 4]
    under add."""
    def run(pkg):
        x, y = _arrays(pkg, req, [1.0, 2.0, 3.0], [1.0, 3.0, 2.0])
        with pkg.autograd.record():
            loss = (x * x).sum() + (y * y).sum()
        loss.backward()
        with pkg.autograd.record():
            loss = (x * x).sum() + pkg.nd.argmax(y, axis=0)
        loss.backward()
        return [x.grad.asnumpy(), y.grad.asnumpy()]
    pair = _both(run)
    _assert_same(pair)
    want_y = [0.0, 0.0, 0.0] if req == "write" else [2.0, 6.0, 4.0]
    np.testing.assert_array_equal(pair[1][1], want_y)


@pytest.mark.parametrize("req", ["write", "add"])
@pytest.mark.parametrize("op", ["argmax", "greater", "BlockGrad",
                                "ones_like", "argmin"])
def test_only_a_non_differentiable_path(req, op):
    """The heads reach the marked array through one op without a
    gradient: no error, and a zero gradient per ``grad_req``."""
    def run(pkg):
        z, = _arrays(pkg, req, [1.0, 3.0, 2.0])
        z.grad[:] = 5.0
        with pkg.autograd.record():
            if op == "argmax":
                h = pkg.nd.argmax(z, axis=0)
            elif op == "argmin":
                h = pkg.nd.argmin(z, axis=0) * 2.0
            elif op == "greater":
                h = (z > 1.5).sum()
            elif op == "BlockGrad":
                h = pkg.nd.BlockGrad(z * 3.0).sum()
            else:
                h = pkg.nd.ones_like(z).sum()
        h.backward()
        return [z.grad.asnumpy()]
    pair = _both(run)
    _assert_same(pair)
    np.testing.assert_array_equal(pair[1][0],
                                  [0.0] * 3 if req == "write" else [5.0] * 3)


def test_a_chain_through_argmax_into_a_product():
    """argmax(y) scales x: x's gradient is argmax(y), y's zero."""
    def run(pkg):
        x, y = _arrays(pkg, "write", [1.0, 2.0, 3.0], [1.0, 3.0, 2.0])
        with pkg.autograd.record():
            loss = (x * pkg.nd.argmax(y, axis=0)).sum()
        loss.backward()
        return [x.grad.asnumpy(), y.grad.asnumpy()]
    pair = _both(run)
    _assert_same(pair)
    np.testing.assert_array_equal(pair[1][0], [1.0, 1.0, 1.0])


def test_an_array_not_on_the_heads_path_is_left_alone():
    """A marked array that no op on the heads' path consumed keeps its
    buffer, in both packages."""
    def run(pkg):
        x, w = _arrays(pkg, "write", [1.0, 2.0], [4.0, 4.0])
        w.grad[:] = 7.0
        with pkg.autograd.record():
            loss = (x * x).sum()
            _ = pkg.nd.argmax(w, axis=0)
        loss.backward()
        return [x.grad.asnumpy(), w.grad.asnumpy()]
    pair = _both(run)
    _assert_same(pair)
    np.testing.assert_array_equal(pair[1][1], [7.0, 7.0])


def test_no_marked_array_reaches_the_heads_raises():
    for pkg in (mx, mt):
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        x, = _arrays(pkg, "write", [1.0, 2.0])
        c = pkg.nd.array([3.0, 4.0], **kw)
        with pkg.autograd.record():
            h = (c * 2.0).sum()
        with pytest.raises(ValueError):
            h.backward()


def test_a_sampler_is_not_recorded():
    """``shuffle`` of a marked array under ``record()`` is a constant to
    the tape: the heads reach nothing, in both packages."""
    for pkg in (mx, mt):
        x, = _arrays(pkg, "write", [1.0, 2.0, 3.0])
        with pkg.autograd.record():
            h = pkg.nd.shuffle(x).sum()
        with pytest.raises(ValueError):
            h.backward()


def test_an_array_used_outside_record_reaches_nothing():
    def run(pkg):
        x, y = _arrays(pkg, "write", [1.0, 2.0], [3.0, 1.0])
        y.grad[:] = 9.0
        idx = pkg.nd.argmax(y, axis=0)
        with pkg.autograd.record():
            loss = (x * idx).sum()
        loss.backward()
        return [x.grad.asnumpy(), y.grad.asnumpy()]
    pair = _both(run)
    _assert_same(pair)
    np.testing.assert_array_equal(pair[1][1], [9.0, 9.0])
