"""The ops Gluon's layers and losses call, against the reference's
functions, op by op.

``log_softmax``, ``pick``, the reductions (``sum``, ``mean``, ``prod``,
``max``, ``min`` with ``axis`` / ``keepdims`` / ``exclude``;
``argmax``, ``argmin``, ``norm``), the unary family, ``maximum``,
``broadcast_mul``, ``clip``, ``Cast``, ``BlockGrad``, ``zeros_like`` /
``ones_like``, ``Concat`` / ``stack``, ``LeakyReLU`` (leaky, elu,
prelu, rrelu outside training) and ``Deconvolution`` (1-D to 3-D;
stride, pad, adj, dilate, groups, bias): the same numpy-seeded f32
inputs go through the reference op (``jax.vjp`` of its function) and
the port's (``torch.autograd``), forward and input gradients under one
random cotangent, held to 1e-5 of max(1, the largest magnitude): the
same f32 formulas summed in another order (a bias gradient of
Deconvolution sums a few hundred products to ~33, and lands 1.5e-5,
half a millionth, from the reference's). ``rrelu`` in training draws its slopes, so it is
held by their range.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import get_op as jax_get_op
from mxnet_tpu_torch.ops import get_op

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(seed, shapes, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.standard_normal(s) * scale
        out.append(np.asarray(np.abs(a) + 0.1 if positive else a,
                              dtype=np.float32))
    return out


def _reference(name, arrays, attrs, seed):
    fn = jax_get_op(name).fn
    outs, vjp = jax.vjp(lambda *xs: fn(*xs, **attrs),
                        *[jnp.asarray(a) for a in arrays])
    head = _inputs(seed + 1, [outs.shape])[0]
    grads = vjp(jnp.asarray(head, dtype=outs.dtype)) \
        if jnp.issubdtype(outs.dtype, jnp.floating) else None
    return np.asarray(outs), grads, head


def _check(name, arrays, attrs=None, wrt=None, seed=0):
    attrs = attrs or {}
    wrt = list(range(len(arrays))) if wrt is None else wrt
    want, want_grads, head = _reference(name, arrays, attrs, seed)
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    for i in wrt:
        ts[i].requires_grad_(True)
    out = get_op(name).fn(*ts, **attrs)
    got = out.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    _close(got, want, "output")
    if want_grads is None or not wrt:
        return
    grads = torch.autograd.grad(out, [ts[i] for i in wrt],
                                torch.from_numpy(head), allow_unused=True) \
        if out.requires_grad else [None] * len(wrt)
    for i, g in zip(wrt, grads):
        g = np.zeros_like(arrays[i]) if g is None else g.numpy()
        _close(g, np.asarray(want_grads[i]), "gradient of input %d" % i)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want.astype(np.float64)).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_log_softmax(axis):
    _check("log_softmax", _inputs(0, [(4, 5, 3)]), {"axis": axis})


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (1, True),
                                           (0, False)])
def test_pick(axis, keepdims):
    data = _inputs(1, [(4, 5, 3)])[0]
    shape = tuple(d for i, d in enumerate(data.shape)
                  if i != axis % data.ndim)
    idx = np.random.default_rng(2).integers(
        0, data.shape[axis], shape).astype(np.float32)
    _check("pick", [data, idx], {"axis": axis, "keepdims": keepdims},
           wrt=[0])


REDUCE_CASES = [{}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                {"axis": 0, "exclude": True}, {"axis": -1, "keepdims": True},
                {"axis": (), "exclude": True}]


@pytest.mark.parametrize("name", ["sum", "mean", "prod", "max", "min"])
@pytest.mark.parametrize("attrs", REDUCE_CASES,
                         ids=[str(i) for i in range(len(REDUCE_CASES))])
def test_reductions(name, attrs):
    _check(name, _inputs(3, [(3, 4, 5)], positive=name == "prod"), attrs)


@pytest.mark.parametrize("name", ["argmax", "argmin"])
@pytest.mark.parametrize("attrs", [{}, {"axis": 1}, {"axis": 0,
                                                     "keepdims": True}])
def test_arg_reductions(name, attrs):
    _check(name, _inputs(4, [(3, 4, 5)]), attrs, wrt=[])


@pytest.mark.parametrize("attrs", [{}, {"axis": 1}, {"ord": 1},
                                   {"axis": (0, 1), "keepdims": True}])
def test_norm(attrs):
    _check("norm", _inputs(5, [(3, 4, 5)]), attrs)


UNARY = ["abs", "sign", "square", "exp", "expm1", "sin", "cos", "tanh",
         "sinh", "arctan", "arcsinh", "sigmoid", "relu", "softsign", "erf",
         "floor", "ceil", "round", "trunc", "degrees", "radians"]
UNARY_POSITIVE = ["sqrt", "rsqrt", "log", "log10", "log2", "log1p",
                  "reciprocal", "cbrt", "rcbrt", "gamma", "gammaln",
                  "cosh", "arccosh"]


@pytest.mark.parametrize("name", UNARY + UNARY_POSITIVE)
def test_unary(name):
    pos = name in UNARY_POSITIVE
    data = _inputs(6, [(4, 5)], positive=pos)[0]
    if name == "arccosh":
        data = data + 1.0
    _check(name, [data])


@pytest.mark.parametrize("name", ["arcsin", "arccos", "arctanh", "erfinv"])
def test_unary_on_the_open_unit_interval(name):
    data = np.random.default_rng(7).uniform(-0.9, 0.9, (4, 5)).astype(
        np.float32)
    _check(name, [data])


@pytest.mark.parametrize("name", ["maximum", "broadcast_mul"])
def test_broadcast_binary(name):
    _check(name, _inputs(8, [(3, 4), (1, 4)]))


def test_clip():
    _check("clip", _inputs(9, [(4, 6)], scale=2.0),
           {"a_min": -1.0, "a_max": 0.5})


def test_cast_and_block_grad():
    _check("Cast", _inputs(10, [(3, 4)]), {"dtype": "float16"}, wrt=[])
    _check("BlockGrad", _inputs(11, [(3, 4)]))


@pytest.mark.parametrize("name", ["zeros_like", "ones_like"])
def test_like(name):
    _check(name, _inputs(12, [(3, 4)]))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_concat(dim):
    _check("Concat", _inputs(13, [(2, 3, 4), (2, 3, 4), (2, 3, 4)]),
           {"dim": dim, "num_args": 3})


def test_concat_of_unequal_widths():
    _check("Concat", _inputs(14, [(2, 3, 4), (2, 5, 4)]), {"dim": 1})


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack(axis):
    _check("stack", _inputs(15, [(3, 4), (3, 4)]), {"axis": axis})


@pytest.mark.parametrize("act_type,attrs", [
    ("leaky", {"slope": 0.1}), ("elu", {"slope": 0.7}),
    ("rrelu", {"lower_bound": 0.1, "upper_bound": 0.3})])
def test_leaky_relu(act_type, attrs):
    _check("LeakyReLU", _inputs(16, [(4, 3, 5, 5)]),
           dict(attrs, act_type=act_type))


def test_prelu():
    _check("LeakyReLU", _inputs(17, [(4, 3, 5, 5), (3,)]),
           {"act_type": "prelu"})


def test_rrelu_in_training_draws_slopes_in_range():
    x = -torch.ones(64, 8, 3, 3)
    out = get_op("LeakyReLU").fn(x, act_type="rrelu", lower_bound=0.1,
                                 upper_bound=0.3, _is_train=True)
    slopes = -out
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3
    # one slope per (sample, channel)
    assert (slopes == slopes[:, :, :1, :1]).all()
    assert len(torch.unique(slopes)) > 100


DECONV_CASES = [
    ((2, 4, 5, 5), (4, 3, 3, 3), {"kernel": (3, 3), "num_filter": 3}),
    ((2, 4, 5, 5), (4, 3, 4, 4), {"kernel": (4, 4), "stride": (2, 2),
                                  "pad": (1, 1), "num_filter": 3,
                                  "no_bias": False}),
    ((2, 4, 5, 6), (4, 2, 3, 3), {"kernel": (3, 3), "stride": (2, 2),
                                  "pad": (1, 1), "adj": (1, 1),
                                  "num_filter": 4, "num_group": 2,
                                  "no_bias": False}),
    ((2, 4, 5, 5), (4, 3, 3, 3), {"kernel": (3, 3), "dilate": (2, 2),
                                  "stride": (3, 3), "adj": (2, 1),
                                  "num_filter": 3}),
    ((2, 4, 7), (4, 3, 5), {"kernel": (5,), "stride": (2,), "pad": (2,),
                            "adj": (1,), "num_filter": 3, "no_bias": False}),
    ((1, 2, 3, 4, 3), (2, 2, 2, 3, 2), {"kernel": (2, 3, 2),
                                        "stride": (2, 1, 2),
                                        "num_filter": 2}),
]


@pytest.mark.parametrize("data,weight,attrs", DECONV_CASES,
                         ids=[str(i) for i in range(len(DECONV_CASES))])
def test_deconvolution(data, weight, attrs):
    arrays = _inputs(18, [data, weight])
    if attrs.get("no_bias") is False:
        arrays += _inputs(19, [(attrs["num_filter"],)])
    _check("Deconvolution", arrays, attrs)
