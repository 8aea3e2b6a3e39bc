"""The port's ResNet ops against the reference package, op by op.

``Convolution`` (1-D, 2-D and 3-D; stride, pad, dilate, groups, bias),
``Pooling`` (max / avg / sum, global, padded, the ``valid`` and ``full``
conventions, ``count_include_pad`` both ways), ``BatchNorm`` (train and
eval, ``fix_gamma``, ``use_global_stats``, ``axis``, the moving
statistics it returns and the ones an executor commits), ``Flatten`` and
``Pad`` (constant, edge, reflect): the same numpy-seeded f32 inputs go
through the reference op (``jax.vjp`` of its function) and the port's
(``torch.autograd``), forward and input gradients under one random
cotangent, held to atol 1e-5: the same f32 formulas over at most a few
hundred terms, summed in another order (the largest measured gap is
7.6e-6, on a gamma gradient of 37: 2e-7 of it).
Hand-written numpy oracles of ``tests/test_operator.py`` check the
same ops once more at the end.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import get_op as jax_get_op
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import get_op

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _reference(name, arrays, attrs, seed):
    """Forward outputs and the gradient of every input under one random
    cotangent on the first output (zeros on the others)."""
    fn = jax_get_op(name).fn
    outs, vjp = jax.vjp(lambda *xs: fn(*xs, **attrs),
                        *[jnp.asarray(a) for a in arrays])
    tup = isinstance(outs, tuple)
    outs = outs if tup else (outs,)
    head = _inputs(seed + 1, [outs[0].shape])[0]
    cot = [jnp.asarray(head)] + [jnp.zeros_like(o) for o in outs[1:]]
    grads = vjp(tuple(cot) if tup else cot[0])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads], \
        head


def _port(name, arrays, attrs, head, wrt):
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    for i in wrt:
        ts[i].requires_grad_(True)
    outs = get_op(name).fn(*ts, **attrs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs[0], [ts[i] for i in wrt],
                                torch.from_numpy(head), allow_unused=True)
    return [o.detach().numpy() for o in outs], \
        [np.zeros_like(arrays[i]) if g is None else g.numpy()
         for i, g in zip(wrt, grads)]


def _check(name, arrays, attrs, wrt=None, seed=0):
    wrt = list(range(len(arrays))) if wrt is None else wrt
    want, want_grads, head = _reference(name, arrays, attrs, seed)
    got, got_grads = _port(name, arrays, attrs, head, wrt)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg="output %d" % i)
    for i, g in zip(wrt, got_grads):
        np.testing.assert_allclose(g, want_grads[i], atol=ATOL,
                                   err_msg="gradient of input %d" % i)
    return got, got_grads


CONV_CASES = {
    "1d_stride_pad_bias": ((2, 3, 9), (4, 3, 3), True,
                           dict(kernel=(3,), stride=(2,), pad=(1,),
                                num_filter=4)),
    "2d_groups_dilate": ((2, 4, 8, 8), (6, 2, 3, 3), True,
                         dict(kernel=(3, 3), stride=(2, 1), pad=(1, 0),
                              dilate=(1, 2), num_filter=6, num_group=2)),
    "2d_1x1_no_bias": ((2, 5, 6, 6), (7, 5, 1, 1), False,
                       dict(kernel=(1, 1), stride=(2, 2), num_filter=7,
                            no_bias=True)),
    "2d_depthwise": ((2, 4, 7, 7), (4, 1, 3, 3), True,
                     dict(kernel=(3, 3), pad=(1, 1), num_filter=4,
                          num_group=4)),
    "2d_resnet_stem": ((2, 3, 16, 16), (8, 3, 7, 7), False,
                       dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                            num_filter=8, no_bias=True)),
    "3d": ((1, 2, 5, 6, 4), (3, 2, 2, 3, 2), True,
           dict(kernel=(2, 3, 2), stride=(1, 2, 1), pad=(1, 1, 0),
                dilate=(2, 1, 1), num_filter=3)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_reference(case):
    xs, ws, bias, attrs = CONV_CASES[case]
    shapes = [xs, ws] + ([(ws[0],)] if bias else [])
    _check("Convolution", _inputs(3, shapes, 0.5), attrs)


POOL_CASES = {
    "max_2x2_valid": ((2, 3, 6, 6), dict(kernel=(2, 2), stride=(2, 2))),
    "max_resnet_pool0": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                            pad=(1, 1))),
    "max_full": ((2, 2, 8, 7), dict(kernel=(3, 3), stride=(2, 2),
                                    pooling_convention="full")),
    "max_wide_pad": ((1, 2, 7, 7), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(2, 2))),
    "max_global": ((2, 3, 5, 4), dict(global_pool=True, kernel=(2, 2))),
    "avg_pad_count_include": ((2, 3, 7, 7), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg")),
    "avg_pad_count_exclude": ((2, 3, 7, 7), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    "avg_full_count_include": ((2, 2, 8, 8), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full")),
    "avg_full_count_exclude": ((2, 2, 8, 8), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "avg_global": ((2, 4, 7, 7), dict(global_pool=True, kernel=(7, 7),
                                      pool_type="avg")),
    "sum_pad": ((2, 3, 6, 6), dict(kernel=(2, 2), stride=(1, 1),
                                   pad=(1, 1), pool_type="sum")),
    "sum_global": ((2, 3, 4, 4), dict(global_pool=True, pool_type="sum")),
    "max_1d": ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,))),
    "avg_3d_full": ((1, 2, 5, 6, 7), dict(
        kernel=(2, 2, 3), stride=(2, 2, 2), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_reference(case):
    shape, attrs = POOL_CASES[case]
    _check("Pooling", _inputs(5, [shape]), attrs)


def _bn_inputs(shape, axis=1, seed=7):
    c = shape[axis]
    x, gamma, beta, mm = _inputs(seed, [shape, (c,), (c,), (c,)])
    mv = np.abs(_inputs(seed + 2, [(c,)])[0]) + 0.5
    return [x * 2.0 + 0.3, gamma, beta, mm, mv]


BN_CASES = {
    "train": ((4, 3, 5, 5), dict(fix_gamma=False, _is_train=True)),
    "train_fix_gamma": ((4, 3, 5, 5), dict(fix_gamma=True, _is_train=True)),
    "train_momentum": ((4, 3, 5, 5), dict(fix_gamma=False, momentum=0.7,
                                          eps=2e-5, _is_train=True)),
    "eval": ((4, 3, 5, 5), dict(fix_gamma=False, _is_train=False)),
    "train_use_global_stats": ((4, 3, 5, 5), dict(
        fix_gamma=False, use_global_stats=True, _is_train=True)),
    "train_axis_last": ((3, 4, 6), dict(fix_gamma=False, axis=-1,
                                        _is_train=True)),
    "train_2d": ((8, 5), dict(fix_gamma=False, _is_train=True)),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_reference(case):
    """Every output (out, batch mean and variance, the new moving
    statistics) and the gradients of data, gamma and beta; the moving
    statistics are not differentiated in either package."""
    shape, attrs = BN_CASES[case]
    ax = attrs.get("axis", 1) % len(shape)
    got, grads = _check("BatchNorm", _bn_inputs(shape, ax), attrs,
                        wrt=[0, 1, 2])
    if attrs.get("fix_gamma"):
        assert not grads[1].any()          # gamma multiplies by ones


def test_batch_norm_moving_stats_are_the_reference_blend():
    """new = momentum·old + (1−momentum)·batch, with the biased batch
    variance (torch's own update would use the unbiased one)."""
    x, gamma, beta, mm, mv = _bn_inputs((4, 3, 2, 2))
    out = get_op("BatchNorm").fn(*[torch.from_numpy(a) for a in
                                   (x, gamma, beta, mm, mv)],
                                 fix_gamma=False, momentum=0.9,
                                 _is_train=True)
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(out[3].numpy(), 0.9 * mm + 0.1 * mean,
                               atol=ATOL)
    np.testing.assert_allclose(out[4].numpy(), 0.9 * mv + 0.1 * var,
                               atol=ATOL)
    unbiased = x.var(axis=(0, 2, 3), ddof=1)
    assert np.abs(out[4].numpy() - (0.9 * mv + 0.1 * unbiased)).max() > 1e-3


def _bn_symbols(package):
    data = package.sym.Variable("data")
    return package.sym.BatchNorm(data=data, fix_gamma=False, momentum=0.8,
                                 name="bn")


def test_executor_commits_moving_stats_like_the_reference():
    """Two training forwards commit the blended statistics into
    ``aux_dict`` as the reference's executor does; an inference forward
    then normalises with them and leaves them unchanged."""
    x, gamma, beta, mm, mv = _bn_inputs((4, 3, 5, 5))
    x2 = _inputs(11, [x.shape])[0]
    js, ps = _bn_symbols(mx), _bn_symbols(mt)
    assert ps.list_arguments() == js.list_arguments() == \
        ["data", "bn_gamma", "bn_beta"]
    assert ps.list_auxiliary_states() == js.list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]
    jex = js.bind(mx.cpu(), {"data": mx.nd.array(x),
                             "bn_gamma": mx.nd.array(gamma),
                             "bn_beta": mx.nd.array(beta)},
                  aux_states={"bn_moving_mean": mx.nd.array(mm),
                              "bn_moving_var": mx.nd.array(mv)})
    cpu = mt.cpu()
    pex = ps.bind(cpu, {"data": mt.nd.array(x, ctx=cpu),
                        "bn_gamma": mt.nd.array(gamma, ctx=cpu),
                        "bn_beta": mt.nd.array(beta, ctx=cpu)},
                  aux_states={"bn_moving_mean": mt.nd.array(mm, ctx=cpu),
                              "bn_moving_var": mt.nd.array(mv, ctx=cpu)})
    for batch in (x, x2):
        jex.forward(is_train=True, data=mx.nd.array(batch))
        pex.forward(is_train=True, data=mt.nd.array(batch, ctx=cpu))
        for n in ("bn_moving_mean", "bn_moving_var"):
            np.testing.assert_allclose(pex.aux_dict[n].asnumpy(),
                                       jex.aux_dict[n].asnumpy(),
                                       atol=ATOL, err_msg=n)
    before = {n: a.asnumpy() for n, a in pex.aux_dict.items()}
    want = jex.forward(is_train=False, data=mx.nd.array(x))[0].asnumpy()
    got = pex.forward(is_train=False, data=mt.nd.array(x, ctx=cpu))
    np.testing.assert_allclose(got[0].asnumpy(), want, atol=ATOL)
    for n, a in pex.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), before[n])


def test_training_forward_commits_after_the_gradient_graph_is_built():
    """With gradients recorded, the commit does not touch a tensor that
    autograd saved: backward still runs (use_global_stats saves the
    moving statistics and leaves them unchanged)."""
    x, gamma, beta, mm, mv = _bn_inputs((4, 3, 5, 5))
    cpu = mt.cpu()
    for stats in (False, True):
        sym = mt.sym.BatchNorm(data=mt.sym.Variable("data"), fix_gamma=False,
                               use_global_stats=stats, name="bn")
        ex = sym.simple_bind(cpu, data=x.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["bn_gamma"][:] = gamma
        ex.aux_dict["bn_moving_var"][:] = mv
        ex.forward(is_train=True)
        ex.backward([mt.nd.array(np.ones_like(x), ctx=cpu)])
        assert np.isfinite(ex.grad_dict["data"].asnumpy()).all()
        moved = not np.allclose(ex.aux_dict["bn_moving_var"].asnumpy(), mv)
        assert moved != stats


def test_flatten_matches_reference():
    _check("Flatten", _inputs(13, [(2, 3, 4, 5)]), {})


PAD_CASES = {
    "constant": dict(mode="constant", constant_value=1.5,
                     pad_width=(0, 0, 0, 0, 1, 2, 3, 0)),
    "constant_every_axis": dict(mode="constant",
                                pad_width=(1, 0, 0, 2, 1, 1, 0, 1)),
    "edge": dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 3)),
    "reflect": dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_matches_reference(case):
    _check("Pad", _inputs(17, [(2, 3, 5, 6)]), PAD_CASES[case])


def test_channels_last_convolution_raises():
    x, w = (torch.zeros(1, 4, 4, 2), torch.zeros(2, 2, 1, 1))
    with pytest.raises(MXNetError, match="channels-last"):
        get_op("Convolution").fn(x, w, kernel=(1, 1), num_filter=2,
                                 no_bias=True, layout="NHWC")


# numpy oracles of tests/test_operator.py, on the port

def _np_conv2d(x, w, b, stride, pad):
    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    sh, sw = stride
    ph, pw = pad
    xp = np.pad(x, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (wd + 2 * pw - kw) // sw + 1
    out = np.zeros((n, f, oh, ow), dtype=np.float64)
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, :, i * sh:i * sh + kh, j * sw:j * sw + kw]
            out[:, :, i, j] = np.einsum("nchw,fchw->nf", patch, w)
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def test_numpy_oracles_of_the_reference_tests():
    rng = np.random.default_rng(19)
    cpu = mt.cpu()
    x = rng.random((2, 3, 8, 8)).astype("f")
    w = rng.random((4, 3, 3, 3)).astype("f")
    b = rng.random(4).astype("f")
    nd = lambda a: mt.nd.array(a, ctx=cpu)      # noqa: E731
    out = mt.nd.Convolution(nd(x), nd(w), nd(b), kernel=(3, 3), num_filter=4,
                            stride=(1, 1), pad=(1, 1)).asnumpy()
    np.testing.assert_allclose(out, _np_conv2d(x, w, b, (1, 1), (1, 1)),
                               rtol=1e-5, atol=1e-5)
    p = rng.random((2, 3, 6, 6)).astype("f")
    out = mt.nd.Pooling(nd(p), kernel=(2, 2), stride=(2, 2)).asnumpy()
    np.testing.assert_array_equal(
        out, p.reshape(2, 3, 3, 2, 3, 2).max(axis=(3, 5)))
    out = mt.nd.Pooling(nd(p), global_pool=True, pool_type="avg").asnumpy()
    np.testing.assert_allclose(out, p.mean(axis=(2, 3), keepdims=True),
                               atol=1e-6)
    xb = rng.random((4, 3, 2, 2)).astype("f")
    mm, mv = mt.nd.zeros((3,), ctx=cpu), mt.nd.array(np.ones(3), ctx=cpu)
    out = mt.nd.BatchNorm(nd(xb), nd(np.ones(3)), nd(np.zeros(3)), mm, mv,
                          fix_gamma=False, _is_train=True)
    mean, var = xb.mean(axis=(0, 2, 3)), xb.var(axis=(0, 2, 3))
    exp = (xb - mean.reshape(1, 3, 1, 1)) / np.sqrt(
        var.reshape(1, 3, 1, 1) + 1e-3)
    np.testing.assert_allclose(out.asnumpy(), exp, rtol=1e-4, atol=1e-5)
    # nd.BatchNorm commits into the aux arrays it was given
    np.testing.assert_allclose(mm.asnumpy(), 0.1 * mean, atol=1e-6)
    np.testing.assert_allclose(mv.asnumpy(), 0.9 + 0.1 * var, atol=1e-6)
