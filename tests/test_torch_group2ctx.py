"""Model parallelism in the port (``AttrScope(ctx_group=)`` with
``bind`` / ``simple_bind(group2ctx=)``) against the reference, on the
CPU: the reference's two symbolic cases of
``tests/test_model_parallel.py`` (the port maps both groups to cpu(0);
the mixed placement, a group on the host beside one on the card, is
``chip_smoke.py`` phase 14d's), the rule that places each argument,
gradients and aux states under a grouped bind, and a fine-tune's
``fixed_param_names`` with BatchNorm (C18 among it: names a module does
not have are ignored by ``init_params``, as the reference ignores
them).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor as port_executor

PKGS = (mx, mt)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _split_mlp(pkg):
    """The reference test's net: two FC stages in two ctx groups."""
    sym = pkg.sym
    with pkg.AttrScope(ctx_group="dev1"):
        data = sym.Variable("data")
        fc1 = sym.FullyConnected(data, num_hidden=8, name="fc1")
        act1 = sym.Activation(fc1, act_type="tanh", name="act1")
    with pkg.AttrScope(ctx_group="dev2"):
        fc2 = sym.FullyConnected(act1, num_hidden=4, name="fc2")
        return sym.LinearRegressionOutput(fc2, sym.Variable("label"),
                                          name="out")


def _bind_and_run(pkg, group2ctx):
    s = _split_mlp(pkg)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = s.infer_shape(data=(6, 5), label=(6, 4))
    args = {n: pkg.nd.array(rng.randn(*shp).astype(np.float32),
                            ctx=pkg.cpu())
            for n, shp in zip(s.list_arguments(), arg_shapes)}
    grads = {n: pkg.nd.zeros(a.shape, ctx=pkg.cpu())
             for n, a in args.items()}
    ex = s.bind(pkg.cpu(0), args, args_grad=grads, group2ctx=group2ctx)
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return out, {k: g.asnumpy() for k, g in grads.items()}


def test_model_parallel_matches_single_device():
    """The reference's case: the grouped bind agrees with the ungrouped
    one and with the reference's grouped bind over cpu(0) / cpu(1)."""
    ref_out, ref_grads = _bind_and_run(
        mx, {"dev1": mx.cpu(0), "dev2": mx.cpu(1)})
    out1, grads1 = _bind_and_run(mt, None)
    out2, grads2 = _bind_and_run(mt, {"dev1": mt.cpu(0), "dev2": mt.cpu(0)})
    np.testing.assert_array_equal(out1, out2)
    np.testing.assert_allclose(out2, ref_out, rtol=1e-5, atol=1e-6)
    for k in grads1:
        np.testing.assert_array_equal(grads1[k], grads2[k], err_msg=k)
        scale = max(1.0, float(np.abs(ref_grads[k]).max()))
        np.testing.assert_allclose(grads2[k], ref_grads[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_model_parallel_args_actually_placed():
    s = _split_mlp(mt)
    ex = s.simple_bind(ctx=mt.cpu(0), group2ctx={"dev1": mt.cpu(0),
                                                 "dev2": mt.cpu(0)},
                       data=(6, 5), label=(6, 4))
    for name in ("fc1_weight", "fc2_weight", "label"):
        assert ex.arg_dict[name].context == mt.cpu(0)
        assert ex.grad_dict[name].context == mt.cpu(0)


def test_placement_rule_equals_the_reference(monkeypatch):
    """Each argument's group: its own ``ctx_group``, else the group of
    the first op (in topological order) that consumes it, else the
    bind's device; unknown groups fall back to it too. The reference
    places on cpu(0) / cpu(1) (devices of its virtual CPU mesh); the
    port's rule, with contexts kept as they are, gives the same map."""
    ref = _split_mlp(mx).simple_bind(
        ctx=mx.cpu(0), group2ctx={"dev1": mx.cpu(0), "dev2": mx.cpu(1)},
        data=(6, 5), label=(6, 4))
    want = {n: str(a.context) for n, a in ref.arg_dict.items()}
    monkeypatch.setattr(port_executor, "resolve_device", lambda c: c)
    got = port_executor.placement(
        _split_mlp(mt), {"dev1": mt.cpu(0), "dev2": mt.cpu(1)}, mt.cpu(0))
    assert {n: str(c) for n, c in got.items()} == want
    assert want["fc2_weight"] == "cpu(1)" and want["fc1_bias"] == "cpu(0)"
    # a variable created outside any scope takes its first consumer's
    with mt.AttrScope(ctx_group="a"):
        h = mt.sym.FullyConnected(mt.sym.Variable("x"), num_hidden=2,
                                  name="f")
    with mt.AttrScope(ctx_group="zzz"):
        h = mt.sym.BatchNorm(h, name="bn")
    got = port_executor.placement(h, {"a": mt.cpu(1)}, mt.cpu(0))
    assert got["f_weight"] == mt.cpu(1) and got["x"] == mt.cpu(1)
    assert got["bn_gamma"] == mt.cpu(0) and \
        got["bn_moving_mean"] == mt.cpu(0)


def _bn_net(pkg):
    sym = pkg.sym
    with pkg.AttrScope(ctx_group="body"):
        net = sym.Convolution(sym.Variable("data"), kernel=(3, 3),
                              num_filter=4, name="c1")
        net = sym.BatchNorm(net, name="bn1")
        net = sym.Activation(net, act_type="relu", name="r1")
        net = sym.Flatten(net, name="flat")
    with pkg.AttrScope(ctx_group="head"):
        net = sym.FullyConnected(net, num_hidden=3, name="fc")
        return sym.SoftmaxOutput(net, name="softmax")


def test_grouped_training_step_with_aux_states():
    """Forward, backward and the aux update of a BatchNorm net under
    group2ctx equal the ungrouped bind's bit for bit; gradients and aux
    states stay on their arguments' devices."""
    s = _bn_net(mt)
    shapes = {"data": (4, 2, 6, 6), "softmax_label": (4,)}
    runs = []
    for groups in (None, {"body": mt.cpu(0), "head": mt.cpu()}):
        ex = s.simple_bind(mt.cpu(), group2ctx=groups, **shapes)
        r = np.random.RandomState(2)
        for n, a in ex.arg_dict.items():
            a[:] = r.randint(0, 3, a.shape) if n == "softmax_label" \
                else r.randn(*a.shape).astype(np.float32)
        outs = []
        for _ in range(2):
            outs.append(ex.forward(is_train=True)[0].asnumpy())
            ex.backward()
        runs.append((outs, {n: g.asnumpy() for n, g in ex.grad_dict.items()},
                     {n: a.asnumpy() for n, a in ex.aux_dict.items()}, ex))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_array_equal(np.stack(a), np.stack(b))
    ex = runs[1][3]
    assert not np.allclose(runs[1][2]["bn1_moving_mean"], 0)
    for pool in (ex.grad_dict, ex.aux_dict):
        assert all(a.context == mt.cpu() for a in pool.values())


def test_graph_function_copies_inputs_to_the_group_device(monkeypatch):
    """Each op runs on its group's device, its inputs moved there with
    ``Tensor.to`` (differentiable); seen through a recording ``to``."""
    s = _split_mlp(mt)
    moved = []
    real_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if args and isinstance(args[0], torch.device):
            moved.append(args[0])
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    fn = port_executor.graph_function(
        s, {"dev1": mt.cpu(0), "dev2": mt.cpu(0)}, torch.device("cpu"))
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = s.infer_shape(data=(6, 5), label=(6, 4))
    args = {n: torch.from_numpy(rng.randn(*shp).astype(np.float32))
            for n, shp in zip(s.list_arguments(), arg_shapes)}
    fn(args, {}, True, torch.device("cpu"))
    assert moved and all(d == torch.device("cpu") for d in moved)
    moved.clear()
    port_executor.graph_function(s)(args, {}, True, torch.device("cpu"))
    assert moved == []


def _fine_tune_pair(pkg, params, x, y, path):
    """Two steps of a Conv-BN-FC net with the conv and BatchNorm
    arguments fixed, from ``params``: ``fit``'s fused step
    (``_fit_step``) or ``forward_backward`` + ``update``; the
    checkpoint's old head (``old_fc_*``) rides along in
    ``arg_params``."""
    sym = pkg.sym
    net = sym.Convolution(sym.Variable("data"), kernel=(3, 3), num_filter=4,
                          name="c1")
    net = sym.BatchNorm(net, name="bn1")
    net = sym.Flatten(sym.Activation(net, act_type="relu", name="r1"),
                      name="flat")
    net = sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=3,
                                               name="fc"), name="softmax")
    fixed = ["c1_weight", "c1_bias", "bn1_gamma", "bn1_beta"]
    mod = pkg.mod.Module(net, context=pkg.cpu(), fixed_param_names=fixed)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    given = {n: pkg.nd.array(v, ctx=pkg.cpu()) for n, v in params.items()}
    mod.init_params(arg_params=given, aux_params={
        "bn1_moving_mean": pkg.nd.zeros((4,), ctx=pkg.cpu()),
        "bn1_moving_var": pkg.nd.ones((4,), ctx=pkg.cpu())})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                             label=[pkg.nd.array(y, ctx=pkg.cpu())])
    for _ in range(2):
        if path == "fit_step":
            mod._fit_step(batch)
        else:
            mod.forward_backward(batch)
            mod.update()
    args, aux = mod.get_params()
    return ({n: a.asnumpy() for n, a in args.items()},
            {n: a.asnumpy() for n, a in aux.items()}, fixed)


@pytest.mark.parametrize("path", ["fit_step", "update"])
def test_fixed_param_names_with_batchnorm_match_the_reference(path):
    """The reference's rule (``module.py:444``, ``:924-930``): a fixed
    argument takes no gradient and is not updated, and its BatchNorm
    still runs in training mode, so the moving statistics update. The
    port matches the reference's weights and statistics; the old head
    in ``arg_params`` is ignored by both (C18).

    C19, a reference fault the port does not copy: the reference's
    ``update()`` hands the fixed arguments' zero gradient buffers to
    the optimizer (its ``simple_bind`` allocates one for every argument,
    ``module.py:1547-1564`` skips only a missing one), so weight decay
    moves a fixed ``_weight`` / ``_gamma``; its fused ``fit`` step and
    upstream MXNet leave them as they are, and so does the port on both
    paths."""
    rng = np.random.RandomState(5)
    params = {"c1_weight": rng.randn(4, 2, 3, 3).astype(np.float32) * 0.3,
              "c1_bias": rng.randn(4).astype(np.float32),
              "bn1_gamma": rng.rand(4).astype(np.float32) + 0.5,
              "bn1_beta": rng.randn(4).astype(np.float32),
              "fc_weight": rng.randn(3, 64).astype(np.float32) * 0.1,
              "fc_bias": np.zeros(3, np.float32),
              "old_fc_weight": rng.randn(7, 64).astype(np.float32)}
    x = rng.randn(5, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 5).astype(np.float32)
    ref_args, ref_aux, fixed = _fine_tune_pair(mx, params, x, y, path)
    args, aux, _ = _fine_tune_pair(mt, params, x, y, path)
    for n in fixed:
        np.testing.assert_array_equal(args[n], params[n], err_msg=n)
        if path == "fit_step" or n.endswith("_bias") or n.endswith("_beta"):
            np.testing.assert_array_equal(ref_args[n], params[n], err_msg=n)
        else:                                   # C19: decayed by wd
            assert not np.array_equal(ref_args[n], params[n]), n
    for n in ("fc_weight", "fc_bias"):
        assert not np.allclose(args[n], params[n])
        np.testing.assert_allclose(args[n], ref_args[n], rtol=0, atol=1e-5,
                                   err_msg=n)
    assert not np.allclose(ref_aux["bn1_moving_mean"], 0)
    for n in ref_aux:
        np.testing.assert_allclose(aux[n], ref_aux[n], rtol=0, atol=1e-5,
                                   err_msg=n)
    assert "old_fc_weight" not in args
