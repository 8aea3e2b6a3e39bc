"""Symbol's whole surface in the port against the reference: internals,
children, attributes, composition, the operators, ``infer_type`` /
``infer_shape_partial``, ``eval`` and the 42 fluent methods, each case
run in both packages on the same numpy inputs; and the public name sets
(``Symbol``'s attributes, the top-level ``__all__``).

Oracles: ``tests/test_symbol.py`` (compose, get_internals,
attr_scope_ctx_group, variable_shape_attr, arithmetic_eval,
group_and_multi_output) and ``tests/test_symbol_json_compat.py``
(get_internals_with_aux_head, round trips). Both packages name nodes
from per-process counters, so each builder names its ops.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import chip_smoke as cs
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

PKGS = (mx, mt)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.device_scope("cpu"):
        yield


def _mlp(pkg):
    sym = pkg.sym
    fc1 = sym.FullyConnected(sym.Variable("data"), num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _conv_bn(pkg):
    sym = pkg.sym
    net = sym.Convolution(sym.Variable("data"), kernel=(3, 3), num_filter=4,
                          name="c1")
    net = sym.BatchNorm(net, name="bn1")
    return sym.Activation(net, act_type="relu", name="relu1")


def _nd(pkg, v):
    return pkg.nd.array(v, ctx=pkg.cpu())


def _eval(pkg, s, inputs, aux=None):
    kw = {n: _nd(pkg, inputs[n]) for n in s.list_arguments()}
    extra = {}
    if aux is not None:
        extra["aux_states"] = {n: _nd(pkg, v) for n, v in aux.items()}
    return [o.asnumpy().astype(np.float64)
            for o in s.eval(ctx=pkg.cpu(), **extra, **kw)]


def _close(got, want, what=""):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        scale = max(1.0, float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                   err_msg=what)


def test_symbol_public_attributes_equal_the_reference():
    def public(cls):
        return {a for a in dir(cls) if not a.startswith("__") or a in (
            "__call__", "__pow__", "__div__", "__rdiv__")}
    assert public(mt.sym.Symbol) == public(mx.sym.Symbol)


def test_top_level_names_cover_the_reference():
    """Every name of the reference's ``__all__`` but ``test_utils``,
    which comes with ROADMAP.md queue A10."""
    exempt = {"test_utils"}
    missing = [n for n in mx.__all__ if n not in exempt
               and not hasattr(mt, n)]
    assert missing == []
    for n in ("Xavier", "Uniform", "Normal", "Orthogonal", "Zero", "One",
              "Constant"):
        assert getattr(mt, n) is getattr(mt.init, n)
    assert mt.sym.var is mt.sym.Variable


def test_get_internals_and_children():
    lists = []
    for pkg in PKGS:
        out = _mlp(pkg)
        internals = out.get_internals()
        feat = internals["fc1_output"]
        children = internals["fc2_output"].get_children()
        lists.append((internals.list_outputs(), feat.list_arguments(),
                      children.list_outputs(), out.get_children()
                      .list_outputs(), pkg.sym.Variable("v").get_children()))
    assert lists[0] == lists[1]
    assert lists[1][1] == ["data", "fc1_weight", "fc1_bias"]
    assert lists[1][4] is None


def test_get_internals_lists_aux_and_multi_outputs():
    """Aux states and every visible output (SliceChannel's) in
    topological order; the internals with an aux head serialize and load
    back alike."""
    lists = []
    for pkg in PKGS:
        sym = pkg.sym
        bn = _conv_bn(pkg)
        parts = sym.SliceChannel(bn, num_outputs=2, axis=1, name="sc")
        net = sym.Group([parts[1], sym.BatchNorm(parts[0], name="bn2")])
        internals = net.get_internals()
        back = sym.load_json(internals.tojson())
        lists.append((internals.list_outputs(), back.list_outputs(),
                      back.list_arguments(), back.list_auxiliary_states(),
                      json.loads(internals.tojson())))
    assert lists[0] == lists[1]
    assert "sc_output1" in lists[1][0] and "bn1_moving_var" in lists[1][0]


def test_attr_list_attr_and_set_attr():
    got = []
    for pkg in PKGS:
        with pkg.name.NameManager(), pkg.AttrScope(ctx_group="dev1"):
            a = pkg.sym.Variable("a", attr={"k": "v"})
            b = a * 2.0
        b._set_attr(tag=3)
        got.append((a.attr("ctx_group"), a.attr("nope"), a.list_attr(),
                    b.list_attr(), pkg.sym.Group([a, b]).attr("k"),
                    pkg.sym.Group([a, b]).list_attr(), b.attr_dict()))
    assert got[0] == got[1]
    assert got[1][0] == "dev1"


def test_variable_shape_attr():
    got = []
    for pkg in PKGS:
        data = pkg.sym.Variable("data", shape=(4, 8))
        fc = pkg.sym.FullyConnected(data, num_hidden=2, name="fc")
        got.append(fc.infer_shape())
    assert got[0] == got[1]
    assert got[1][1] == [(4, 2)]


@pytest.mark.parametrize("how", ["keyword", "positional"])
def test_compose(how):
    rng = np.random.RandomState(0)
    vals = {"d2": rng.randn(3, 5).astype(np.float32),
            "fc_weight": rng.randn(4, 5).astype(np.float32),
            "fc_bias": rng.randn(4).astype(np.float32),
            "fc2_weight": rng.randn(2, 4).astype(np.float32),
            "fc2_bias": rng.randn(2).astype(np.float32)}
    outs = []
    for pkg in PKGS:
        sym = pkg.sym
        a = sym.Variable("a")
        h = sym.FullyConnected(a, num_hidden=4, name="fc")
        # a node two outputs share stays shared after the copy
        net = sym.Group([sym.FullyConnected(h, num_hidden=2, name="fc2"),
                         sym.Activation(h, act_type="tanh", name="t")])
        d2 = sym.Variable("d2")
        net2 = net(a=d2 * 1.0) if how == "keyword" else net(d2 * 1.0)
        outs.append((net2.list_arguments(), net2.list_outputs(),
                     _eval(pkg, net2, vals), net.list_arguments()))
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    assert "a" not in outs[1][0] and "d2" in outs[1][0]
    assert outs[1][3][0] == "a"             # the original is untouched
    _close(outs[1][2], outs[0][2])


def test_compose_carries_an_output_index_and_rejects_both_forms():
    got = []
    for pkg in PKGS:
        sym = pkg.sym
        parts = sym.SliceChannel(sym.Variable("x"), num_outputs=2, axis=1,
                                 name="sc")
        net = sym.Activation(sym.Variable("a"), act_type="relu", name="r")
        net2 = net(a=parts[1])
        x = np.arange(8, dtype=np.float32).reshape(2, 4) - 3.0
        got.append(_eval(pkg, net2, {"x": x}))
        with pytest.raises(TypeError):
            net(parts[0], a=parts[1])
        with pytest.raises(ValueError):
            net(a=parts)
    _close(got[1], got[0])
    np.testing.assert_array_equal(got[1][0], [[0, 0], [3, 4]])


def test_arithmetic_pow_div_eval():
    got = []
    for pkg in PKGS:
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        c = (a + b) * 2.0 - a / 2.0
        d = a ** 2.0 + a ** b
        e = b.__div__(a) + a.__rdiv__(4.0) + 1.0 / a
        got.append([_eval(pkg, s, {"a": np.array([2.0, 3.0], np.float32),
                                   "b": np.array([3.0, 0.5], np.float32)})
                    for s in (c, d, e)])
    for g, w in zip(got[1], got[0]):
        _close(g, w)
    np.testing.assert_allclose(got[1][0][0], [9.0, 5.5])


def test_group_and_multi_output_eval():
    got = []
    for pkg in PKGS:
        a = pkg.sym.Variable("a")
        g = pkg.sym.Group([a * 2.0, a + 1.0])
        got.append((g.list_outputs().__len__(),
                    _eval(pkg, g, {"a": np.array([1.0, 2.0], np.float32)})))
    assert got[0][0] == got[1][0] == 2
    _close(got[1][1], got[0][1])


def test_eval_with_aux_states_and_its_errors():
    rng = np.random.RandomState(1)
    vals = {"data": rng.randn(2, 3, 6, 6).astype(np.float32),
            "c1_weight": rng.randn(4, 3, 3, 3).astype(np.float32),
            "c1_bias": rng.randn(4).astype(np.float32),
            "bn1_gamma": rng.rand(4).astype(np.float32) + 0.5,
            "bn1_beta": rng.randn(4).astype(np.float32)}
    aux = {"bn1_moving_mean": rng.randn(4).astype(np.float32),
           "bn1_moving_var": rng.rand(4).astype(np.float32) + 0.5}
    got = []
    for pkg in PKGS:
        net = _conv_bn(pkg)
        got.append(_eval(pkg, net, vals, aux))
        with pytest.raises(pkg.base.MXNetError, match="missing arguments"):
            net.eval(ctx=pkg.cpu(), data=_nd(pkg, vals["data"]))
        with pytest.raises(pkg.base.MXNetError, match="auxiliary state"):
            _eval(pkg, net, vals)
    _close(got[1], got[0])


def test_eval_defaults_to_the_current_context():
    """``eval(ctx=None)`` runs on ``current_context()``: here the CPU
    scope; without one and without a GPU it raises, as every entry
    point of the port does."""
    s = mt.sym.Variable("a") * 3.0
    out = s.eval(a=mt.nd.array([1.0, 2.0], ctx=mt.cpu()))[0]
    assert out.context == mt.cpu()
    np.testing.assert_allclose(out.asnumpy(), [3.0, 6.0])


def test_infer_type():
    got = []
    for pkg in PKGS:
        data = pkg.sym.Variable("data", dtype=np.float16)
        net = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
        bn = _conv_bn(pkg)
        got.append((net.infer_type(), net.infer_type(np.float64),
                    net.infer_type(fc_bias="float16"), bn.infer_type()))
        bad = pkg.sym.Variable("v", dtype="float32")
        bad._set_attr(__dtype__="nonsense")
        with pytest.raises(pkg.base.MXNetError, match="'v'"):
            bad.infer_type()
    assert got[0] == got[1]
    assert got[1][0][0] == [np.dtype(np.float16), np.dtype(np.float32),
                            np.dtype(np.float32)]


def test_infer_shape_partial():
    got = []
    for pkg in PKGS:
        net = _mlp(pkg)
        got.append((net.infer_shape_partial(),
                    net.infer_shape_partial(data=(4, 8)),
                    net.infer_shape_partial((4, 8), None, None, None, None,
                                            (4,)),
                    _conv_bn(pkg).infer_shape_partial(data=(2, 3, 8, 8))))
        with pytest.raises(pkg.base.MXNetError):
            net.infer_shape()
    assert got[0] == got[1]
    assert got[1][0] == (None, None, None)
    assert got[1][1][1] == [(4, 10)]


def test_json_round_trip_of_the_new_attributes():
    outs = []
    for pkg in PKGS:
        with pkg.AttrScope(ctx_group="g1", lr_mult="0.5"):
            with pkg.AttrScope(ctx_group="g2"):
                net = pkg.sym.FullyConnected(
                    pkg.sym.var("data", shape=(2, 3), dtype="float16"),
                    num_hidden=4, name="fc")
            net = pkg.sym.Activation(net, act_type="relu", name="r")
        js = net.tojson()
        back = pkg.sym.load_json(js)
        outs.append((js, back.tojson(), back.attr_dict()))
    assert outs[0] == outs[1]


def test_analyze_names_a10():
    """Symbol.analyze (ported with A10b) takes the reference's kwargs
    form and counts what the reference counts."""
    got = _mlp(mt).analyze(data=(4, 8)).extras["cost"]
    want = _mlp(mx).analyze(data=(4, 8)).extras["cost"]
    assert got["flops"] == want["flops"] > 0
    assert got["peak_bytes"] == want["peak_bytes"]


def test_fluent_method_set_equals_the_reference():
    names = cs.fluent_cases(mt.sym)
    assert len(names) == 42
    for n in names:
        assert hasattr(mt.sym.Symbol, n) and hasattr(mx.sym.Symbol, n)
    assert not hasattr(mt.sym.Symbol, "astype")
    assert not hasattr(mx.sym.Symbol, "astype")


@pytest.mark.parametrize("name", sorted(cs.fluent_cases(mt.sym)))
def test_fluent_method(name):
    """Each fluent method with positional attributes where it takes one,
    evaluated in both packages (the cases of chip_smoke phase 14a)."""
    inputs = cs.fluent_inputs(np)
    want_s, got_s = (cs.fluent_cases(pkg.sym)[name] for pkg in PKGS)
    assert got_s.list_arguments() == want_s.list_arguments()
    assert len(got_s.list_outputs()) == len(want_s.list_outputs())
    _close(_eval(mt, got_s, inputs), _eval(mx, want_s, inputs), name)
