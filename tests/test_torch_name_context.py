"""Naming, attribute scopes and contexts in the port against the
reference: ``NameManager`` / ``Prefix`` / ``AttrScope`` nesting and
threads, the C17 prefix pinned, ``Context`` equality, hashing and
``with`` blocks, ``current_context()`` raising without a GPU, and the
repairs C15 (a Variable's ``lr_mult`` / ``wd_mult`` reach the optimizer)
and C16 (a Variable's ``dtype`` is stored by its numpy name), both
asserted against the reference's values.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

PKGS = (mx, mt)


def test_name_manager_counts_per_hint_and_nests():
    got = []
    for pkg in PKGS:
        with pkg.name.NameManager():
            a = pkg.sym.FullyConnected(pkg.sym.Variable("x"), num_hidden=2)
            with pkg.name.NameManager():
                b = pkg.sym.FullyConnected(a, num_hidden=2)
            c = pkg.sym.FullyConnected(b, num_hidden=2)
            d = pkg.sym.Activation(c, act_type="relu")
        got.append([s.name for s in (a, b, c, d)] + c.list_arguments())
    assert got[0] == got[1]
    assert got[1][:4] == ["fullyconnected0", "fullyconnected0",
                          "fullyconnected1", "activation0"]


def test_prefix_applies_once_c17():
    """C17: the reference resolves a node's name twice under ``Prefix``
    (``make_symbol_function`` and ``_create`` each call ``Prefix.get``),
    naming the node ``p_p_fc`` while its weight is ``p_fc_weight``; the
    port names the node ``p_fc``, as upstream MXNet does. The argument
    names agree."""
    got = {}
    for pkg in PKGS:
        with pkg.name.Prefix("p_"):
            fc = pkg.sym.FullyConnected(pkg.sym.var("x"), num_hidden=3,
                                        name="fc")
            auto = pkg.sym.Activation(fc, act_type="relu")
        got[pkg] = (fc.name, fc.list_arguments(), auto.name)
    assert got[mx][1] == got[mt][1] == ["x", "p_fc_weight", "p_fc_bias"]
    assert got[mx][0] == "p_p_fc"                     # the reference's C17
    assert got[mt][0] == "p_fc"
    assert got[mt][2] == "p_activation0"


def test_attr_scope_nests_and_reaches_automatic_variables():
    """AttrScope attributes reach op nodes and the weight / bias / aux
    variables created automatically, nested scopes merging, the inner
    winning; the JSON is equal across the packages."""
    js = []
    for pkg in PKGS:
        with pkg.AttrScope(ctx_group="outer", lr_mult="0.1"):
            data = pkg.sym.Variable("data", attr={"mine": "1"})
            with pkg.AttrScope(ctx_group="inner"):
                net = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
                net = pkg.sym.BatchNorm(net, name="bn")
            net = pkg.sym.Activation(net, act_type="relu", name="r")
        assert pkg.name.current_attr_scope() is None
        attrs = net.attr_dict()
        assert attrs["fc_weight"]["ctx_group"] == "inner"
        assert attrs["bn_moving_mean"]["ctx_group"] == "inner"
        assert attrs["r"]["ctx_group"] == "outer"
        assert attrs["data"] == {"ctx_group": "outer", "lr_mult": "0.1",
                                 "mine": "1"}
        js.append(net.tojson())
    assert js[0] == js[1]


def test_scopes_are_per_thread():
    seen = {}

    def worker():
        seen["scope"] = mt.name.current_attr_scope()
        seen["nm"] = mt.name.current_name_manager()
        try:
            mt.current_context()
        except mt.MXNetError:
            seen["ctx"] = "raised"

    nm = mt.name.NameManager()
    with nm, mt.AttrScope(ctx_group="g"), mt.cpu():
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert mt.name.current_name_manager() is nm
        assert mt.current_context() == mt.cpu()
    assert seen["scope"] is None and seen["nm"] is not nm
    assert seen["ctx"] == ("raised" if not torch.cuda.is_available()
                           else seen.get("ctx"))


def test_context_equality_hash_and_str():
    assert str(mt.cpu()) == str(mx.cpu()) == "cpu(0)"
    assert repr(mt.gpu(1)) == "gpu(1)"
    assert mt.tpu(1) == mt.gpu(1) and mt.tpu(0) != mt.cpu(0)
    assert mt.cpu(0) == torch.device("cpu")
    assert torch.device("cpu") == mt.cpu(0)
    assert mt.gpu(0) == torch.device("cuda", 0)
    assert torch.device("cuda:0") == mt.gpu(0)
    assert torch.device("cuda:1") != mt.gpu(0)
    assert mt.cpu(1) != mt.cpu(0)
    assert hash(mt.cpu()) == hash(torch.device("cpu"))
    assert hash(mt.gpu(2)) == hash(torch.device("cuda", 2))
    assert {mt.cpu(): 1}[torch.device("cpu")] == 1
    assert mt.Context(torch.device("cuda", 3)) == mt.gpu(3)
    assert mt.Context(mt.tpu(2)).device == torch.device("cuda", 2)
    assert mt.cpu().device_type == "cpu" and mt.tpu().device_type == "gpu"
    assert mt.cpu() != "cpu"
    with pytest.raises(mt.MXNetError):
        mt.Context("npu")


def test_context_with_blocks_share_the_device_scope_stack():
    with mt.cpu() as ctx:
        assert ctx == mt.cpu()
        assert mt.current_context() == mt.cpu()
        assert mt.current_device() == torch.device("cpu")
        a = mt.nd.array([1.0, 2.0])
        assert a.context == mt.cpu() and a.context == torch.device("cpu")
        assert isinstance(a.context, mt.Context) and a.ctx == a.context
        with mt.device_scope("cpu") as dev:
            assert dev == torch.device("cpu")
            with mt.cpu(1):
                assert mt.current_context() == mt.cpu(1)
            assert mt.current_context() == mt.cpu(0)
        assert mt.current_context() == mt.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            mt.current_context()
        with pytest.raises(mt.MXNetError):
            with mt.gpu(0):
                pass


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_current_context_raises_without_a_gpu():
    """The reference falls back to cpu(0); the port's rule is the card
    unless the caller asks for the CPU, so without a GPU it raises."""
    assert mx.context.current_context() == mx.cpu(0)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.current_context()
    with pytest.raises(mt.MXNetError):
        mt.nd.zeros((2,), ctx=mt.tpu(0))


def test_num_devices():
    assert mt.num_devices("cpu") == 1
    want = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert mt.num_devices() == mt.num_devices("gpu") == want
    with pytest.raises(mt.MXNetError):
        mt.num_devices("npu")


def test_entry_points_take_a_context():
    with mt.cpu():
        ex = (mt.sym.Variable("a") * 2.0).simple_bind(mt.cpu(), a=(2,))
        assert ex.arg_dict["a"].context == mt.cpu()
        mod = mt.mod.Module(mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=2, name="fc"),
            name="softmax"), context=mt.cpu(0))
        mod.bind(data_shapes=[("data", (2, 3))],
                 label_shapes=[("softmax_label", (2,))])
        assert mod._exec.arg_dict["fc_weight"].context == mt.cpu()
        x = mt.nd.ones((2, 2), ctx=mt.cpu())
        assert x.as_in_context(mt.cpu()) is x
        assert x.copyto(mt.cpu()).context == mt.cpu()


def _variable_kwargs(pkg):
    return dict(attr={"a": "b"}, shape=(2, 3), lr_mult=0.5, wd_mult=2.0,
                dtype=np.float16, init=pkg.init.Xavier(magnitude=2), foo=3)


def test_variable_json_equals_the_reference_c16():
    """C16: ``dtype=`` is stored as ``str(np.dtype(dtype))`` ("float16"),
    and ``lr_mult`` / ``wd_mult`` as ``__lr_mult__`` / ``__wd_mult__``:
    a variable with every attribute keyword serializes as the
    reference's, and each package reads the other's file back."""
    js = {pkg: pkg.sym.Variable("w", **_variable_kwargs(pkg)).tojson()
          for pkg in PKGS}
    assert js[mt] == js[mx]
    node = mt.sym.load_json(js[mt]).list_attr()
    assert node["__dtype__"] == "float16"
    assert node["__lr_mult__"] == "0.5" and node["__wd_mult__"] == "2.0"
    assert mx.sym.load_json(js[mt]).tojson() == js[mx]
    for dtype, name in ((torch.bfloat16, "bfloat16"), ("bfloat16",
                                                       "bfloat16"),
                        (torch.float16, "float16"), ("int32", "int32")):
        assert mt.sym.var("v", dtype=dtype).attr("__dtype__") == name


def _sgd_step(pkg, w0, x, y):
    sym = pkg.sym
    w = sym.Variable("w", lr_mult=0.5, wd_mult=2.0)
    out = sym.LinearRegressionOutput(
        sym.FullyConnected(sym.Variable("data"), weight=w, no_bias=True,
                           num_hidden=3, name="fc"),
        sym.Variable("lbl"), name="out")
    mod = pkg.mod.Module(out, label_names=["lbl"], context=pkg.cpu())
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("lbl",
                                                             y.shape)])
    mod.init_params(arg_params={"w": pkg.nd.array(w0, ctx=pkg.cpu())})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "wd": 0.05})
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                             label=[pkg.nd.array(y, ctx=pkg.cpu())])
    mod.forward_backward(batch)
    mod.update()
    return (mod.get_params()[0]["w"].asnumpy(), dict(mod._optimizer.lr_mult),
            dict(mod._optimizer.wd_mult))


def test_lr_mult_and_wd_mult_reach_the_optimizer_c15():
    """C15: ``Variable("w", lr_mult=0.5, wd_mult=2.0)`` trains at half the
    rate and twice the decay in both packages: one SGD step from the same
    weights agrees within 1e-6, and the optimizers' multipliers are the
    reference's ({"w": 0.5} and {"w": 2.0})."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(3, 4).astype(np.float32)
    x = rng.randn(5, 4).astype(np.float32)
    y = rng.randn(5, 3).astype(np.float32)
    ref = _sgd_step(mx, w0, x, y)
    with mt.cpu():
        got = _sgd_step(mt, w0, x, y)
    assert ref[1] == {"w": 0.5} and ref[2] == {"w": 2.0}
    assert got[1] == ref[1] and got[2] == ref[2]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    assert not np.allclose(got[0], w0)
