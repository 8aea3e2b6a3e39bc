"""The scan plan (``MXNET_TPU_SCAN_LAYERS``) held to the reference's.

The cases of the reference's ``tests/test_scan_layers.py`` on symbols
both packages build from the same model code: the plan finds the same
layers, the same per-layer parameter families (``var_lists``) and the
same pre / post nodes, falls back where the reference's does, and its
forward and gradients are bit for bit the unrolled graph's (the port
runs each layer's own nodes, so the arithmetic is the same; the
reference allows 2 f32 ulps for XLA's fusion), Dropout masks included.
The executor counts ``scan_applied`` and sets the ``scan_layers``
gauge; ``Module`` counts the update groups ``MXNET_TPU_GROUP_UPDATE``
names.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jax_transformer
from mxnet_tpu.symbol.scan import build_scan_plan as ref_plan
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config
from mxnet_tpu_torch.models import transformer as port_transformer
from mxnet_tpu_torch.symbol.scan import build_scan_plan as port_plan
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

V, T, B = 64, 8, 2


def _tf(model, num_layers=4, d_model=32, seq_len=T, attention="dense"):
    return model.get_symbol(vocab_size=V, num_layers=num_layers,
                            d_model=d_model, n_heads=2, seq_len=seq_len,
                            attention=attention)


def _names(plan):
    """What a plan says, by node and variable names."""
    if plan is None:
        return None
    return {"n_layers": plan.n_layers,
            "var_lists": sorted(plan.var_lists.values()),
            "pre": [n.name for n in plan.pre_nodes],
            "post": [n.name for n in plan.post_nodes],
            "template": [n.name for n in plan.template],
            "out_idx": plan.out_idx}


def _mlp(pkg):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=16, name="fc2")
    net = sym.Activation(net, act_type="relu")
    return sym.FullyConnected(net, num_hidden=16, name="fc3")


def _shared_weight(pkg):
    x, w = pkg.sym.Variable("data"), pkg.sym.Variable("w")
    for i in range(4):
        x = pkg.sym.FullyConnected(x, weight=w, no_bias=True, num_hidden=16,
                                   name="step%d" % i)
    return x


def _heterogeneous(pkg):
    x = pkg.sym.Variable("data")
    for i, nh in enumerate((16, 16, 32, 16)):
        x = pkg.sym.FullyConnected(x, num_hidden=nh, name="layer%d_fc" % i)
        x = pkg.sym.Activation(x, act_type="relu")
    return x


def _internal_exposed(pkg, model):
    net = _tf(model)
    internals = net.get_internals()
    probe = [name for name in internals.list_outputs()
             if name.startswith("layer1_att_proj")][0]
    return pkg.sym.Group([net, internals[probe]])


def _dropout_chain(pkg):
    x = pkg.sym.Variable("data")
    for i in range(4):
        x = pkg.sym.FullyConnected(x, num_hidden=16, name="blk%d_fc" % i)
        x = pkg.sym.Activation(x, act_type="relu")
        x = pkg.sym.Dropout(x, p=0.5)
    return x


def _resnet(pkg):
    from mxnet_tpu.models import resnet as ref_resnet
    from mxnet_tpu_torch.models import resnet as port_resnet
    model = ref_resnet if pkg is mx else port_resnet
    return model.get_symbol(num_classes=10, num_layers=18, stem="s2d",
                            image_shape="3,64,64")


CASES = {
    "transformer": lambda pkg, model: _tf(model),
    "transformer_flash_6": lambda pkg, model: _tf(model, 6,
                                                  attention="flash"),
    "three_layers": lambda pkg, model: _tf(model, 3),
    "mlp": lambda pkg, model: _mlp(pkg),
    "shared_weight": lambda pkg, model: _shared_weight(pkg),
    "heterogeneous": lambda pkg, model: _heterogeneous(pkg),
    "internal_exposed": _internal_exposed,
    "dropout_chain": lambda pkg, model: _dropout_chain(pkg),
    "resnet_bn": lambda pkg, model: _resnet(pkg),
}


@pytest.mark.parametrize("min_repeat", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_reference(case, min_repeat):
    """The same layers, families and pre / post nodes, or the same
    fallback (None), as the reference's plan of the same model."""
    # fresh name counters: auto-named nodes must not depend on what this
    # process built before
    with mx.name.NameManager():
        ref = ref_plan(CASES[case](mx, jax_transformer),
                       min_repeat=min_repeat)
    with mt.name.NameManager():
        got = port_plan(CASES[case](mt, port_transformer),
                        min_repeat=min_repeat)
    assert _names(got) == _names(ref)


def test_transformer_plan_shape():
    plan = port_plan(_tf(port_transformer), min_repeat=2)
    assert plan.n_layers == 4
    assert len(plan.var_lists) == 12          # 12 params per block
    assert all(len(v) == 4 for v in plan.var_lists.values())


def test_unstackable_bindings_fall_back():
    net = _tf(port_transformer)
    shapes = {n: (1,) for n in net.list_arguments()}
    shapes["layer2_ff1_weight"] = (2,)
    assert port_plan(net, min_repeat=2, shapes=shapes, dtypes={}) is None


def test_executor_knob_off_and_auto_threshold():
    net = _tf(port_transformer)
    config.set("MXNET_TPU_SCAN_LAYERS", "off")
    try:
        ex = net.simple_bind(mt.cpu(), data=(B, T), softmax_label=(B, T))
        assert ex._scan_plan is None
    finally:
        config.reset("MXNET_TPU_SCAN_LAYERS")
    with mt.profiler.counter_delta() as d:
        ex = net.simple_bind(mt.cpu(), data=(B, T), softmax_label=(B, T))
    assert ex._scan_plan is not None and ex._scan_plan.n_layers == 4
    assert d.get("scan_applied") == 1
    assert mt.profiler.get_gauge("scan_layers") == 4
    # auto needs 4 blocks; an integer lowers the minimum
    three = _tf(port_transformer, 3)
    assert three.simple_bind(mt.cpu(), data=(B, T),
                             softmax_label=(B, T))._scan_plan is None
    config.set("MXNET_TPU_SCAN_LAYERS", "2")
    try:
        assert three.simple_bind(mt.cpu(), data=(B, T), softmax_label=(
            B, T))._scan_plan.n_layers == 3
    finally:
        config.reset("MXNET_TPU_SCAN_LAYERS")


def test_no_plan_under_group2ctx():
    with mt.AttrScope(ctx_group="body"):
        net = _tf(port_transformer)
    ex = net.simple_bind(mt.cpu(), group2ctx={"body": mt.cpu()},
                         data=(B, T), softmax_label=(B, T))
    assert ex._scan_plan is None


def _bind_pair(net, shapes, seed=3):
    """Two executors over the same weights: scan off and scan on."""
    executors = []
    for mode in ("off", "2"):
        config.set("MXNET_TPU_SCAN_LAYERS", mode)
        try:
            executors.append(net.simple_bind(mt.cpu(), **shapes))
        finally:
            config.reset("MXNET_TPU_SCAN_LAYERS")
    ex0, ex1 = executors
    assert ex0._scan_plan is None and ex1._scan_plan is not None
    rs = np.random.RandomState(seed)
    for n, a in ex0.arg_dict.items():
        val = rs.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        a[:] = val
        ex1.arg_dict[n][:] = val
    return ex0, ex1


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_and_gradients_bit_identical(attention):
    ex0, ex1 = _bind_pair(_tf(port_transformer, attention=attention),
                          {"data": (B, T), "softmax_label": (B, T)})
    v = np.random.RandomState(1).randint(0, V, (B, T)).astype(np.float32)
    for ex in (ex0, ex1):
        ex.arg_dict["data"][:] = v
        ex.arg_dict["softmax_label"][:] = v
    np.testing.assert_array_equal(ex0.forward()[0].asnumpy(),
                                  ex1.forward()[0].asnumpy())
    for ex in (ex0, ex1):
        ex.forward(is_train=True)
        ex.backward()
    np.testing.assert_array_equal(ex0.outputs[0].asnumpy(),
                                  ex1.outputs[0].asnumpy())
    for n in ex0.grad_dict:
        np.testing.assert_array_equal(ex0.grad_dict[n].asnumpy(),
                                      ex1.grad_dict[n].asnumpy(), err_msg=n)


def test_plan_forward_matches_reference():
    """The plan's forward of the port against the reference's scanned
    forward of the same weights (1e-5: the same f32 formulas)."""
    net_r, net_p = _tf(jax_transformer), _tf(port_transformer)
    ex_r = net_r.simple_bind(mx.cpu(), data=(B, T), softmax_label=(B, T))
    ex_p = net_p.simple_bind(mt.cpu(), data=(B, T), softmax_label=(B, T))
    assert ex_r._scan_plan is not None and ex_p._scan_plan is not None
    rs = np.random.RandomState(4)
    v = rs.randint(0, V, (B, T)).astype(np.float32)
    for n, a in ex_r.arg_dict.items():
        val = v if n in ("data", "softmax_label") else \
            rs.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        a[:] = val
        ex_p.arg_dict[n][:] = val
    np.testing.assert_allclose(ex_p.forward()[0].asnumpy(),
                               ex_r.forward()[0].asnumpy(), atol=1e-5)


def test_dropout_masks_identical_with_the_plan():
    """Dropout inside the repeated block draws, layer by layer, the
    masks the unrolled graph draws from the same seed."""
    ex0, ex1 = _bind_pair(_dropout_chain(mt), {"data": (8, 16)})
    assert ex1._scan_plan.n_layers == 4
    v = np.random.RandomState(2).rand(8, 16).astype(np.float32)
    outs = []
    for ex in (ex0, ex1):
        ex.arg_dict["data"][:] = v
        mt.random.seed(7)
        outs.append(ex.forward(is_train=True)[0].asnumpy())
    np.testing.assert_array_equal(*outs)
    assert (outs[0] == 0).any() and (outs[0] != 0).any()


def test_monitor_sees_every_layer_node_with_the_plan():
    ex0, ex1 = _bind_pair(_tf(port_transformer),
                          {"data": (B, T), "softmax_label": (B, T)})
    names = []
    for ex in (ex0, ex1):
        ex.keep_node_outputs = True
        ex.forward()
        names.append(sorted(name for name, _ in ex.monitor_values()))
    assert names[0] == names[1]


@pytest.mark.parametrize("knob", ["1", "0"])
def test_update_groups_counted_from_the_plan(knob):
    """With the plan, each per-layer family of uniform multipliers is
    one update group (12 for the transformer block); the knob off counts
    none. The update is the same either way."""
    config.set("MXNET_TPU_GROUP_UPDATE", knob)
    try:
        mod = mt.mod.Module(_tf(port_transformer), context=mt.cpu())
        mod.bind(data_shapes=[("data", (B, T))],
                 label_shapes=[("softmax_label", (B, T))])
        mod.init_params(mt.init.Xavier())
        mt.profiler.set_gauge("fused_update_groups", 0)
        with mt.profiler.counter_delta() as d:
            mod.init_optimizer(optimizer="sgd")
    finally:
        config.reset("MXNET_TPU_GROUP_UPDATE")
    if knob == "1":
        assert d.get("fused_update_grouped") == 1
        assert mt.profiler.get_gauge("fused_update_groups") == 12
    else:
        assert d.get("fused_update_grouped") == 0


def test_fit_with_the_plan_equals_unrolled_fit():
    net = _tf(port_transformer)
    rs = np.random.RandomState(0)
    X = rs.randint(0, V, (4 * B, T)).astype(np.float32)
    init = None
    got = []
    for mode in ("off", "auto"):
        config.set("MXNET_TPU_SCAN_LAYERS", mode)
        try:
            mod = mt.mod.Module(net, context=mt.cpu())
            mod.bind(data_shapes=[("data", (B, T))],
                     label_shapes=[("softmax_label", (B, T))])
            if init is None:
                mod.init_params(mt.init.Xavier())
                init = {n: a.asnumpy()
                        for n, a in mod.get_params()[0].items()}
            mod.fit(mt.io.NDArrayIter(X, X, batch_size=B), num_epoch=2,
                    eval_metric=mt.metric.Loss(), arg_params=init,
                    force_init=True,
                    optimizer_params={"learning_rate": 0.05})
            assert (mod._exec._scan_plan is None) == (mode == "off")
            got.append({n: a.asnumpy()
                        for n, a in mod.get_params()[0].items()})
        finally:
            config.reset("MXNET_TPU_SCAN_LAYERS")
    for n in got[0]:
        np.testing.assert_array_equal(got[0][n], got[1][n], err_msg=n)
