"""The port's Module inference surface against the reference's.

The cases of ``tests/test_module.py`` that the port's earlier slices
left out (``test_module_bind_and_shapes``, ``_save_load_checkpoint``,
``_fixed_params_not_trained``, ``_predict_and_score``) and the two
Monitor cases of ``tests/test_profiler.py`` run on the same numpy
inputs in both packages: the port on the CPU with the reference's
initial parameters. ``save_params`` files cross the packages both ways,
``predict`` keeps the reference's merging and padding behaviour, and a
two-stage ``SequentialModule`` trains as the same net in one ``Module``.
Float32 outputs and parameters agree within 1e-5 (the same formulas,
summed in another order); a Monitor's statistics within 1e-5 of their
value.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.device_scope("cpu"):
        yield


def _xor_like_data(n=800, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    y = ((x[:, 0] * x[:, 1]) > 0).astype(np.float32)
    return x, y


def _mlp_symbol(pkg, num_hidden=16, num_classes=2):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    act1 = pkg.sym.Activation(fc1, act_type="tanh", name="tanh1")
    fc2 = pkg.sym.FullyConnected(act1, num_hidden=num_classes, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _pair(batch, fixed=None, init=None):
    """A reference Module and a port Module of the MLP, bound at
    ``batch`` rows, the port's parameters set from the reference's."""
    shapes = dict(data_shapes=[("data", (batch, 2))],
                  label_shapes=[("softmax_label", (batch,))])
    jm = mx.mod.Module(_mlp_symbol(mx), context=mx.cpu(),
                       fixed_param_names=fixed)
    jm.bind(**shapes)
    jm.init_params(init or mx.init.Xavier())
    pm = mt.mod.Module(_mlp_symbol(mt), context=mt.cpu(),
                       fixed_param_names=fixed)
    pm.bind(**shapes)
    pm.set_params({k: v.asnumpy() for k, v in jm.get_params()[0].items()},
                  {})
    return jm, pm


def _same_params(jm, pm, atol=ATOL):
    ja, pa = jm.get_params()[0], pm.get_params()[0]
    assert sorted(ja) == sorted(pa)
    for k in ja:
        np.testing.assert_allclose(pa[k].asnumpy(), ja[k].asnumpy(),
                                   atol=atol, err_msg=k)


def _batch(pkg, x, y=None, pad=0):
    return pkg.io.DataBatch(data=[pkg.nd.array(x)],
                            label=None if y is None else [pkg.nd.array(y)],
                            pad=pad)


def test_module_bind_and_shapes():
    """The shapes as the reference reports them. The port's
    ``output_shapes`` is inferred at bind; the reference's reads the
    last forward's outputs and raises before one (ROADMAP C12), so it is
    asked after a forward."""
    jm, pm = _pair(8)
    assert pm.binded
    assert pm.data_shapes[0].shape == jm.data_shapes[0].shape == (8, 2)
    assert pm.label_shapes[0].shape == jm.label_shapes[0].shape == (8,)
    port_shapes = pm.output_shapes
    x, y = _xor_like_data(8)
    jm.forward(_batch(mx, x, y), is_train=False)
    assert [tuple(s) for _, s in port_shapes] == \
        [tuple(s) for _, s in jm.output_shapes] == [(8, 2)]
    assert [n for n, _ in port_shapes] == [n for n, _ in jm.output_shapes]
    arg_params, aux_params = pm.get_params()
    assert set(arg_params) == {"fc1_weight", "fc1_bias",
                               "fc2_weight", "fc2_bias"}
    assert aux_params == {}


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_module_save_load_checkpoint(tmp_path, direction):
    """``save_params`` of one package, ``load_params`` of the other; the
    loaded parameters drive the executor (the forwards agree), and
    ``save_checkpoint`` / ``Module.load`` carry the same file names."""
    jm, pm = _pair(4)
    src, dst = (jm, pm) if direction == "reference_to_port" else (pm, jm)
    fname = str(tmp_path / "mlp.params")
    src.save_params(fname)
    fresh = (mt if dst is pm else mx).mod.Module(
        _mlp_symbol(mt if dst is pm else mx),
        context=mt.cpu() if dst is pm else mx.cpu())
    fresh.bind(data_shapes=[("data", (4, 2))],
               label_shapes=[("softmax_label", (4,))])
    fresh.load_params(fname)
    want = src.get_params()[0]
    got = fresh.get_params()[0]
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=0, atol=0)
    x, y = _xor_like_data(4)
    pkg_src = mt if src is pm else mx
    pkg_dst = mt if dst is pm else mx
    src.forward(_batch(pkg_src, x, y), is_train=False)
    fresh.forward(_batch(pkg_dst, x, y), is_train=False)
    np.testing.assert_allclose(fresh.get_outputs()[0].asnumpy(),
                               src.get_outputs()[0].asnumpy(), atol=ATOL)
    prefix = str(tmp_path / "ckpt")
    pm.init_optimizer()
    pm.save_checkpoint(prefix, 3, save_optimizer_states=True)
    for suffix in ("-symbol.json", "-0003.params", "-0003.states"):
        assert (tmp_path / ("ckpt" + suffix)).exists()


def test_module_fixed_params_not_trained():
    """``fixed_param_names`` stay frozen on the fused and the unfused
    step, and the trained parameters move as the reference's."""
    x, y = _xor_like_data(16)
    jm, pm = _pair(16, fixed=["fc1_weight"])
    for m in (jm, pm):
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.5})
    w_fixed = pm.get_params()[0]["fc1_weight"].asnumpy().copy()
    w_free = pm.get_params()[0]["fc2_weight"].asnumpy().copy()
    for m, pkg in ((jm, mx), (pm, mt)):
        m._fit_step(_batch(pkg, x, y))
        m.forward_backward(_batch(pkg, x, y))
        m.update()
    p = pm.get_params()[0]
    np.testing.assert_array_equal(p["fc1_weight"].asnumpy(), w_fixed)
    assert not np.allclose(p["fc2_weight"].asnumpy(), w_free)
    _same_params(jm, pm)


def test_module_predict_and_score():
    x, y = _xor_like_data(100)
    jm, pm = _pair(25)
    its = [pkg.io.NDArrayIter(x, y, batch_size=25,
                              label_name="softmax_label")
           for pkg in (mx, mt)]
    jout, pout = jm.predict(its[0]), pm.predict(its[1])
    assert pout.shape == jout.shape == (100, 2)
    np.testing.assert_allclose(pout.asnumpy(), jout.asnumpy(), atol=ATOL)
    jres, pres = jm.score(its[0], "acc"), pm.score(its[1], "acc")
    assert pres[0][0] == jres[0][0]
    assert pres[0][1] == pytest.approx(jres[0][1], abs=1e-12)


def test_predict_drops_padding_and_keeps_batches():
    """A padded last batch loses its pad rows; ``merge_batches=False``
    keeps one list per batch; ``num_batch`` stops early;
    ``always_output_list`` wraps the one output; ``iter_predict`` yields
    the same outputs with the batch number."""
    x, y = _xor_like_data(90, seed=4)
    jm, pm = _pair(25)
    its = [pkg.io.NDArrayIter(x, y, batch_size=25, last_batch_handle="pad",
                              label_name="softmax_label")
           for pkg in (mx, mt)]
    for kw in ({}, {"merge_batches": False}, {"num_batch": 2},
               {"always_output_list": True}):
        want, got = jm.predict(its[0], **kw), pm.predict(its[1], **kw)
        want = want if isinstance(want, list) else [want]
        got = got if isinstance(got, list) else [got]
        assert len(got) == len(want), kw
        for w, g in zip(want, got):
            w = w if isinstance(w, list) else [w]
            g = g if isinstance(g, list) else [g]
            for wi, gi in zip(w, g):
                assert gi.shape == wi.shape, kw
                np.testing.assert_allclose(gi.asnumpy(), wi.asnumpy(),
                                           atol=ATOL)
    assert pm.predict(its[1]).shape == (90, 2)
    n = 0
    for (outs, nb, batch), (wouts, wnb, _) in zip(pm.iter_predict(its[1]),
                                                  jm.iter_predict(its[0])):
        assert nb == wnb == n
        np.testing.assert_allclose(outs[0].asnumpy(), wouts[0].asnumpy(),
                                   atol=ATOL)
        n += 1
    assert n == 4


def test_reshape_keeps_parameters():
    """``reshape`` to another batch size keeps the parameters (the same
    arrays) and the forward agrees with the reference's reshaped
    module."""
    jm, pm = _pair(8)
    before = pm.get_params()[0]["fc1_weight"]
    for m in (jm, pm):
        m.reshape(data_shapes=[("data", (3, 2))],
                  label_shapes=[("softmax_label", (3,))])
    assert pm.data_shapes[0].shape == (3, 2)
    assert pm._exec.arg_dict["fc1_weight"] is before
    x, y = _xor_like_data(3, seed=2)
    jm.forward(_batch(mx, x, y), is_train=False)
    pm.forward(_batch(mt, x, y), is_train=False)
    np.testing.assert_allclose(pm.get_outputs()[0].asnumpy(),
                               jm.get_outputs()[0].asnumpy(), atol=ATOL)


def _state_symbol(pkg):
    data = pkg.sym.Variable("data")
    state = pkg.sym.Variable("state", shape=(2, 3))
    out = pkg.sym.FullyConnected(data, num_hidden=3, name="fc") + state
    return pkg.sym.MakeLoss(out, name="loss")


def test_get_and_set_states():
    """States are inputs the caller sets: ``set_states(value=)`` fills,
    ``set_states(states)`` copies, ``get_states`` returns the arrays;
    the outputs follow as the reference's do."""
    mods = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        m = pkg.mod.Module(_state_symbol(pkg), context=ctx,
                           label_names=None, state_names=["state"])
        m.bind(data_shapes=[("data", (2, 4))], for_training=False)
        m.init_params(pkg.init.Uniform(0.1))
        mods.append(m)
    jm, pm = mods
    pm.set_params({k: v.asnumpy() for k, v in jm.get_params()[0].items()},
                  {})
    x = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    st = np.arange(6, dtype=np.float32).reshape(2, 3)
    for kw in ({"value": 1.5}, {"states": [st]}):
        for m, pkg in ((jm, mx), (pm, mt)):
            if "states" in kw:
                m.set_states(states=[pkg.nd.array(st)])
            else:
                m.set_states(**kw)
            m.forward(_batch(pkg, x), is_train=False)
        np.testing.assert_allclose(pm.get_states()[0].asnumpy(),
                                   jm.get_states()[0].asnumpy())
        np.testing.assert_allclose(pm.get_outputs()[0].asnumpy(),
                                   jm.get_outputs()[0].asnumpy(), atol=ATOL)


# ----------------------------------------------------------------- monitor

def _monitor_mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def test_monitor_collects_per_op_stats():
    """``test_profiler.py``'s case: a pattern-filtered Monitor on a bound
    executor reports every fc node's statistic, as the reference's
    does, and nothing else."""
    stats = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        ex = _monitor_mlp(pkg).simple_bind(ctx=ctx, data=(4, 6),
                                           softmax_label=(4,))
        for name, arr in ex.arg_dict.items():
            if name not in ("data", "softmax_label"):
                arr[:] = np.random.RandomState(0).rand(*arr.shape).astype(
                    np.float32)
        ex.arg_dict["data"][:] = np.random.RandomState(1).rand(4, 6).astype(
            np.float32)
        ex.arg_dict["softmax_label"][:] = np.array([0, 1, 0, 1], np.float32)
        mon = pkg.mon.Monitor(interval=1, pattern=".*fc.*")
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=True)
        stats.append(mon.toc())
    want, got = stats
    assert [k for _, k, _ in got] == [k for _, k, _ in want]
    assert any("fc1" in k for _, k, _ in got)
    assert any("fc2" in k for _, k, _ in got)
    assert not any("relu" in k for _, k, _ in got)
    for (gs, _, gv), (ws, _, wv) in zip(got, want):
        assert gs == ws
        assert float(gv) == pytest.approx(float(wv), rel=1e-5)


def test_monitor_of_the_outputs_only():
    """``install(monitor_all=False)``: the graph outputs only, through
    the forward callback, once per armed step."""
    ex = _monitor_mlp(mt).simple_bind(ctx=mt.cpu(), data=(4, 6),
                                      softmax_label=(4,))
    mon = mt.mon.Monitor(interval=2)
    mon.install(ex, monitor_all=False)
    seen = []
    for _ in range(3):
        mon.tic()
        ex.forward(is_train=False)
        seen.append([k for _, k, _ in mon.toc()])
    assert seen == [["softmax_output"], [], ["softmax_output"]]


def test_monitor_through_module_fit(capsys):
    """``fit(monitor=)`` no longer raises: the monitor is installed,
    ticks every batch and prints its statistics every ``interval``
    steps; the trained parameters match the reference's fit with a
    monitor (the unfused step in both)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (40, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    mods, mons = [], []
    start = None
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        it = pkg.io.NDArrayIter(x, y, batch_size=20,
                                label_name="softmax_label")
        mod = pkg.mod.Module(_monitor_mlp(pkg), context=ctx)
        mon = pkg.mon.Monitor(interval=2)
        if start is None:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(mx.init.Xavier())
            start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                num_epoch=1, monitor=mon,
                arg_params={k: pkg.nd.array(v) for k, v in start.items()})
        mods.append(mod)
        mons.append(mon)
    assert mons[1].step == mons[0].step == 2
    assert "fc1_output" in capsys.readouterr().out
    _same_params(*mods)


# ------------------------------------------------------- sequential module

def _stage(pkg, name, hidden, head):
    data = pkg.sym.Variable("data")
    out = pkg.sym.FullyConnected(data, num_hidden=hidden, name=name)
    if head:
        return pkg.sym.SoftmaxOutput(out, name="softmax")
    return pkg.sym.Activation(out, act_type="tanh", name=name + "_act")


def test_sequential_module_matches_one_module():
    """Two port Modules chained in a ``SequentialModule`` train as the
    same net in one reference ``Module``: outputs and three SGD steps'
    parameters agree."""
    x, y = _xor_like_data(16, seed=7)
    jm, _ = _pair(16)
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(_stage(mt, "fc1", 16, False), context=mt.cpu(),
                          label_names=None))
    seq.add(mt.mod.Module(_stage(mt, "fc2", 2, True), context=mt.cpu()),
            take_labels=True, auto_wiring=True)
    seq.bind(data_shapes=[("data", (16, 2))],
             label_shapes=[("softmax_label", (16,))])
    seq.init_params(arg_params={k: v.asnumpy() for k, v in
                                jm.get_params()[0].items()},
                    allow_missing=False, allow_extra=True)
    assert [tuple(s) for _, s in seq.output_shapes] == [(16, 2)]
    opt = {"learning_rate": 0.5, "momentum": 0.9}
    jm.init_optimizer(optimizer="sgd", optimizer_params=opt)
    seq.init_optimizer(optimizer="sgd", optimizer_params=opt)
    for _ in range(3):
        jm.forward_backward(_batch(mx, x, y))
        jm.update()
        seq.forward_backward(_batch(mt, x, y))
        seq.update()
        np.testing.assert_allclose(seq.get_outputs()[0].asnumpy(),
                                   jm.get_outputs()[0].asnumpy(), atol=ATOL)
    _same_params(jm, seq)
    metric = mt.metric.create("acc")
    seq.update_metric(metric, [mt.nd.array(y)])
    assert metric.get()[1] >= 0.0
