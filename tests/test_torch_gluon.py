"""The port's Gluon (``mxnet_tpu_torch.gluon``) against the reference's.

The cases of ``tests/test_gluon.py`` that need neither RNN, MoE nor
several devices, each run on the same numpy-seeded inputs and
parameters in both packages (the port on the CPU):

* Parameter and deferred init, their errors; the reference's parameter
  names for the same construction (prefixes, name scopes, counters);
* ``save_params`` / ``load_params`` across the two packages in both
  directions, in both containers (npz and the binary ``.params``);
* a seeded ``initialize`` gives the reference's weights exactly
  (deferred parameters materialise in the same order);
* hybridized equals eager, outputs and gradients within 1e-5 (they run
  the same ops here), and both equal the reference's;
* hybridized BatchNorm commits its running statistics as the
  reference's does, within 1e-6;
* the losses, with ``sample_weight`` and ``batch_axis``, within 1e-6 of
  the reference's, values and gradients;
* 5 ``Trainer`` steps of an MLP (SGD, momentum, wd, lr / wd
  multipliers) within 1e-5 of the reference's parameters;
* ``split_data``, ``split_and_load``, ``clip_global_norm``;
* ``DataLoader`` batches identical to the reference's.

Tolerances are of max(1, the largest magnitude) of each array: the same
f32 formulas summed in another order.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

PKGS = [mx, mt]


def _scope(pkg):
    return mt.device_scope("cpu") if pkg is mt else contextlib.nullcontext()


def _cpu(pkg):
    return pkg.cpu()


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _named_mlp(pkg, prefix="net_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", prefix="fc1_"),
                nn.Dense(2, prefix="fc2_"))
    return net


def _conv_bn_net(pkg, prefix):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(6, 3, strides=2, use_bias=False), nn.BatchNorm(),
                nn.LeakyReLU(0.1), nn.Flatten(), nn.Dense(8),
                nn.Dense(3, in_units=8))
    return net


def _xavier(pkg, seed=0):
    return pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2).set_rng(np.random.default_rng(seed))


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


# ------------------------------------------------------------- parameters

def test_parameter_basic():
    with mt.device_scope("cpu"):
        p = mt.gluon.Parameter("weight", shape=(3, 4))
        p.initialize(init=mt.init.One())
        np.testing.assert_allclose(p.data().asnumpy(), np.ones((3, 4)))
        assert p.grad().shape == (3, 4)
        assert p.list_ctx() == [torch.device("cpu")]
        p.set_data(np.full((3, 4), 2.0))
        np.testing.assert_allclose(p.data().asnumpy(), 2.0)
        p.grad()[:] = 5.0
        p.zero_grad()
        np.testing.assert_allclose(p.grad().asnumpy(), 0.0)
        p.cast("float16")
        assert p.data().dtype == np.float16 and p.grad().dtype == np.float16


def test_parameter_deferred_init():
    with mt.device_scope("cpu"):
        dense = mt.gluon.nn.Dense(4)
        dense.initialize()
        with pytest.raises(mt.gluon.DeferredInitializationError):
            dense.weight.data()
        out = dense(mt.nd.ones((2, 3)))
        assert out.shape == (2, 4)
        assert dense.weight.shape == (4, 3)


def test_parameter_errors():
    with mt.device_scope("cpu"):
        p = mt.gluon.Parameter("w", shape=(2,))
        with pytest.raises(MXNetError):
            p.data()
        with pytest.raises(MXNetError, match="A9"):
            p.initialize(ctx=[mt.cpu(), mt.cpu()])
        q = mt.gluon.Parameter("q_weight", shape=(2,), grad_req="null")
        q.initialize()
        with pytest.raises(MXNetError):
            q.grad()
        with pytest.raises(ValueError):
            q.grad_req = "sum"
        with pytest.raises(ValueError):
            mt.gluon.Parameter("z", shape=(0, 3)).initialize()
        with pytest.raises(MXNetError, match="A9"):
            mt.gluon.nn.MoE(8, 16, 4)


def test_entry_points_raise_without_a_gpu():
    """Without a GPU, a Gluon entry point called without ``ctx`` (and
    outside a device scope) raises, as the Module tests check."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    net = _named_mlp(mt, "nogpu_")
    with pytest.raises(MXNetError):
        net.initialize()
    with pytest.raises(MXNetError):
        mt.gluon.utils.split_and_load(np.ones((2, 2), np.float32),
                                      [mt.gpu(0)])


@pytest.mark.parametrize("build", [_named_mlp, _conv_bn_net],
                         ids=["mlp", "conv_bn"])
def test_parameter_names_match_reference(build):
    names = []
    for pkg in PKGS:
        with _scope(pkg):
            net = build(pkg, "same_")
            inner = pkg.gluon.nn.HybridSequential(prefix="outer_")
            with inner.name_scope():
                inner.add(pkg.gluon.nn.Dense(3), pkg.gluon.nn.Dense(3),
                          pkg.gluon.nn.BatchNorm(), pkg.gluon.nn.Embedding(
                              10, 4), pkg.gluon.nn.Conv2DTranspose(2, 3))
            names.append((list(net.collect_params().keys()),
                          list(inner.collect_params().keys())))
    assert names[0] == names[1]
    with mt.device_scope("cpu"):
        weights = list(build(mt, "sel_").collect_params(".*weight").keys())
    assert weights and all(n.endswith("weight") for n in weights)


def test_seeded_initialize_gives_the_reference_weights():
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    got = []
    for pkg in PKGS:
        with _scope(pkg):
            net = _conv_bn_net(pkg, "init_")
            net.initialize(_xavier(pkg, 5), ctx=_cpu(pkg))
            net(pkg.nd.array(x, ctx=_cpu(pkg)))
            got.append(_params(net))
    assert list(got[0]) == list(got[1])
    for k in got[0]:
        np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("container", ["npz", "mxnet"])
def test_params_interchange(tmp_path, direction, container):
    src, dst = (mx, mt) if direction == "reference_to_port" else (mt, mx)
    x = np.random.default_rng(2).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    fname = str(tmp_path / ("net.params"))
    with _scope(src):
        net = _conv_bn_net(src, "xchg_")
        net.initialize(_xavier(src, 7), ctx=_cpu(src))
        want = net(src.nd.array(x, ctx=_cpu(src))).asnumpy()
        if container == "npz":
            net.save_params(fname)
        else:
            src.nd.save(fname, {k: p.data() for k, p in
                                net.collect_params().items()},
                        format="mxnet")
        want_params = _params(net)
    with _scope(dst):
        net2 = _conv_bn_net(dst, "xchg_")
        net2.load_params(fname, ctx=_cpu(dst))
        got = net2(dst.nd.array(x, ctx=_cpu(dst))).asnumpy()
        got_params = _params(net2)
    assert list(got_params) == list(want_params)
    for k in want_params:
        np.testing.assert_array_equal(got_params[k], want_params[k])
    _close(got, want, 1e-6)


def test_load_params_errors(tmp_path):
    fname = str(tmp_path / "mlp.params")
    with mt.device_scope("cpu"):
        net = _named_mlp(mt, "err_")
        net.initialize(ctx=mt.cpu())
        net(mt.nd.ones((1, 2)))
        net.save_params(fname)
        other = _conv_bn_net(mt, "err2_")
        with pytest.raises(MXNetError):
            other.load_params(fname)
        with pytest.raises(ValueError):
            other.load_params(fname, allow_missing=True)
        other.load_params(fname, allow_missing=True, ignore_extra=True)


# ------------------------------------------------------------- hybridize

def _mlp_run(pkg, hybrid, x, y):
    with _scope(pkg):
        net = _named_mlp(pkg, "hyb_")
        net.initialize(_xavier(pkg, 9), ctx=_cpu(pkg))
        if hybrid:
            net.hybridize()
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        X = pkg.nd.array(x, ctx=_cpu(pkg))
        Y = pkg.nd.array(y, ctx=_cpu(pkg))
        with pkg.autograd.record():
            out = net(X)
            loss = loss_fn(out, Y)
        loss.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        return out.asnumpy(), loss.asnumpy(), grads


def test_hybridize_matches_eager_and_reference():
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
    runs = {(pkg.__name__, h): _mlp_run(pkg, h, x, y)
            for pkg in PKGS for h in (False, True)}
    port_e, port_h = runs[("mxnet_tpu_torch", False)], \
        runs[("mxnet_tpu_torch", True)]
    for ref in (runs[("mxnet_tpu", False)], runs[("mxnet_tpu", True)],
                port_e):
        _close(port_h[0], ref[0], 1e-5, "outputs")
        _close(port_h[1], ref[1], 1e-5, "loss")
        assert set(port_h[2]) == set(ref[2])
        for k in ref[2]:
            _close(port_h[2][k], ref[2][k], 1e-5, k)


def test_hybridize_cache_is_per_signature():
    with mt.device_scope("cpu"):
        net = _named_mlp(mt, "sig_")
        net.initialize(ctx=mt.cpu())
        net.hybridize()
        net(mt.nd.ones((2, 2)))
        net(mt.nd.ones((2, 2)))
        with mt.autograd.record():
            net(mt.nd.ones((3, 2)))
        assert len(net._cached_op) == 2
        assert sorted(net._cached_op.values()) == [1, 2]
        # children of a hybridized parent run inline: no entries of theirs
        assert all(not c._cached_op for c in net._children)
        net.hybridize(False)
        assert not net._cached_op


def test_hybridized_batchnorm_updates_running_stats_as_reference():
    x = np.random.RandomState(0).rand(4, 3, 6, 6).astype(np.float32)
    got = []
    for pkg in PKGS:
        with _scope(pkg):
            nn = pkg.gluon.nn
            net = nn.HybridSequential(prefix="bnnet_")
            with net.name_scope():
                net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                        nn.Activation("relu"), nn.Flatten(), nn.Dense(2))
            net.initialize(_xavier(pkg, 3), ctx=_cpu(pkg))
            net.hybridize()
            X = pkg.nd.array(x, ctx=_cpu(pkg))
            for _ in range(2):
                with pkg.autograd.record():
                    net(X)
            net(X)      # predict mode: no commit
            got.append({k: v for k, v in _params(net).items()
                        if "running" in k})
    assert list(got[0]) == list(got[1]) and len(got[0]) == 2
    for k in got[0]:
        assert np.abs(got[0][k]).sum() > 0
        _close(got[1][k], got[0][k], 1e-6, k)


def test_hybridized_dropout_masks_follow_the_training_flag():
    with mt.device_scope("cpu"):
        nn = mt.gluon.nn
        net = nn.HybridSequential(prefix="drop_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu"), nn.Dropout(0.5),
                    nn.Dense(4))
        net.initialize(ctx=mt.cpu())
        net.hybridize()
        x = mt.nd.array(np.random.RandomState(0).rand(8, 8))
        with mt.autograd.record():
            o1 = net(x)
            loss = (o1 * o1).sum()
        loss.backward()
        with mt.autograd.record():
            o2 = net(x)
        assert not np.allclose(o1.asnumpy(), o2.asnumpy())
        np.testing.assert_array_equal(net(x).asnumpy(), net(x).asnumpy())


def test_symbol_block_runs_the_graph_and_records():
    with mt.device_scope("cpu"):
        data = mt.sym.Variable("data")
        h = mt.sym.FullyConnected(data, num_hidden=5, name="fc1")
        h = mt.sym.Activation(h, act_type="tanh")
        out = mt.sym.FullyConnected(h, num_hidden=2, name="fc2")
        block = mt.gluon.SymbolBlock(out, data)
        names = sorted(block.collect_params().keys())
        assert names == ["fc1_bias", "fc1_weight", "fc2_bias", "fc2_weight"]
        rng = np.random.default_rng(0)
        vals = {"fc1_weight": rng.standard_normal((5, 3)),
                "fc1_bias": rng.standard_normal(5),
                "fc2_weight": rng.standard_normal((2, 5)),
                "fc2_bias": rng.standard_normal(2)}
        for n, v in vals.items():
            block.params[n]._load_init(mt.nd.array(v), mt.cpu())
        x = rng.standard_normal((4, 3)).astype(np.float32)
        with mt.autograd.record():
            y = block(mt.nd.array(x))
            loss = (y * y).sum()
        loss.backward()
        want = np.tanh(x @ vals["fc1_weight"].T + vals["fc1_bias"]) @ \
            vals["fc2_weight"].T + vals["fc2_bias"]
        _close(y.asnumpy(), want, 1e-5)
        g = block.params["fc2_bias"].grad().asnumpy()
        _close(g, 2 * want.sum(0), 1e-5)


# ------------------------------------------------------------- losses

def _loss_cases(rng):
    pred = rng.standard_normal((6, 5)).astype(np.float32)
    reg_label = rng.standard_normal((6, 5)).astype(np.float32)
    cls = rng.integers(0, 5, 6).astype(np.float32)
    prob = rng.random((6, 5)).astype(np.float32)
    dist = np.exp(rng.standard_normal((6, 5)))
    dist = (dist / dist.sum(1, keepdims=True)).astype(np.float32)
    logp = np.log(dist + 0.1).astype(np.float32)
    sw = rng.random((6, 1)).astype(np.float32)
    sig = (1 / (1 + np.exp(-pred))).astype(np.float32)
    return [
        ("L1Loss", {}, pred, reg_label, None),
        ("L1Loss", {"weight": 0.5}, pred, reg_label, sw),
        ("L2Loss", {}, pred, reg_label, None),
        ("L2Loss", {"weight": 2.0, "batch_axis": 1}, pred, reg_label, None),
        ("SigmoidBinaryCrossEntropyLoss", {}, pred, prob, sw),
        ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, sig, prob,
         None),
        ("SoftmaxCrossEntropyLoss", {}, pred, cls, None),
        ("SoftmaxCrossEntropyLoss", {}, pred, cls, sw),
        ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, pred, dist,
         None),
        ("SoftmaxCrossEntropyLoss", {"from_logits": True, "axis": 1},
         logp, cls, None),
        ("KLDivLoss", {}, logp, dist, None),
        ("KLDivLoss", {"from_logits": False}, pred, dist, sw),
    ]


@pytest.mark.parametrize("case", range(12))
def test_losses_match_reference(case):
    name, kw, pred, label, sw = _loss_cases(np.random.default_rng(11))[case]
    got = []
    for pkg in PKGS:
        with _scope(pkg):
            loss_fn = getattr(pkg.gluon.loss, name)(**kw)
            p = pkg.nd.array(pred, ctx=_cpu(pkg))
            p.attach_grad()
            args = [p, pkg.nd.array(label, ctx=_cpu(pkg))]
            if sw is not None:
                args.append(pkg.nd.array(sw, ctx=_cpu(pkg)))
            with pkg.autograd.record():
                out = loss_fn(*args)
            out.backward()
            got.append((out.asnumpy(), p.grad.asnumpy()))
    _close(got[1][0], got[0][0], 1e-6, "loss")
    _close(got[1][1], got[0][1], 1e-6, "gradient")


def test_softmax_ce_against_numpy():
    rng = np.random.RandomState(0)
    pred = rng.randn(8, 5).astype(np.float32)
    label = rng.randint(0, 5, (8,)).astype(np.float32)
    with mt.device_scope("cpu"):
        got = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
            mt.nd.array(pred), mt.nd.array(label)).asnumpy()
    e = np.exp(pred - pred.max(1, keepdims=True))
    p = e / e.sum(1, keepdims=True)
    np.testing.assert_allclose(got, -np.log(p[np.arange(8),
                                              label.astype(int)]),
                               rtol=1e-5)


# ------------------------------------------------------------- trainer

def _trainer_run(pkg, x, y, steps=5):
    with _scope(pkg):
        net = _named_mlp(pkg, "tr_")
        net.initialize(_xavier(pkg, 13), ctx=_cpu(pkg))
        params = net.collect_params()
        params["tr_fc1_weight"].lr_mult = 0.5
        params["tr_fc2_bias"].wd_mult = 0.0
        trainer = pkg.gluon.Trainer(params, "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        X, Y = pkg.nd.array(x, ctx=_cpu(pkg)), pkg.nd.array(y, ctx=_cpu(pkg))
        losses = []
        for i in range(steps):
            if i == 3:
                trainer.set_learning_rate(0.05)
            with pkg.autograd.record():
                loss = loss_fn(net(X), Y)
            loss.backward()
            trainer.step(x.shape[0])
            losses.append(loss.asnumpy())
        assert trainer.learning_rate == 0.05
        return losses, _params(net)


def test_five_trainer_steps_match_reference():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (20, 2)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
    (jl, jp), (pl, pp) = _trainer_run(mx, x, y), _trainer_run(mt, x, y)
    for a, b in zip(pl, jl):
        _close(a, b, 1e-5, "loss")
    assert list(pp) == list(jp)
    for k in jp:
        _close(pp[k], jp[k], 1e-5, k)


def test_trainer_converges_and_saves_states(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    y = ((x[:, 0] * x[:, 1]) > 0).astype(np.float32)
    with mt.device_scope("cpu"):
        net = _named_mlp(mt, "conv_")
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.5, "momentum": 0.9})
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        X, Y = mt.nd.array(x), mt.nd.array(y)
        for _ in range(60):
            with mt.autograd.record():
                loss = loss_fn(net(X), Y)
            loss.backward()
            trainer.step(x.shape[0])
        acc = (net(X).asnumpy().argmax(1) == y).mean()
        assert acc > 0.95, acc
        fname = str(tmp_path / "trainer.states")
        trainer.save_states(fname)
        before = {i: s.asnumpy() for i, s in
                  trainer._updaters.states.items()}
        trainer2 = mt.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.5, "momentum": 0.9})
        trainer2.load_states(fname)
        for i, s in before.items():
            np.testing.assert_array_equal(
                trainer2._updaters.states[i].asnumpy(), s)


def test_trainer_refuses_a_distributed_kvstore():
    with mt.device_scope("cpu"):
        net = _named_mlp(mt, "kv_")
        net.initialize(ctx=mt.cpu())
        with pytest.raises(MXNetError, match="A9"):
            mt.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
        with pytest.raises(ValueError):
            mt.gluon.Trainer([1, 2], "sgd")


# ------------------------------------------------------------- utils

def test_split_and_load_and_clip_global_norm():
    data = np.arange(24, dtype=np.float32).reshape(8, 3)
    got = []
    for pkg in PKGS:
        with _scope(pkg):
            arr = pkg.nd.array(data, ctx=_cpu(pkg))
            parts = pkg.gluon.utils.split_data(arr, 4)
            uneven = pkg.gluon.utils.split_data(arr, 3, even_split=False)
            cols = pkg.gluon.utils.split_data(arr, 3, batch_axis=1)
            loaded = pkg.gluon.utils.split_and_load(data, [_cpu(pkg)])
            arrays = [pkg.nd.array(np.ones(4, np.float32), ctx=_cpu(pkg)),
                      pkg.nd.array(np.full(4, 2.0, np.float32),
                                   ctx=_cpu(pkg))]
            norm = pkg.gluon.utils.clip_global_norm(arrays, 1.0)
            got.append(([p.asnumpy() for p in parts + uneven + cols] +
                        [loaded[0].asnumpy()], norm,
                        [a.asnumpy() for a in arrays]))
    assert len(got[0][0]) == len(got[1][0])
    for a, b in zip(got[1][0], got[0][0]):
        np.testing.assert_array_equal(a, b)
    assert abs(got[1][1] - got[0][1]) < 1e-5
    for a, b in zip(got[1][2], got[0][2]):
        _close(a, b, 1e-6)
    total = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                        for a in got[1][2]))
    assert abs(total - 1.0) < 1e-5
    with pytest.raises(ValueError):
        mt.gluon.utils.split_data(mt.nd.array(data, ctx=mt.cpu()), 3)
    with pytest.raises(MXNetError, match="A9"):
        mt.gluon.utils.split_and_load(data, [mt.cpu(), mt.cpu()])


# ------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [
    {"batch_size": 6, "last_batch": "keep"},
    {"batch_size": 6, "last_batch": "discard"},
    {"batch_size": 7, "last_batch": "rollover"},
    {"batch_size": 5, "shuffle": True},
    {"batch_size": 5, "num_workers": 2}], ids=str)
def test_dataloader_batches_match_reference(kw):
    x = np.arange(40).reshape(20, 2).astype(np.float32)
    y = np.arange(20).astype(np.float32)
    got = []
    for pkg in PKGS:
        with _scope(pkg):
            ds = pkg.gluon.data.ArrayDataset(x, y)
            loader = pkg.gluon.data.DataLoader(ds, **kw)
            np.random.seed(5)
            epochs = [[(b[0].asnumpy(), b[1].asnumpy()) for b in loader]
                      for _ in range(2)]
            got.append((len(loader), epochs))
    assert got[0][0] == got[1][0]
    for e_ref, e_port in zip(got[0][1], got[1][1]):
        assert len(e_ref) == len(e_port)
        for (a, b), (c, d) in zip(e_ref, e_port):
            np.testing.assert_array_equal(c, a)
            np.testing.assert_array_equal(d, b)


def test_dataset_transforms_and_samplers():
    with mt.device_scope("cpu"):
        data = mt.gluon.data
        ds = data.SimpleDataset(list(range(10)))
        assert [ds.transform(lambda v: v * 2)[i] for i in range(3)] == \
            [0, 2, 4]
        pairs = data.ArrayDataset(np.arange(4), np.arange(4) + 10)
        first = pairs.transform_first(lambda v: v + 100, lazy=False)
        assert [tuple(first[i]) for i in range(2)] == [(100, 10),
                                                      (101, 11)]
        sampler = data.BatchSampler(data.SequentialSampler(7), 3,
                                    "rollover")
        assert list(sampler) == [[0, 1, 2], [3, 4, 5]]
        assert list(sampler) == [[6, 0, 1], [2, 3, 4]]
        with pytest.raises(ValueError):
            data.ArrayDataset(np.arange(3), np.arange(4))
        loader = data.DataLoader(
            ds, batch_size=2, num_workers=1,
            batchify_fn=lambda b: 1 // (b[0] - 4))
        with pytest.raises(ZeroDivisionError):
            list(loader)
