"""The port's metrics against the reference's, and the metric state a
checkpoint carries.

Every metric takes the same numpy-drawn labels and predictions (float32,
from a seed) in both packages over three batches; the values agree
within rtol 1e-6 (the port sums on the device in float64, the reference
on the host: the same f32 per-batch terms added in another order). The
state round trips follow the reference's ``test_checkpoint.py``
(``test_metric_state_roundtrip``, ``test_composite_metric_restore_is_
all_or_nothing``) and cross the two packages in both directions.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RTOL = 1e-6


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _batches(kind, seed=0, n=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "class":
            pred = _softmax(rng.randn(8, 5).astype(np.float32))
            label = rng.randint(0, 5, (8,)).astype(np.float32)
        elif kind == "binary":
            pred = _softmax(rng.randn(8, 2).astype(np.float32))
            label = rng.randint(0, 2, (8,)).astype(np.float32)
        elif kind == "seq":
            pred = _softmax(rng.randn(12, 6).astype(np.float32))
            label = rng.randint(0, 6, (3, 4)).astype(np.float32)
        else:   # regression
            pred = rng.randn(8, 1).astype(np.float32)
            label = rng.randn(8).astype(np.float32)
        out.append((label, pred))
    return out


def _ties(seed=0, n=3):
    """Scores with ties, which a stable sort must rank as numpy's does."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 6, (10,)).astype(np.float32),
             rng.randint(0, 3, (10, 6)).astype(np.float32))
            for _ in range(n)]


def _mse_feval(label, pred):
    return float(((label.reshape(-1, 1) - pred) ** 2).mean())


def _sum_count_feval(label, pred):
    return float(np.abs(label.reshape(-1, 1) - pred).sum()), label.size


CASES = [
    ("acc", {}, "class"),
    ("accuracy", {"axis": 1}, "class"),
    ("top_k_accuracy", {"top_k": 3}, "class"),
    ("top_k_acc", {"top_k": 2}, "ties"),
    ("f1", {}, "binary"),
    ("perplexity", {"ignore_label": None}, "seq"),
    ("perplexity", {"ignore_label": 2}, "seq"),
    ("mae", {}, "reg"),
    ("mse", {}, "reg"),
    ("rmse", {}, "reg"),
    ("ce", {}, "class"),
    ("crossentropy", {"eps": 1e-8}, "class"),
    ("pearsoncorrelation", {}, "pearson"),
    ("loss", {}, "reg"),
    ("torch", {}, "reg"),
    ("caffe", {}, "reg"),
]

CUSTOM = [("np", _mse_feval), ("np", _sum_count_feval),
          ("create", _mse_feval)]


def _data(kind):
    if kind == "ties":
        return _ties()
    if kind == "pearson":
        rng = np.random.RandomState(3)
        return [(rng.randn(10).astype(np.float32),
                 rng.randn(10).astype(np.float32)) for _ in range(3)]
    return _batches(kind)


def _feed(pkg, metric, batches):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    for label, pred in batches:
        metric.update([pkg.nd.array(label, **ctx)],
                      [pkg.nd.array(pred, **ctx)])
    return metric.get()


def _same(got, want):
    names, values = got
    wnames, wvalues = want
    assert names == wnames
    np.testing.assert_allclose(values, wvalues, rtol=RTOL)


@pytest.mark.parametrize("name,kw,kind", CASES, ids=lambda v: str(v))
def test_metric_matches_reference(name, kw, kind):
    batches = _data(kind)
    got = _feed(mt, mt.metric.create(name, **kw), batches)
    want = _feed(mx, mx.metric.create(name, **kw), batches)
    _same(got, want)


@pytest.mark.parametrize("how,feval", CUSTOM,
                         ids=lambda v: getattr(v, "__name__", v))
def test_custom_metric_matches_reference(how, feval):
    batches = _batches("reg")
    if how == "np":
        pm, jm = mt.metric.np(feval), mx.metric.np(feval)
    else:
        pm, jm = mt.metric.create(feval), mx.metric.create(feval)
    assert pm.name == jm.name == feval.__name__
    _same(_feed(mt, pm, batches), _feed(mx, jm, batches))


def test_composite_matches_reference():
    batches = _batches("class")
    names = ["acc", "ce", ("top_k_acc", {"top_k": 2})]

    def build(pkg):
        return pkg.metric.CompositeEvalMetric(
            [pkg.metric.create(n) if isinstance(n, str)
             else pkg.metric.create(n[0], **n[1]) for n in names])

    got = _feed(mt, build(mt), batches)
    want = _feed(mx, build(mx), batches)
    _same(got, want)
    lst = mt.metric.create(["acc", "mse"])
    assert isinstance(lst, mt.metric.CompositeEvalMetric)
    assert lst.get()[0] == ["accuracy", "mse"]
    assert lst.get_metric(1).name == "mse"


def test_f1_refuses_more_than_two_classes():
    m = mt.metric.F1()
    with pytest.raises(ValueError, match="binary"):
        m.update([mt.nd.array([0, 1, 2], ctx=mt.cpu())],
                 [mt.nd.array(np.eye(3, 2), ctx=mt.cpu())])


def test_metric_sums_stay_on_the_device():
    """A device-summed metric holds a tensor between reads: the host
    reads the total once, in ``get``."""
    m = mt.metric.MSE()
    for label, pred in _batches("reg"):
        m.update([mt.nd.array(label, ctx=mt.cpu())],
                 [mt.nd.array(pred, ctx=mt.cpu())])
    assert m._sum is not None and m.sum_metric == 0.0
    m.get()
    assert m._sum is None and m.sum_metric > 0


# ------------------------------------------------------- checkpoint state

@pytest.mark.parametrize("src,dst", [(mt, mt), (mt, mx), (mx, mt)],
                         ids=["port-port", "port-ref", "ref-port"])
def test_metric_state_roundtrip(src, dst):
    m = src.metric.Accuracy()
    m.sum_metric, m.num_inst = 13.0, 42
    m2 = dst.metric.Accuracy()
    assert m2._ckpt_restore(m._ckpt_state())
    assert (m2.sum_metric, m2.num_inst) == (13.0, 42)

    comp = src.metric.CompositeEvalMetric(
        metrics=[src.metric.Accuracy(), src.metric.MSE()])
    comp.metrics[0].sum_metric = 3.0
    comp.metrics[1].num_inst = 9
    comp2 = dst.metric.CompositeEvalMetric(
        metrics=[dst.metric.Accuracy(), dst.metric.MSE()])
    assert comp2._ckpt_restore(comp._ckpt_state())
    assert comp2.metrics[0].sum_metric == 3.0
    assert comp2.metrics[1].num_inst == 9
    assert not comp2._ckpt_restore({"kind": "scalar"})


def test_device_sums_fold_into_the_state():
    """A state taken with sums still on the device holds them."""
    batches = _batches("seq")
    m = mt.metric.Perplexity(ignore_label=None)
    _feed(mt, m, batches[:2])
    m2 = mt.metric.Perplexity(ignore_label=None)
    for label, pred in batches[:2]:
        m2.update([mt.nd.array(label, ctx=mt.cpu())],
                  [mt.nd.array(pred, ctx=mt.cpu())])
    state = m2._ckpt_state()
    m3 = mt.metric.Perplexity(ignore_label=None)
    assert m3._ckpt_restore(state)
    assert m3.get() == m.get()


def test_composite_metric_restore_is_all_or_nothing():
    comp = mt.metric.CompositeEvalMetric(
        metrics=[mt.metric.Accuracy(), mt.metric.MSE()])
    comp.metrics[0].sum_metric, comp.metrics[0].num_inst = 3.0, 4
    state = comp._ckpt_state()
    state["children"][1] = {"kind": "bogus"}
    comp2 = mt.metric.CompositeEvalMetric(
        metrics=[mt.metric.Accuracy(), mt.metric.MSE()])
    assert not comp2._ckpt_restore(state)
    assert comp2.metrics[0].sum_metric == 0.0
    assert comp2.metrics[0].num_inst == 0


# ------------------------------------------------------------ initializers

def test_load_and_mixed_initializers(tmp_path):
    f = str(tmp_path / "p.params")
    mt.nd.save(f, {"arg:fc_weight": mt.nd.array([[1.0, 2.0]],
                                                ctx=mt.cpu())})
    init = mt.init.Load(f, default_init=mt.init.Zero())
    w = mt.nd.zeros((1, 2), ctx=mt.cpu())
    init("fc_weight", w)
    np.testing.assert_array_equal(w.asnumpy(), [[1.0, 2.0]])
    other = mt.nd.ones((2,), ctx=mt.cpu())
    init("other_weight", other)
    np.testing.assert_array_equal(other.asnumpy(), [0.0, 0.0])
    with pytest.raises(ValueError, match="shape mismatch"):
        init("fc_weight", mt.nd.zeros((2, 2), ctx=mt.cpu()))
    with pytest.raises(ValueError, match="no default"):
        mt.init.Load({"a": np.ones(2)})("b", other)

    mixed = mt.init.Mixed([".*bias", ".*"],
                          [mt.init.Constant(7.0), mt.init.Zero()])
    b = mt.nd.zeros((3,), ctx=mt.cpu())
    mixed("fc_bias", b)
    np.testing.assert_array_equal(b.asnumpy(), np.full(3, 7.0))
    with pytest.raises(ValueError, match="pattern"):
        mt.init.Mixed(["x.*"], [mt.init.Zero()])("fc_bias", b)


@pytest.mark.parametrize("name,kw,shape", [
    ("msraprelu", {}, (16, 8, 3, 3)),
    ("msraprelu", {"factor_type": "in", "slope": 0.1}, (32, 16)),
    ("bilinear", {}, (4, 1, 4, 4)),
])
def test_initializers_match_reference(name, kw, shape):
    """The same numpy generator state gives the same weights."""
    want = mx.nd.zeros(shape)
    np.random.seed(5)
    mx.init.create(name, **kw)("up_weight", want)
    got = mt.nd.zeros(shape, ctx=mt.cpu())
    np.random.seed(5)
    mt.init.create(name, **kw)("up_weight", got)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
