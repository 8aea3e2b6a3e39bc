"""The port's optimizers, learning-rate schedules and update ops against
the reference's.

The same numpy weights and gradients (float32, from a seed) go through
the reference's eager ``Updater`` and through the port's, both per
parameter and grouped (``Updater.update_multi``, ``torch._foreach_*``),
for 3 steps, every optimizer of ``tests/test_fused_trainer.py`` under
its four variants (plain, a positive clip, a non-positive clip, weight
decay) with per-parameter lr/wd multipliers; rtol 1e-5, atol 1e-6 (the
same f32 formulas in another order: measured 7e-8 of max(1, max|w|)).
The schedules' values must equal the reference's exactly; a scheduler
boundary, lr/wd multipliers and multi-precision SGD run through Gluon's
``Trainer`` in both packages.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import get_op as ref_get_op

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6

OPTIMIZERS = [
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.9}),
    ("adam", {}),
    ("adagrad", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True}),
    ("adadelta", {}),
    ("ftrl", {}),
    ("adamax", {}),
    ("nadam", {}),
    ("dcasgd", {"momentum": 0.9}),
    ("test", {}),
    ("ccsgd", {"momentum": 0.9}),
    ("nag", {}),
    ("dcasgd", {}),
    ("rmsprop", {"centered": True, "clip_weights": 0.5}),
]

VARIANTS = [
    {},
    {"clip_gradient": 0.05},
    # a non-positive clip disables clipping in the update ops; Nadam and
    # DCASGD clip to [-c, c] whenever a clip is set, as the reference does
    {"clip_gradient": -1.0},
    {"wd": 0.01},
]

SHAPES = [(4, 5), (7,), (2, 3, 2)]
NAMES = {0: "a_weight", 1: "a_bias", 2: "b_weight"}


def _run_both(name, kw, steps=3, shapes=SHAPES, dtype=np.float32):
    """The reference's eager updater, the port's eager updater and the
    port's grouped one over the same weights and gradients."""
    rng = np.random.RandomState(0)
    ws = [rng.randn(*s).astype(dtype) for s in shapes]
    grads = [[rng.randn(*s).astype(dtype) for s in shapes]
             for _ in range(steps)]
    opts = [pkg.optimizer.create(name, param_idx2name=NAMES, **kw)
            for pkg in (mx, mt, mt)]
    for o in opts:
        o.set_lr_mult({"b_weight": 0.5})
        o.set_wd_mult({})
    jup, eup, gup = (pkg.optimizer.get_updater(o)
                     for pkg, o in zip((mx, mt, mt), opts))
    jw = [mx.nd.array(w, dtype=dtype) for w in ws]
    ew = [mt.nd.array(w, ctx=mt.cpu(), dtype=dtype) for w in ws]
    gw = [mt.nd.array(w, ctx=mt.cpu(), dtype=dtype) for w in ws]
    for gs in grads:
        for i, g in enumerate(gs):
            jup(i, mx.nd.array(g, dtype=dtype), jw[i])
            eup(i, mt.nd.array(g, ctx=mt.cpu(), dtype=dtype), ew[i])
        gup.update_multi(list(range(len(gs))), gw,
                         [torch.from_numpy(g) for g in gs])
    return opts, (jup, eup, gup), (jw, ew, gw)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [state.asnumpy()]


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: str(v))
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=lambda v: str(v))
def test_update_matches_reference(name, kw, variant):
    kw = dict(kw, learning_rate=0.1, rescale_grad=0.5, **variant)
    opts, updaters, (jw, ew, gw) = _run_both(name, kw)
    for i, j in enumerate(jw):
        want = j.asnumpy()
        np.testing.assert_allclose(ew[i].asnumpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg="per-parameter %d" % i)
        np.testing.assert_allclose(gw[i].asnumpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg="grouped %d" % i)
        states = [_leaves(u.states[i]) for u in updaters]
        assert len(states[0]) == len(states[1]) == len(states[2])
        for ref, eager, grouped in zip(*states):
            np.testing.assert_allclose(eager, ref, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(grouped, ref, rtol=RTOL, atol=ATOL)
    if name != "test":      # the reference's Test.update counts nothing
        assert opts[0].num_update == opts[1].num_update == \
            opts[2].num_update == 3


def test_every_reference_optimizer_is_registered():
    assert sorted(mt.optimizer.Optimizer.opt_registry) == \
        sorted(mx.optimizer.Optimizer.opt_registry)
    assert mt.optimizer.Optimizer.opt_registry["ccsgd"] is mt.optimizer.SGD
    with pytest.raises(ValueError, match="adam"):
        mt.optimizer.create("nosuch")


def test_custom_optimizer_takes_the_per_parameter_path():
    """A registered subclass that defines only ``update`` (the
    reference's way) trains through ``update_multi`` and Trainer."""
    @mt.optimizer.register
    class HalfStep(mt.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            lr = self._get_lr(index)
            self._update_count(index)
            weight.data.sub_(0.5 * lr * grad.data)

    try:
        w = mt.nd.array(np.ones(4, np.float32), ctx=mt.cpu())
        u = mt.optimizer.get_updater(mt.optimizer.create("halfstep",
                                                         learning_rate=0.2))
        u.update_multi([0], [w], [torch.full((4,), 2.0)])
        np.testing.assert_allclose(w.asnumpy(), np.full(4, 0.8))
        assert u.optimizer.num_update == 1
    finally:
        del mt.optimizer.Optimizer.opt_registry["halfstep"]


def test_sgld_draws_from_the_key_chain():
    """SGLD's noise has the reference's distribution (mean lr/2-step,
    variance lr), the same seed gives the same draws, and the grouped
    call takes the per-parameter path (the same draws again)."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(256, 256).astype(np.float32)
    g = rng.randn(256, 256).astype(np.float32)
    lr = 0.01

    def run(grouped):
        mt.random.seed(3)
        o = mt.optimizer.create("sgld", learning_rate=lr)
        u = mt.optimizer.get_updater(o)
        w = mt.nd.array(w0, ctx=mt.cpu())
        if grouped:
            u.update_multi([0], [w], [torch.from_numpy(g)])
        else:
            u(0, mt.nd.array(g, ctx=mt.cpu()), w)
        return w.asnumpy(), o.num_update

    a, n = run(False)
    b, _ = run(True)
    np.testing.assert_array_equal(a, b)
    assert n == 1
    noise = a - (w0 - lr / 2 * g)
    assert abs(noise.mean()) < 4 * math.sqrt(lr / noise.size)
    assert abs(noise.std() / math.sqrt(lr) - 1) < 0.02


# ------------------------------------------------------------ schedules

def _schedules(pkg):
    s = pkg.lr_scheduler
    return [s.FactorScheduler(step=3, factor=0.5),
            s.FactorScheduler(step=2, factor=0.1, stop_factor_lr=1e-3),
            s.MultiFactorScheduler(step=[2, 5, 9], factor=0.3),
            s.PolyScheduler(max_update=12, power=2.0)]


def test_schedules_equal_reference():
    for ref, port in zip(_schedules(mx), _schedules(mt)):
        ref.base_lr = port.base_lr = 0.7
        for n in [0, 1, 2, 3, 3, 4, 7, 8, 11, 12, 20, 40]:
            assert port(n) == ref(n), (type(port).__name__, n)
        assert port.base_lr == ref.base_lr


def test_schedule_arguments_checked():
    with pytest.raises(ValueError):
        mt.lr_scheduler.FactorScheduler(step=0)
    with pytest.raises(ValueError):
        mt.lr_scheduler.FactorScheduler(step=2, factor=1.5)
    with pytest.raises(ValueError):
        mt.lr_scheduler.MultiFactorScheduler(step=[3, 3])
    with pytest.raises(ValueError):
        mt.lr_scheduler.MultiFactorScheduler(step=[])


def test_optimizer_reads_its_scheduler():
    sched = mt.lr_scheduler.FactorScheduler(step=10, factor=0.5)
    o = mt.optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    assert sched.base_lr == 1.0 and o._get_lr(0) == 1.0
    o.num_update = 25
    assert o._get_lr(0) == 0.25


# ---------------------------------------------------- through Trainer

def _trainer_run(pkg, opt_name, opt_kw, shapes, steps, mults=False,
                 dtype="float32", seed=11):
    rng = np.random.RandomState(seed)
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    params = []
    for i, shp in enumerate(shapes):
        p = pkg.gluon.Parameter("p%d_weight" % i, shape=shp, dtype=dtype)
        if mults and i == 0:
            p.lr_mult, p.wd_mult = 0.5, 2.0
        p.initialize(**ctx)
        p.set_data(pkg.nd.array(rng.randn(*shp), dtype=dtype, **ctx))
        params.append(p)
    trainer = pkg.gluon.Trainer(params, opt_name, opt_kw)
    grads = np.random.RandomState(7)
    for _ in range(steps):
        for p in params:
            p.grad()[:] = pkg.nd.array(grads.randn(*p.shape), dtype=dtype,
                                       **ctx)
        trainer.step(batch_size=2)
    return [p.data().asnumpy() for p in params]


def test_scheduler_boundary_through_trainer():
    """The scheduler is read before ``num_update`` advances: at a
    boundary the step's first parameter still takes the old rate."""
    def run(pkg):
        sched = pkg.lr_scheduler.MultiFactorScheduler(step=[2, 4],
                                                      factor=0.5)
        return _trainer_run(pkg, "sgd", {"learning_rate": 0.2,
                                         "momentum": 0.9,
                                         "lr_scheduler": sched},
                            [(4, 3), (6,)], 6)

    for got, want in zip(run(mt), run(mx)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_lr_wd_mult_through_trainer(opt_name):
    kw = {"learning_rate": 0.1, "wd": 0.01}
    if opt_name == "sgd":
        kw["momentum"] = 0.9
    for got, want in zip(
            _trainer_run(mt, opt_name, kw, [(4, 5), (7,)], 3, mults=True),
            _trainer_run(mx, opt_name, kw, [(4, 5), (7,)], 3, mults=True)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_multi_precision_sgd():
    """An f16 weight keeps an f32 master copy: the update happens on the
    master and the weight is its f16 rounding, per parameter and grouped,
    as in the reference."""
    kw = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}
    _, (jup, eup, gup), (jw, ew, gw) = _run_both(
        "sgd", kw, shapes=[(3, 4), (5,)], dtype=np.float16)
    for i, j in enumerate(jw):
        assert ew[i].dtype == np.float16 and gw[i].dtype == np.float16
        master = jup.states[i][1].asnumpy()
        assert eup.states[i][1].dtype == np.float32
        np.testing.assert_allclose(eup.states[i][1].asnumpy(), master,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gup.states[i][1].asnumpy(), master,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ew[i].asnumpy(), j.asnumpy())
        np.testing.assert_array_equal(gw[i].asnumpy(), j.asnumpy())


def test_module_step_takes_one_count_and_rate():
    """``update_multi(lr=, t=)``, the Module step's form: every parameter
    takes rate ``lr`` and count ``t``, as the reference's ``raw_update``
    gives them in its fused step."""
    rng = np.random.RandomState(2)
    w0 = [rng.randn(3, 2).astype(np.float32) for _ in range(2)]
    g = [rng.randn(3, 2).astype(np.float32) for _ in range(2)]
    jo = mx.optimizer.create("adam", learning_rate=0.05)
    po = mt.optimizer.create("adam", learning_rate=0.05)
    states = [jo.create_state(i, mx.nd.array(w)) for i, w in enumerate(w0)]
    want = []
    for i in range(2):
        nw, _ = jo.raw_update(i, mx.nd.array(w0[i]).data,
                              mx.nd.array(g[i]).data,
                              tuple(s.data for s in states[i]), lr=0.02, t=4)
        want.append(np.asarray(nw))
    pu = mt.optimizer.get_updater(po)
    pw = [mt.nd.array(w, ctx=mt.cpu()) for w in w0]
    pu.update_multi([0, 1], pw, [torch.from_numpy(x) for x in g], lr=0.02,
                    t=4)
    assert po.num_update == 4
    for got, w in zip(pw, want):
        np.testing.assert_allclose(got.asnumpy(), w, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ update ops

def test_update_ops_are_registered_nd_ops():
    """The per-tensor update ops are ops of the registry under the
    reference's names, with their outputs counted."""
    from mxnet_tpu_torch.ops import get_op
    for name, outs in [("nag_mom_update", 2), ("adam_update", 3),
                       ("rmsprop_update", 2), ("rmspropalex_update", 4),
                       ("adagrad_update", 2), ("adadelta_update", 3),
                       ("ftrl_update", 3), ("adamax_update", 3),
                       ("sgld_update", 1)]:
        assert get_op(name).num_outputs == outs, name
        ref_get_op(name)
