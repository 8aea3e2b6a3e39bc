"""The port's compiled whole-model update (``_fused.FusedUpdater``)
against the reference's fused trainer step (``mxnet_tpu/_fused.py``).

The counterparts of ``tests/test_fused_trainer.py`` (its LayerNorm
knob case lives in ``tests/test_torch_tune.py``): the same numpy weights
and gradients go through the reference's fused ``Trainer`` and through
the port's, for every built-in optimizer x {plain, a positive clip, a
non-positive clip, wd, lr / wd multipliers, a null-grad parameter}, 3
steps, at the reference's own bound between its fused and eager steps
(rtol 1e-4, atol 1e-6; multi-precision SGD 1e-3): a compiled program
rounds in its own order. The port's compiled route is also held to its
own eager grouped update (``Updater.update_multi``) at that bound, and
the knob off is that eager update bit for bit.

The counters follow the reference's: one ``trainer_step_compile`` per
structure, a ``trainer_step_cache_hit`` per later step, no recompile on
an lr / wd / clip-value / batch-size change, one on a shape change or
clipping switched on or off; SGLD and a stateful custom optimizer stay
on the eager path with no compile. And the port's own routes: the
identity of every NDArray and state, the tensors' version counters, a
state aliased to its weight, a step inside ``record()``, a dynamo
recompile counted (``loop_recompile``), the recompile limit and a graph
break each failing over to the counted eager update, never silently;
the analyzer's counting run on the eager update; a tuner probe refusing
an update that recompiles. Last, ``chip_smoke.py``'s phase 23 and its
warm-up body rehearsed on the host at a small width, and the checks
that end it when the compiled update runs eagerly or drifts.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import config as ref_cfg
from mxnet_tpu import optimizer as ref_opt
from mxnet_tpu import profiler as ref_profiler
from mxnet_tpu_torch import _fused, autograd, config as cfg
from mxnet_tpu_torch import optimizer as opt
from mxnet_tpu_torch import profiler

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6

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
]

# (optimizer kwargs, run kwargs): the reference's four variants with a
# null-grad parameter riding along, plus lr / wd multipliers and the
# plain case without the frozen parameter
VARIANTS = {
    "plain": ({}, {"with_null": False}),
    "null": ({}, {}),
    "clip": ({"clip_gradient": 0.05}, {}),
    "clip_off": ({"clip_gradient": -1.0}, {}),
    "wd": ({"wd": 0.01}, {}),
    "mults": ({"wd": 0.01}, {"mults": True}),
}


@pytest.fixture(autouse=True)
def _on_the_host():
    with mt.cpu():
        yield


def _delta(pkg_profiler, names):
    snap = {n: pkg_profiler.get_counter(n) for n in names}
    return lambda n: pkg_profiler.get_counter(n) - snap[n]


def _params(pkg, shapes, seed=0, mults=False, with_null=False,
            dtype=np.float32):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    rng = np.random.RandomState(seed)
    params = []
    for i, shp in enumerate(shapes):
        p = pkg.gluon.Parameter("p%d_weight" % i, shape=shp, dtype=dtype)
        if mults and i == 0:
            p.lr_mult, p.wd_mult = 0.5, 2.0
        p.initialize(**ctx)
        p.set_data(pkg.nd.array(rng.randn(*shp).astype(dtype), dtype=dtype,
                                **ctx))
        params.append(p)
    if with_null:
        p = pkg.gluon.Parameter("frozen_weight", shape=(3,),
                                grad_req="null")
        p.initialize(**ctx)
        p.set_data(pkg.nd.array(np.ones(3, np.float32), **ctx))
        params.append(p)
    return params


def _run_steps(pkg, opt_name, opt_kwargs, fused, steps=3, mults=False,
               with_null=True, shapes=((4, 5), (7,), (2, 3, 2))):
    """The reference's ``_run_steps`` in either package: a Trainer over
    ``shapes`` (and a frozen parameter), ``steps`` steps of the same
    numpy gradients at batch size 2."""
    config = cfg if pkg is mt else ref_cfg
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    config.set("MXNET_TPU_FUSED_TRAINER", fused)
    try:
        params = _params(pkg, shapes, mults=mults, with_null=with_null)
        live = [p for p in params if p.grad_req != "null"]
        kw = dict(opt_kwargs)
        kw.setdefault("learning_rate", 0.1)
        trainer = pkg.gluon.Trainer(params, opt_name, kw)
        rng = np.random.RandomState(99)
        for _ in range(steps):
            for p in live:
                p.grad()[:] = pkg.nd.array(
                    rng.randn(*p.shape).astype(np.float32), **ctx)
            trainer.step(batch_size=2)
        return [p.data().asnumpy() for p in params], trainer
    finally:
        config.reset("MXNET_TPU_FUSED_TRAINER")


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("opt_name,opt_kwargs", OPTIMIZERS,
                         ids=lambda v: str(v))
def test_fused_parity(opt_name, opt_kwargs, variant):
    okw, rkw = VARIANTS[variant]
    kw = dict(opt_kwargs, **okw)
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_cache_hit",
                          "trainer_step_fallback"])
    got, _ = _run_steps(mt, opt_name, kw, fused=True, **rkw)
    # engaged every step: one compile or hit per step
    assert d("trainer_step_compile") + d("trainer_step_cache_hit") == 3, \
        "compiled update did not engage for %s %s" % (opt_name, kw)
    assert d("trainer_step_compile") == 1
    assert d("trainer_step_fallback") == 0
    ref, _ = _run_steps(mx, opt_name, kw, fused=True, **rkw)
    _close(got, ref)
    eager, _ = _run_steps(mt, opt_name, kw, fused=False, **rkw)
    _close(got, eager)


def test_fused_parity_lr_scheduler_boundary():
    """At a scheduler boundary the step's first parameter still sees the
    old rate (the eager loop reads the scheduler before advancing
    ``num_update``); the compiled step's per-parameter rates reproduce
    that sequence."""
    def run(pkg, fused):
        config = cfg if pkg is mt else ref_cfg
        ctx = {"ctx": mt.cpu()} if pkg is mt else {}
        config.set("MXNET_TPU_FUSED_TRAINER", fused)
        try:
            params = _params(pkg, [(4, 3), (6,)], seed=11)
            sched = pkg.lr_scheduler.MultiFactorScheduler(step=[2, 4],
                                                          factor=0.5)
            trainer = pkg.gluon.Trainer(
                params, "sgd", {"learning_rate": 0.2, "momentum": 0.9,
                                "lr_scheduler": sched})
            rng = np.random.RandomState(7)
            for _ in range(6):
                for p in params:
                    p.grad()[:] = pkg.nd.array(
                        rng.randn(*p.shape).astype(np.float32), **ctx)
                trainer.step(batch_size=2)
            return [p.data().asnumpy() for p in params]
        finally:
            config.reset("MXNET_TPU_FUSED_TRAINER")

    d = _delta(profiler, ["trainer_step_compile"])
    got = run(mt, True)
    assert d("trainer_step_compile") == 1
    _close(got, run(mx, True))
    _close(got, run(mt, False))


def test_fused_parity_lr_wd_mult():
    kw = {"momentum": 0.9, "wd": 0.01}
    got, _ = _run_steps(mt, "sgd", kw, fused=True, mults=True)
    _close(got, _run_steps(mx, "sgd", kw, fused=True, mults=True)[0])
    _close(got, _run_steps(mt, "sgd", kw, fused=False, mults=True)[0])


def test_fused_parity_multi_precision_sgd():
    def run(pkg, fused):
        config = cfg if pkg is mt else ref_cfg
        ctx = {"ctx": mt.cpu()} if pkg is mt else {}
        config.set("MXNET_TPU_FUSED_TRAINER", fused)
        try:
            rng = np.random.RandomState(0)
            p = pkg.gluon.Parameter("w_weight", shape=(8, 4),
                                    dtype=np.float16)
            p.initialize(**ctx)
            p.set_data(pkg.nd.array(rng.randn(8, 4).astype(np.float16),
                                    dtype=np.float16, **ctx))
            trainer = pkg.gluon.Trainer(
                [p], "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "multi_precision": True})
            for _ in range(3):
                p.grad()[:] = pkg.nd.array(
                    rng.randn(8, 4).astype(np.float16), dtype=np.float16,
                    **ctx)
                trainer.step(2)
            return p.data().asnumpy()
        finally:
            config.reset("MXNET_TPU_FUSED_TRAINER")

    d = _delta(profiler, ["trainer_step_compile"])
    got = run(mt, True)
    assert d("trainer_step_compile") == 1
    for want in (run(mx, True), run(mt, False)):
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   rtol=1e-3, atol=1e-3)


def test_fused_keeps_f16_dtype_without_multi_precision():
    """The float64 hyperparameter vector must not promote an f16 weight
    or state, and must not recompile per step."""
    cfg.set("MXNET_TPU_FUSED_TRAINER", True)
    try:
        p = mt.gluon.Parameter("w_weight", shape=(4, 4), dtype=np.float16)
        p.initialize(ctx=mt.cpu())
        trainer = mt.gluon.Trainer([p], "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        d = _delta(profiler, ["trainer_step_compile"])
        for _ in range(3):
            p.grad()[:] = mt.nd.array(np.ones((4, 4), np.float16),
                                      dtype=np.float16, ctx=mt.cpu())
            trainer.step(2)
        assert p.data().dtype == np.float16
        assert trainer._updaters.states[0].dtype == np.float16
        assert d("trainer_step_compile") == 1
    finally:
        cfg.reset("MXNET_TPU_FUSED_TRAINER")


def test_fused_matches_update_counts_and_states():
    _, tr_f = _run_steps(mt, "adam", {}, fused=True)
    _, tr_e = _run_steps(mt, "adam", {}, fused=False)
    _, tr_r = _run_steps(mx, "adam", {}, fused=True)
    assert tr_f._optimizer.num_update == tr_e._optimizer.num_update \
        == tr_r._optimizer.num_update == 3
    assert tr_f._optimizer._index_update_count == \
        tr_e._optimizer._index_update_count == \
        tr_r._optimizer._index_update_count
    sf, se, sr = (tr_f._updaters.states, tr_e._updaters.states,
                  tr_r._updaters.states)
    assert set(sf) == set(se) == set(sr)
    for k in sf:
        for a, b, c in zip(sf[k], se[k], sr[k]):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(a.asnumpy(), c.asnumpy(), rtol=RTOL,
                                       atol=ATOL)


def test_sgld_falls_back_to_eager():
    d = _delta(profiler, ["trainer_step_compile",
                          "trainer_step_fallback_opt_out"])
    got, _ = _run_steps(mt, "sgld", {}, fused=True)
    assert d("trainer_step_compile") == 0
    assert d("trainer_step_fallback_opt_out") == 3
    assert all(np.isfinite(g).all() for g in got)


# ------------------------------------------------------------ counters

def test_one_executable_per_step_after_warmup():
    params = _params(mt, [(8, 8), (8,)], seed=3)
    trainer = mt.gluon.Trainer(params, "adam", {"learning_rate": 0.01})
    for p in params:
        p.grad()[:] = mt.nd.array(
            np.random.RandomState(5).randn(*p.shape).astype(np.float32),
            ctx=mt.cpu())
    trainer.step(2)   # warm-up: the one compile
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_cache_hit",
                          "loop_recompile", "trainer_step_recompile"])
    for _ in range(5):
        trainer.step(2)
    assert d("trainer_step_compile") == 0
    assert d("trainer_step_cache_hit") == 5
    assert d("loop_recompile") == d("trainer_step_recompile") == 0


def test_lr_schedule_change_does_not_recompile():
    params = _params(mt, [(6, 4)], seed=4)
    trainer = mt.gluon.Trainer(params, "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "clip_gradient": 1.0, "wd": 0.001})
    params[0].grad()[:] = mt.nd.array(np.ones((6, 4), np.float32),
                                      ctx=mt.cpu())
    trainer.step(2)
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_cache_hit",
                          "trainer_step_recompile", "loop_recompile"])
    # every per-step dynamic hyper: lr, wd, clip value, rescale (batch)
    for lr in (0.05, 0.01, 0.002):
        trainer.set_learning_rate(lr)
        trainer.step(2)
    trainer._optimizer.wd = 0.01
    trainer._optimizer.clip_gradient = 0.5
    trainer.step(2)
    trainer.step(batch_size=7)
    assert d("trainer_step_compile") == 0
    assert d("trainer_step_cache_hit") == 5
    assert d("trainer_step_recompile") == d("loop_recompile") == 0
    # structural changes do recompile: clip presence flips the program,
    # and it is this updater's second build
    trainer._optimizer.clip_gradient = None
    trainer.step(2)
    assert d("trainer_step_compile") == 1
    assert d("loop_recompile") == 1


def test_dynamic_hypers_take_their_new_values():
    """The values that do not recompile still reach the program: the
    compiled steps after each change equal the eager ones."""
    def run(fused):
        cfg.set("MXNET_TPU_FUSED_TRAINER", fused)
        try:
            params = _params(mt, [(6, 4), (5,)], seed=4)
            trainer = mt.gluon.Trainer(
                params, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                "clip_gradient": 1.0, "wd": 0.001})
            rng = np.random.RandomState(2)
            for step in range(6):
                for p in params:
                    p.grad()[:] = mt.nd.array(
                        3 * rng.randn(*p.shape).astype(np.float32),
                        ctx=mt.cpu())
                if step == 2:
                    trainer.set_learning_rate(0.02)
                if step == 3:
                    trainer._optimizer.wd = 0.05
                    trainer._optimizer.clip_gradient = 0.3
                trainer.step(batch_size=2 + step)
            return [p.data().asnumpy() for p in params]
        finally:
            cfg.reset("MXNET_TPU_FUSED_TRAINER")

    _close(run(True), run(False))


def test_shape_change_recompiles():
    d = _delta(profiler, ["trainer_step_compile"])
    _run_steps(mt, "sgd", {}, fused=True, steps=1, with_null=False,
               shapes=((5, 5),))
    _run_steps(mt, "sgd", {}, fused=True, steps=1, with_null=False,
               shapes=((6, 5),))
    assert d("trainer_step_compile") == 2


def test_trainer_save_load_states_roundtrip_with_fused(tmp_path):
    _, trainer = _run_steps(mt, "adam", {}, fused=True)
    fname = str(tmp_path / "opt.states")
    trainer.save_states(fname)
    _, trainer2 = _run_steps(mt, "adam", {}, fused=True, steps=1)
    trainer2.load_states(fname)
    s1, s2 = trainer._updaters.states, trainer2._updaters.states
    assert set(s1) == set(s2)
    for k in s1:
        for a, b in zip(s1[k], s2[k]):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    # training continues after a load, on the compiled program
    d = _delta(profiler, ["trainer_step_cache_hit",
                          "trainer_step_fallback"])
    for p in trainer2._params:
        p.grad()[:] = mt.nd.array(np.ones(p.shape, np.float32),
                                  ctx=mt.cpu())
    trainer2.step(batch_size=2)
    assert d("trainer_step_cache_hit") == 1
    assert d("trainer_step_fallback") == 0


def test_states_written_by_the_reference_train_on():
    """A ``.states`` file of the reference's fused Trainer, loaded into
    the port's, continues on the compiled program as the reference's
    own trainer continues."""
    import tempfile
    _, ref_tr = _run_steps(mx, "adam", {}, fused=True)
    _, port_tr = _run_steps(mt, "adam", {}, fused=True)
    with tempfile.TemporaryDirectory() as tmp:
        fname = tmp + "/ref.states"
        ref_tr.save_states(fname)
        port_tr.load_states(fname)
    for tr, pkg in ((ref_tr, mx), (port_tr, mt)):
        ctx = {"ctx": mt.cpu()} if pkg is mt else {}
        for p in tr._params:
            p.grad()[:] = pkg.nd.array(np.full(p.shape, 0.5, np.float32),
                                       **ctx)
        tr.step(batch_size=2)
    _close([p.data().asnumpy() for p in port_tr._params],
           [p.data().asnumpy() for p in ref_tr._params])


# ------------------------------------------------- custom optimizers

def _plain_sgd_class(pkg_opt):
    class MyPlainSGD(pkg_opt.Optimizer):
        def create_state(self, index, weight):
            return None

        def update(self, index, weight, grad, state):
            lr = self._get_lr(index)
            self._update_count(index)
            weight -= lr * grad * self.rescale_grad

    return MyPlainSGD


def _warmup_sgd_class(pkg_opt):
    class WarmupSGD(pkg_opt.Optimizer):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.t = 0

        def create_state(self, index, weight):
            return None

        def update(self, index, weight, grad, state):
            self.t += 1
            lr = self._get_lr(index) * min(1.0, self.t / 3.0)
            self._update_count(index)
            weight -= lr * grad * self.rescale_grad

    return WarmupSGD


def test_custom_optimizer_uses_generic_fused_path():
    opt.register(_plain_sgd_class(opt))
    ref_opt.register(_plain_sgd_class(ref_opt))
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_fallback"])
    got, tr = _run_steps(mt, "myplainsgd", {}, fused=True)
    assert d("trainer_step_compile") == 1
    assert d("trainer_step_fallback") == 0
    # the replay's attributes were put back, the counts advanced
    o = tr._optimizer
    assert o.rescale_grad == 0.5 and o.wd == 0.0
    assert o._fixed_lr is None and o._fixed_t is None
    assert o._index_update_count == {0: 3, 1: 3, 2: 3} and o.num_update == 3
    _close(got, _run_steps(mt, "myplainsgd", {}, fused=False)[0])
    _close(got, _run_steps(mx, "myplainsgd", {}, fused=True)[0])


def test_stateful_custom_optimizer_falls_back_to_eager():
    """A custom optimizer keeping per-step state on the instance (a
    warm-up counter) cannot be replayed by a program: the compiled
    update detects it once, pins it to the eager path and builds
    nothing."""
    opt.register(_warmup_sgd_class(opt))
    ref_opt.register(_warmup_sgd_class(ref_opt))
    d = _delta(profiler, ["trainer_step_compile",
                          "trainer_step_compile_failed",
                          "trainer_step_fallback_opt_out"])
    got, tr = _run_steps(mt, "warmupsgd", {}, fused=True, steps=5)
    assert d("trainer_step_compile") == 0
    assert d("trainer_step_compile_failed") == 1
    assert d("trainer_step_fallback_opt_out") == 4
    assert tr._optimizer.fused_supported is False
    want, _ = _run_steps(mt, "warmupsgd", {}, fused=False, steps=5)
    _close(got, want, rtol=1e-5, atol=1e-7)
    _close(got, _run_steps(mx, "warmupsgd", {}, fused=True, steps=5)[0],
           rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------- Module

def _module(pkg, seed=0):
    ctx = mt.cpu() if pkg is mt else mx.cpu(0)
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.SoftmaxOutput(net, name="softmax")
    mod = pkg.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))])
    rng = np.random.RandomState(seed)
    args = {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.3,
            "fc1_bias": rng.randn(8).astype(np.float32) * 0.1}
    mod.set_params({k: pkg.nd.array(v, **({"ctx": ctx} if pkg is mt
                                          else {}))
                    for k, v in args.items()}, {})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    return mod


def test_module_update_uses_fused_step():
    rng = np.random.RandomState(1)
    x = rng.rand(4, 6).astype(np.float32)
    y = np.array([0, 3, 5, 7], np.float32)
    outs = []
    for pkg in (mt, mx):
        mod = _module(pkg)
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        batch = pkg.io.DataBatch(data=[pkg.nd.array(x, **kw)],
                                 label=[pkg.nd.array(y, **kw)])
        d = _delta(profiler if pkg is mt else ref_profiler,
                   ["trainer_step_compile", "trainer_step_cache_hit"])
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        assert d("trainer_step_compile") == 1
        assert d("trainer_step_cache_hit") == 2
        outs.append({k: v.asnumpy()
                     for k, v in mod.get_params()[0].items()})
    for k in outs[0]:
        np.testing.assert_allclose(outs[0][k], outs[1][k], rtol=RTOL,
                                   atol=ATOL)


def test_fit_step_and_update_share_one_program():
    """``_fit_step``'s update runs the same compiled program as
    ``update()``, with the step's count and rate; a borrowed optimizer
    shares the updater and its cache."""
    rng = np.random.RandomState(1)
    x = rng.rand(4, 6).astype(np.float32)
    y = np.array([0, 3, 5, 7], np.float32)
    mod = _module(mt)
    batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                            label=[mt.nd.array(y, ctx=mt.cpu())])
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_cache_hit",
                          "loop_recompile"])
    for _ in range(3):
        mod._fit_step(batch)
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert d("trainer_step_compile") == 1
    assert d("trainer_step_cache_hit") == 3
    assert d("loop_recompile") == 0
    other = mt.mod.Module(mod.symbol, context=mt.cpu())
    other.bind(data_shapes=[("data", (4, 6))],
               label_shapes=[("softmax_label", (4,))],
               shared_module=mod)
    other.borrow_optimizer(mod)
    assert other._fused_updater is mod._fused_updater


def test_fit_step_compiled_equals_eager():
    rng = np.random.RandomState(2)
    x = rng.rand(4, 6).astype(np.float32)
    y = np.array([1, 2, 3, 4], np.float32)

    def run(fused):
        cfg.set("MXNET_TPU_FUSED_TRAINER", fused)
        try:
            mod = _module(mt, seed=3)
            batch = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                                    label=[mt.nd.array(y, ctx=mt.cpu())])
            for _ in range(4):
                mod._fit_step(batch)
            return [v.asnumpy() for v in mod.get_params()[0].values()]
        finally:
            cfg.reset("MXNET_TPU_FUSED_TRAINER")

    _close(run(True), run(False))


# ------------------------------------------------------ the port's own

def test_knob_is_the_references():
    assert "MXNET_TPU_FUSED_TRAINER" in cfg.KNOBS
    assert cfg.get("MXNET_TPU_FUSED_TRAINER") is True
    assert ref_cfg.get("MXNET_TPU_FUSED_TRAINER") is True
    parse, ref_parse = (cfg.KNOBS["MXNET_TPU_FUSED_TRAINER"].typ,
                        ref_cfg.KNOBS["MXNET_TPU_FUSED_TRAINER"].typ)
    for v in ("0", "1", "true", "off", "yes", "", True, False):
        assert parse(v) == ref_parse(v), v


@pytest.mark.parametrize("opt_name,opt_kwargs",
                         [("sgd", {"momentum": 0.9, "wd": 1e-3}),
                          ("adam", {"clip_gradient": 0.1}),
                          ("sgld", {})], ids=lambda v: str(v))
def test_knob_off_is_the_eager_grouped_update_bit_for_bit(opt_name,
                                                          opt_kwargs):
    got, _ = _run_steps(mt, opt_name, opt_kwargs, fused=False)
    # the same steps through Updater.update_multi by hand
    mt.random.seed(0)
    params = _params(mt, ((4, 5), (7,), (2, 3, 2)), with_null=True)
    live = [i for i, p in enumerate(params) if p.grad_req != "null"]
    o = opt.create(opt_name, learning_rate=0.1, **opt_kwargs)
    o.idx2name = {i: params[i].name for i in live}
    o.lr_mult = {params[i].name: 1.0 for i in live}
    o.wd_mult = {params[i].name: 1.0 for i in live}
    o.rescale_grad = 0.5
    upd = opt.get_updater(o)
    rng = np.random.RandomState(99)
    for _ in range(3):
        grads = [torch.from_numpy(
            rng.randn(*params[i].shape).astype(np.float32)) for i in live]
        upd.update_multi(live, [params[i].data() for i in live], grads)
    want = [p.data().asnumpy() for p in params]
    if opt_name == "sgld":
        # fresh noise each run: the deterministic part is the frozen one
        got, want = got[-1:], want[-1:]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_identity_and_versions_are_kept():
    params = _params(mt, [(4, 3), (5,)], seed=2)
    trainer = mt.gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    for p in params:
        p.grad()[:] = mt.nd.array(np.ones(p.shape, np.float32), ctx=mt.cpu())
    trainer.step(2)
    arrays = [p.data() for p in params]
    tensors = [a.data for a in arrays]
    states = {k: list(v) for k, v in trainer._updaters.states.items()}
    leaves = {k: [s.data for s in v] for k, v in states.items()}
    before = [t._version for t in tensors]
    s_before = {k: [t._version for t in v] for k, v in leaves.items()}
    d = _delta(profiler, ["trainer_step_cache_hit"])
    trainer.step(2)
    assert d("trainer_step_cache_hit") == 1
    for p, a, t, v in zip(params, arrays, tensors, before):
        assert p.data() is a and a.data is t
        assert t._version > v
    for k, v in states.items():
        now = trainer._updaters.states[k]
        assert all(x is y for x, y in zip(now, v))
        assert all(x.data is t for x, t in zip(now, leaves[k]))
        assert all(t._version > b for t, b in zip(leaves[k], s_before[k]))


def test_state_aliased_to_its_weight_is_copied_first():
    """A state bound to its weight's tensor (as after ``set_states`` or
    an eager update that binds them) is given its own copy before the
    compiled in-place update, which then equals the eager one."""
    def run(fused):
        cfg.set("MXNET_TPU_FUSED_TRAINER", fused)
        try:
            params = _params(mt, [(4, 3)], seed=5)
            trainer = mt.gluon.Trainer(params, "sgd",
                                       {"learning_rate": 0.1,
                                        "momentum": 0.9})
            w = params[0].data()
            trainer._updaters.states[0] = mt.nd.NDArray(w.data)
            params[0].grad()[:] = mt.nd.array(np.ones((4, 3), np.float32),
                                              ctx=mt.cpu())
            trainer.step(2)
            return [w.asnumpy(), trainer._updaters.states[0].asnumpy()]
        finally:
            cfg.reset("MXNET_TPU_FUSED_TRAINER")

    d = _delta(profiler, ["trainer_step_dealias_copy"])
    got = run(True)
    assert d("trainer_step_dealias_copy") == 1
    want = run(False)
    # eagerly the momentum IS the weight; compiled it starts as a copy,
    # so the weight steps from its old value once: both are finite and
    # the compiled weight equals w + mom_new computed from the copy
    w0 = _params(mt, [(4, 3)], seed=5)[0].data().asnumpy()
    mom = 0.9 * w0 - 0.1 * 0.5
    np.testing.assert_allclose(got[1], mom, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], w0 + mom, rtol=RTOL, atol=ATOL)
    assert all(np.isfinite(x).all() for x in want)


def test_step_inside_record_leaves_nothing_on_the_tape():
    params = _params(mt, [(3, 2)], seed=6)
    trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    params[0].grad()[:] = mt.nd.array(np.ones((3, 2), np.float32),
                                      ctx=mt.cpu())
    d = _delta(profiler, ["trainer_step_compile"])
    with autograd.record():
        trainer.step(2)
        assert autograd.is_recording()
    assert d("trainer_step_compile") == 1
    w = params[0].data()
    assert w.data.grad_fn is None
    assert not getattr(w, "_in_graph", False)


def test_a_dynamo_recompile_is_counted():
    """A guard the signature does not see (here a gradient's strides)
    makes dynamo build the program again: counted as
    ``trainer_step_recompile`` and ``loop_recompile``, the result the
    eager update's."""
    def run(fused):
        cfg.set("MXNET_TPU_FUSED_TRAINER", fused)
        try:
            params = _params(mt, [(4, 4)], seed=7)
            trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
            g = np.random.RandomState(3).randn(4, 4).astype(np.float32)
            p = params[0]
            p.grad()[:] = mt.nd.array(g, ctx=mt.cpu())
            trainer.step(2)
            # the same values, another memory layout
            p.grad()._data = torch.from_numpy(g.T.copy()).t()
            trainer.step(2)
            return [p.data().asnumpy()]
        finally:
            cfg.reset("MXNET_TPU_FUSED_TRAINER")

    d = _delta(profiler, ["trainer_step_compile", "trainer_step_recompile",
                          "loop_recompile", "trainer_step_fallback"])
    got = run(True)
    assert d("trainer_step_compile") == 1
    assert d("trainer_step_recompile") == 1
    assert d("loop_recompile") == 1
    assert d("trainer_step_fallback") == 0
    _close(got, run(False))


def test_the_recompile_limit_fails_over_loudly():
    """Past dynamo's recompile limit a frame would run eagerly without a
    word; the compiled update makes that an error, and the step runs the
    eager grouped update, counted."""
    import torch._dynamo.config as dcfg
    with dcfg.patch(recompile_limit=1):
        params = _params(mt, [(4, 4)], seed=7)
        trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        g = np.random.RandomState(3).randn(4, 4).astype(np.float32)
        p = params[0]
        p.grad()[:] = mt.nd.array(g, ctx=mt.cpu())
        trainer.step(2)
        w1 = p.data().asnumpy()
        p.grad()._data = torch.from_numpy(g.T.copy()).t()
        d = _delta(profiler, ["trainer_step_fallback_failed",
                              "trainer_step_compile_failed",
                              "trainer_step_recompile"])
        trainer.step(2)
        assert d("trainer_step_fallback_failed") == 1
        assert d("trainer_step_compile_failed") == 1
        assert d("trainer_step_recompile") == 0
    np.testing.assert_allclose(p.data().asnumpy(), w1 - 0.1 * 0.5 * g,
                               rtol=RTOL, atol=ATOL)


def test_a_graph_break_fails_the_build_not_silently():
    """An update that cannot be captured whole (it branches on a value
    it reads back from the device) is a failed build, pinned
    permanently: the steps run the eager update and say so."""
    class HostReadSGD(opt.Optimizer):
        def create_state(self, index, weight):
            return None

        def update(self, index, weight, grad, state):
            lr = self._get_lr(index)
            self._update_count(index)
            if float(grad.data.abs().max()) > 1e9:
                return
            weight -= lr * grad * self.rescale_grad

    opt.register(HostReadSGD)
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_compile_failed",
                          "trainer_step_fallback_failed",
                          "trainer_step_neg_hit"])
    got, _ = _run_steps(mt, "hostreadsgd", {}, fused=True)
    assert d("trainer_step_compile") == 0
    assert d("trainer_step_compile_failed") == 1
    assert d("trainer_step_fallback_failed") == 1
    assert d("trainer_step_neg_hit") == 2
    _close(got, _run_steps(mt, "hostreadsgd", {}, fused=False)[0])


def test_a_swapped_updater_falls_back_counted():
    params = _params(mt, [(3,)], seed=8)
    trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    trainer._updaters = opt.get_updater(trainer._optimizer)
    params[0].grad()[:] = mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu())
    d = _delta(profiler, ["trainer_step_fallback_updater",
                          "trainer_step_compile"])
    trainer.step(1)
    assert d("trainer_step_fallback_updater") == 1
    assert d("trainer_step_compile") == 0
    w0 = _params(mt, [(3,)], seed=8)[0].data().asnumpy()
    np.testing.assert_allclose(params[0].data().asnumpy(), w0 - 0.1,
                               rtol=RTOL, atol=ATOL)


def test_compile_ring_and_report_carry_the_update():
    from mxnet_tpu_torch import obs
    from mxnet_tpu_torch.obs import compiles
    params = _params(mt, [(5, 2)], seed=9)
    trainer = mt.gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    params[0].grad()[:] = mt.nd.array(np.ones((5, 2), np.float32),
                                      ctx=mt.cpu())
    n0 = len([r for r in compiles.snapshot() if r["scope"] == "trainer_step"])
    trainer.step(2)
    trainer.step(2)
    recs = [r for r in compiles.snapshot() if r["scope"] == "trainer_step"]
    assert len(recs) == n0 + 1
    assert recs[-1]["source"] == _fused.CPU_BACKEND
    assert recs[-1]["compile_ms"] > 0
    rep = obs.report()
    assert any(r["scope"] == "trainer_step" for r in rep["compiles"])
    assert obs.probe_score()["loop_recompile"] == \
        profiler.get_counter("loop_recompile")
    from mxnet_tpu_torch.obs import prometheus
    samples = prometheus.parse_prometheus(prometheus.render_prometheus())
    for name in ("trainer_step_compile", "trainer_step_cache_hit"):
        assert prometheus.sample(samples, "mxnet_tpu_%s_total" % name) \
            == profiler.get_counter(name)


def test_the_probe_refuses_an_update_that_recompiles(monkeypatch):
    """A tuner probe whose fit recompiles its update (clipping switched
    on mid-run: a new program) scores not ok, naming loop_recompile."""
    from mxnet_tpu_torch.tune import probe
    from mxnet_tpu_torch.tune.space import Candidate
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=4, name="fc")
    net = mt.sym.LinearRegressionOutput(net, name="lro")
    spec = probe.make_spec(net.tojson(), [("data", (4, 3))],
                           [("lro_label", (4, 4))], {}, {}, "sgd",
                           {"learning_rate": 0.01}, Candidate(), steps=6,
                           device="cpu")
    real = mt.mod.Module._apply_update
    calls = []

    def flip_clip(self, names, grads, fit_step=False):
        calls.append(1)
        if len(calls) == 4:
            self._optimizer.clip_gradient = 1.0
        return real(self, names, grads, fit_step=fit_step)

    snap = cfg.snapshot_overrides(list(cfg.KNOBS))
    try:
        with profiler.counter_delta() as clean:
            probe.run_probe_child(dict(spec))
        assert clean.get("loop_recompile") == 0
        assert clean.get("trainer_step_compile") == 1
        monkeypatch.setattr(mt.mod.Module, "_apply_update", flip_clip)
        with profiler.counter_delta() as d:
            score = probe.run_probe_child(dict(spec))
    finally:
        cfg.restore_overrides(snap)
    assert d.get("loop_recompile") == 1
    assert score["ok"] is False
    assert "loop_recompile" in score["why"]


# ------------------------------------------------- the shared cache

def test_function_closure_no_collision():
    """Two same-shaped closure-backed Functions keep their own
    gradients (Scale(2.0) / Scale(3.0)), and a per-call Function op is
    never a cache identity."""
    class Scale(autograd.Function):
        def __init__(self, s):
            self.s = s

        def forward(self, x):
            return x * self.s

        def backward(self, dy):
            return dy * self.s

    x = mt.nd.array([1.0, 1.0], ctx=mt.cpu())
    x.attach_grad()
    for s in (2.0, 3.0):
        with autograd.record():
            y = Scale(s)(x)
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [s, s])

    class _Op(object):
        def __init__(self, name, fn):
            self.name, self.fn = name, fn

    from mxnet_tpu_torch.ops.registry import get_op
    relu = get_op("relu")
    assert _fused.op_identity(relu) == "relu"
    with pytest.raises(_fused.Uncacheable):
        _fused.op_identity(_Op("_Function_7", lambda x: x))
    f = lambda x: x          # noqa: E731
    assert _fused.op_identity(_Op("_cached_op_1", f)) == \
        ("_cached_op_1", _fused.fn_token(f))


def test_compile_cache_bounded_retry():
    c = _fused.CompileCache("unit_retry")
    sig = ("some", "structure")
    assert not c.should_skip(sig)
    c.mark_failed(sig)
    assert not c.should_skip(sig)
    c.mark_failed(sig)
    assert not c.should_skip(sig)
    c.mark_failed(sig)
    assert c.should_skip(sig)
    sig2 = ("other",)
    c.mark_failed(sig2)
    c.put(sig2, lambda: None)
    assert not c.should_skip(sig2)
    sig3 = ("structural",)
    c.mark_failed(sig3, permanent=True)
    assert c.should_skip(sig3)


def test_structural_failure_classification():
    import torch._dynamo.exc as dexc
    assert _fused.structural_failure(_fused.Uncacheable("x"))
    assert _fused.structural_failure(dexc.Unsupported("graph break"))
    assert not _fused.structural_failure(RuntimeError("RESOURCE_EXHAUSTED"))


def test_fn_token_stable_and_distinct():
    f = lambda x: x          # noqa: E731
    g = lambda x: x          # noqa: E731
    assert _fused.fn_token(f) == _fused.fn_token(f)
    assert _fused.fn_token(f) != _fused.fn_token(g)


def test_static_and_aval_keys():
    assert _fused.static_key([1, (2, "a")]) == (1, (2, "a"))
    with pytest.raises(_fused.Uncacheable):
        _fused.static_key({"a": 1})
    t = torch.zeros(2, 3, dtype=torch.float16)
    assert _fused.aval_key(t) == ((2, 3), torch.float16, t.device)
    assert _fused.aval_key(mt.nd.NDArray(t)) == _fused.aval_key(t)
    o = opt.SGD(momentum=0.9)
    o.extra = np.zeros(2)
    with pytest.raises(_fused.Uncacheable):
        o._fused_static_key()


# ------------------------------------- chip_smoke.py's phase 23 on the host

class _Event:
    """A CUDA event stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _counting(plain):
    def wrapper(*args):
        key = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
        wrapper.launches[key] += 1
        return plain(*args)
    wrapper.launches = {"f32": 0, "bf16": 0}
    return wrapper


@pytest.fixture
def small_phase23(monkeypatch):
    import chip_smoke
    from mxnet_tpu_torch.ops import flash_attention as fa

    def plain_dq(q, k, v, do, lse, delta, scale, causal):
        p = torch.exp(fa._scores(q, k, scale, causal) - lse[..., None])
        ds = p * (do.float() @ v.float().transpose(-1, -2)
                  - delta[..., None]) * scale
        return (ds @ k.float()).to(q.dtype)

    def plain_dkv(q, k, v, do, lse, delta, scale, causal):
        p = torch.exp(fa._scores(q, k, scale, causal) - lse[..., None])
        dof = do.float()
        ds = p * (dof @ v.float().transpose(-1, -2) - delta[..., None]) \
            * scale
        return ((ds.transpose(-1, -2) @ q.float()).to(k.dtype),
                (p.transpose(-1, -2) @ dof).to(v.dtype))

    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("LAYERS", 2),
                        ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
                        ("MAX_SEQ", 16), ("TRAIN_BATCH", 2),
                        ("CE_TOL", 1e-2), ("RESNET_LAYERS", 18),
                        ("RESNET_IMAGE", 32), ("RESNET_BATCH", 4),
                        ("RESNET_CLASSES", 10), ("FUSED_UPDATE_WINDOWS", 2),
                        ("FUSED_UPDATE_CALLS", 1), ("FUSED_STEP_WINDOWS", 2),
                        ("FUSED_STEP_CALLS", 1), ("CONV_CHECK_BATCH", 2),
                        ("CONV_CHECK_IMAGE", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    # the step programs are process-wide: each rehearsal starts with none,
    # as phase 23 on the card does (phases 1-22 run the eager step), and
    # builds its own over this fixture's stand-ins
    _fused.STEP_CACHE.clear()
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(plain_dkv))
    # no triton on the host: the facts are the card's to read; the
    # card's precision switches stay the card's
    monkeypatch.setattr(chip_smoke, "compiler_facts", lambda torch: {})
    monkeypatch.setattr(chip_smoke, "full_f32", lambda torch: None)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return chip_smoke, lines


def test_phase23_rehearsal_on_cpu(small_phase23):
    chip_smoke, lines = small_phase23
    out = chip_smoke.fused_update_phase(torch, np)
    lm = out["lm"]
    steps = chip_smoke.FUSED_WARM + chip_smoke.FUSED_TIMED
    assert all(n["bf16"] == steps * 2 for n in lm["launches"].values())
    assert lm["losses"][-1] < lm["losses"][0]
    assert lm["compile_s"] > 0 and lm["update_ms"] > 0
    assert lm["step_compile_s"] > 0 and lm["step_compiled_ms"] > 0
    assert lm["counters"]["fused_step_compile"] == 1
    assert lm["parity_grad_compiled"] <= 2 * lm["parity_grad_eager"]
    assert any(ln.startswith("23a parity") for ln in lines)
    assert any(ln.startswith("23a parity: step 1") for ln in lines)
    assert any(ln.startswith("23a step: compiled") for ln in lines)
    assert any(ln.startswith("23a step: the first compiled call")
               for ln in lines)
    assert len(lm["step_host_ms_calls"]) == 2 and \
        len(lm["step_first_host_ms"]) == 2 and lm["step_traced_top"]
    conv = out["conv"]
    assert conv["worst"] <= chip_smoke.CONV_CHECK_RTOL
    assert conv["n_conv"] > 0 and not conv["zeroed"]
    assert any(ln.startswith("23 conv: ResNet-18") for ln in lines)
    assert any(ln.startswith("23b: two steps at new learning rates")
               for ln in lines)


def test_phase23_warm_up_builds_the_phases_programs(small_phase23):
    """The resnet child's body builds 23b's SGD update, which phase 23
    then builds again from inductor's cache, and runs the Convolution
    check through one step program; the LM child's body builds 23a's
    two programs in its fit's first step and waits there for ``go``, or
    fails when the smoke's process ends first."""
    import io
    chip_smoke, _lines = small_phase23
    d = _delta(profiler, ["trainer_step_compile", "trainer_step_fallback",
                          "fused_step_compile", "fused_step_fallback"])
    try:
        res = chip_smoke.resnet_child(torch, np)
    finally:
        cfg.reset("MXNET_TPU_FUSED_TRAINER")
    assert len(res["builds_s"]) >= 2 and all(b > 0 for b in res["builds_s"])
    assert d("trainer_step_compile") == 1
    assert d("trainer_step_fallback") == 0
    assert d("fused_step_compile") == 1
    assert d("fused_step_fallback") == 0
    assert res["conv"]["worst"] <= chip_smoke.CONV_CHECK_RTOL

    at_gate = []

    class _Stdin:
        def __init__(self, text):
            self.text = text

        def readline(self):
            at_gate.append((d("fused_step_compile"),
                            d("trainer_step_compile")))
            return self.text

    import sys
    _fused.STEP_CACHE.clear()
    d = _delta(profiler, ["trainer_step_compile", "fused_step_compile"])
    try:
        sys_stdin, sys.stdin = sys.stdin, _Stdin("go\n")
        lm = chip_smoke.lm_child(torch, np)
        _fused.STEP_CACHE.clear()
        sys.stdin = io.StringIO("")
        with pytest.raises(chip_smoke.SmokeFailure, match="ended before"):
            chip_smoke.lm_child(torch, np)
    finally:
        sys.stdin = sys_stdin
        cfg.reset("MXNET_TPU_FUSED_TRAINER")
    assert at_gate[0] == (1, 1)
    assert lm["counters"]["fused_step_compile"] == 1
    assert lm["step1_s"] > 0


@pytest.mark.parametrize("fault,match", [
    (lambda g: torch.zeros_like(g), "compiled gradients zero"),
    (lambda g: g * 1.001, "the captured step's gradient")])
def test_phase23_conv_check_catches_wrong_gradients(small_phase23,
                                                   monkeypatch, fault, match):
    """A compiled step whose convolutions' gradients come back zero (what
    torch 2.11's capture made of LayerNorm's Function) or off by 0.1%
    fails phase 23's Convolution check."""
    chip_smoke, _lines = small_phase23
    real = mt.mod.Module._compiled_gradients

    def wrong(self):
        names, grads = real(self)
        if names is None:
            return names, grads
        return names, [fault(g) if "conv" in n else g
                       for n, g in zip(names, grads)]

    monkeypatch.setattr(mt.mod.Module, "_compiled_gradients", wrong)
    cfg.set("MXNET_TPU_FUSED_TRAINER", True)
    mt.amp.init("bfloat16")
    try:
        with pytest.raises(chip_smoke.SmokeFailure, match="23 conv: " + match):
            chip_smoke.conv_step_check(torch, np)
    finally:
        mt.amp.off()
        cfg.reset("MXNET_TPU_FUSED_TRAINER")


def test_phase23_catches_a_silent_eager_update(small_phase23, monkeypatch):
    """A fit whose update quietly takes the eager route fails 23a."""
    chip_smoke, _lines = small_phase23
    monkeypatch.setattr(_fused.FusedUpdater, "__call__",
                        lambda self, items, lr=None, t=None: False)
    with pytest.raises(chip_smoke.SmokeFailure, match="23a"):
        chip_smoke.fused_update_phase(torch, np)


def test_phase23_catches_a_drifting_compiled_update(small_phase23,
                                                    monkeypatch):
    """A compiled Adam that drops its bias correction (an update count
    far ahead) fails 23a's comparison with the eager route."""
    chip_smoke, _lines = small_phase23
    real = opt.Optimizer._fused_hypers

    def ahead(self, hv, n):
        lrs, wds, counts = real(self, hv, n)
        return lrs, wds, [c + 1000 for c in counts]

    monkeypatch.setattr(opt.Optimizer, "_fused_hypers", ahead)
    with pytest.raises(chip_smoke.SmokeFailure, match="23a: compiled update "
                       "outside"):
        chip_smoke.fused_update_phase(torch, np)


def test_the_roofline_count_takes_the_eager_update():
    """A compiled program's kernels bypass a dispatch mode: the
    analyzer's counting run takes the eager update, whose foreach ops it
    counts, and leaves the knob as it found it."""
    from mxnet_tpu_torch.analysis import roofline
    rng = np.random.RandomState(1)
    mod = _module(mt)
    batch = mt.io.DataBatch(
        data=[mt.nd.array(rng.rand(4, 6).astype(np.float32), ctx=mt.cpu())],
        label=[mt.nd.array(np.array([0, 1, 2, 3], np.float32),
                           ctx=mt.cpu())])
    mod._fit_step(batch)
    d = _delta(profiler, ["trainer_step_fallback_knob",
                          "trainer_step_cache_hit"])
    counted = roofline.count_executable(mod._fit_step, batch)
    assert d("trainer_step_fallback_knob") == 1
    assert d("trainer_step_cache_hit") == 0
    assert cfg.get("MXNET_TPU_FUSED_TRAINER") is True
    # the eager SGD-momentum update's passes over the 56 trained values
    # are in the count: at least w, g and mom read and written once
    assert counted["bytes"] >= 3 * 2 * 4 * 56
    mod._fit_step(batch)
    assert d("trainer_step_cache_hit") == 1
