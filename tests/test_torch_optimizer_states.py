"""Optimizer state and checkpoints crossing the two packages, and exact
resume within the port.

* ``.states`` files: ``Module.save_optimizer_states`` (the fused form
  by parameter name, with the update count) and ``Trainer.save_states``
  (``Updater.get_states``; the reference writes its tagged form, the
  port the untagged one) load in the other package, both directions;
  the states must equal the saved ones exactly and one more step must
  agree within 1e-5.
* ``fit(checkpoint=...)`` directories: the port's resumed by the
  reference's ``fit(resume_from=...)`` and the reverse, on an MLP with
  Adam and a ``FactorScheduler``; both continue to the uninterrupted
  run's weights within 1e-5 (the two packages' f32 steps differ in
  rounding only).
* Within the port, resume at an epoch boundary and mid-epoch is
  bit-identical to an uninterrupted run (the reference's
  ``test_checkpoint.py`` resume cases as oracles), and
  ``Module.save_checkpoint(save_optimizer_states=True)`` /
  ``Module.load(load_optimizer_states=True)`` carry the states.
"""
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

ATOL = 1e-5
BATCH, NSAMP, FEAT, NCLS = 8, 64, 16, 8
ADAM = {"learning_rate": 0.01, "wd": 1e-3, "clip_gradient": 1.0}


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=12, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=NCLS, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _data():
    rng = np.random.RandomState(0)
    return (rng.uniform(-1, 1, (NSAMP, FEAT)).astype(np.float32),
            rng.randint(0, NCLS, (NSAMP,)).astype(np.float32))


def _init():
    r = np.random.RandomState(42)
    return {"fc1_weight": r.uniform(-0.1, 0.1, (12, FEAT)),
            "fc1_bias": r.uniform(-0.1, 0.1, (12,)),
            "fc2_weight": r.uniform(-0.1, 0.1, (NCLS, 12)),
            "fc2_bias": r.uniform(-0.1, 0.1, (NCLS,))}


def _ctx(pkg):
    return mt.cpu() if pkg is mt else mx.cpu()


def _nd(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32),
                        **({"ctx": mt.cpu()} if pkg is mt else {}))


class _Stop(Exception):
    pass


def _fit(pkg, epochs, ckpt=None, resume=None, stop_after=None,
         optimizer_params=None):
    """One seeded fit of the MLP with Adam and a FactorScheduler; returns
    the module and its parameters as numpy."""
    x, y = _data()
    pkg.random.seed(7)
    sched = pkg.lr_scheduler.FactorScheduler(step=3, factor=0.7)
    params = dict(optimizer_params or ADAM, lr_scheduler=sched)
    mod = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
    kw = {}
    if resume is None:
        kw["arg_params"] = {k: _nd(pkg, v) for k, v in _init().items()}
    if stop_after is not None:
        calls = [0]

        def cb(_param):
            calls[0] += 1
            if calls[0] >= stop_after:
                raise _Stop()

        kw["batch_end_callback"] = cb
    try:
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=epochs,
                optimizer="adam", optimizer_params=params, checkpoint=ckpt,
                resume_from=resume, **kw)
    except _Stop:
        pass
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _close(got, want, atol=ATOL):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


def _equal(got, want):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------ Module .states

def _bound(pkg, steps):
    """A bound MLP module with Adam after ``steps`` ``_fit_step``s."""
    x, y = _data()
    mod = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
    mod.bind(data_shapes=[("data", (BATCH, FEAT))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.set_params({k: _nd(pkg, v) for k, v in _init().items()}, {})
    mod.init_optimizer(optimizer="adam", optimizer_params=dict(ADAM))
    for i in range(steps):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        mod._fit_step(pkg.io.DataBatch([_nd(pkg, x[sl])], [_nd(pkg, y[sl])]))
    return mod


def _states_by_name(mod):
    if isinstance(mod, mt.mod.Module):
        return {n: tuple(s.asnumpy() for s in st)
                for n, st in mod._named_states().items()}
    return {n: tuple(np.asarray(s) for s in st)
            for n, st in mod._fused_states.items()}


def _one_more_step(mod, pkg):
    x, y = _data()
    mod._fit_step(pkg.io.DataBatch([_nd(pkg, x[:BATCH])],
                                   [_nd(pkg, y[:BATCH])]))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("src,dst", [(mt, mx), (mx, mt)],
                         ids=["port-to-ref", "ref-to-port"])
def test_module_states_file_crosses(tmp_path, src, dst):
    fname = str(tmp_path / "m.states")
    a = _bound(src, 3)
    a.save_optimizer_states(fname)
    b = _bound(dst, 0)
    b.set_params({k: _nd(dst, v.asnumpy())
                  for k, v in a.get_params()[0].items()}, {})
    b.load_optimizer_states(fname)
    assert b._optimizer.num_update == a._optimizer.num_update == 3
    want, got = _states_by_name(a), _states_by_name(b)
    assert set(got) == set(want)
    for n in want:
        for g, w in zip(got[n], want[n]):
            np.testing.assert_array_equal(g, w, err_msg=n)
    _close(_one_more_step(b, dst), _one_more_step(a, src))


def test_updater_states_blob_crosses_module(tmp_path):
    """The reference's eager Updater blob (tagged) loads into the port's
    Module by parameter index."""
    o = mx.optimizer.create("adam")
    u = mx.optimizer.get_updater(o)
    names = _mlp(mx).list_arguments()
    params = [n for n in names if n not in ("data", "softmax_label")]
    shapes = {k: np.shape(v) for k, v in _init().items()}
    for i, n in enumerate(params):
        u(i, mx.nd.array(np.full(shapes[n], 0.5, np.float32)),
          mx.nd.array(np.zeros(shapes[n], np.float32)))
    mod = _bound(mt, 0)
    path = str(tmp_path / "upd.states")
    open(path, "wb").write(u.get_states())
    mod.load_optimizer_states(path)
    for i, n in enumerate(params):
        for g, w in zip(mod._named_states()[n], u.states[i]):
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


# ----------------------------------------------------- Trainer .states

def _gluon_trainer(pkg, opt_kw):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    rng = np.random.RandomState(3)
    params = []
    for i, shp in enumerate([(5, 4), (5,)]):
        p = pkg.gluon.Parameter("t%d_weight" % i, shape=shp)
        p.initialize(**ctx)
        p.set_data(pkg.nd.array(rng.randn(*shp), **ctx))
        params.append(p)
    return params, pkg.gluon.Trainer(params, "adam", dict(opt_kw))


def _trainer_steps(pkg, params, trainer, n, seed):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    rng = np.random.RandomState(seed)
    for _ in range(n):
        for p in params:
            p.grad()[:] = pkg.nd.array(rng.randn(*p.shape), **ctx)
        trainer.step(batch_size=4)
    return [p.data().asnumpy() for p in params]


@pytest.mark.parametrize("src,dst", [(mt, mx), (mx, mt)],
                         ids=["port-to-ref", "ref-to-port"])
def test_trainer_states_file_crosses(tmp_path, src, dst):
    """A fresh Trainer of the other package, given the weights, the
    states file and ``begin_num_update`` (the file holds no counts),
    continues as the saving Trainer does."""
    fname = str(tmp_path / "t.states")
    kw = {"learning_rate": 0.01, "beta1": 0.5}
    ps, tr = _gluon_trainer(src, kw)
    _trainer_steps(src, ps, tr, 3, seed=1)
    tr.save_states(fname)
    pd, td = _gluon_trainer(dst, dict(kw, begin_num_update=3))
    ctx = {"ctx": mt.cpu()} if dst is mt else {}
    for a, b in zip(ps, pd):
        b.set_data(dst.nd.array(a.data().asnumpy(), **ctx))
    td.load_states(fname)
    for i in range(2):
        for g, w in zip(td._updaters.states[i], tr._updaters.states[i]):
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    want = _trainer_steps(src, ps, tr, 2, seed=2)
    got = _trainer_steps(dst, pd, td, 2, seed=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_states_unpickler_refuses_other_classes():
    import pickle
    blob = pickle.dumps({0: logging.getLogger("x")})
    with pytest.raises(pickle.UnpicklingError, match="numpy"):
        mt.optimizer.get_updater(mt.optimizer.SGD()).set_states(blob)


# ------------------------------------------------ fit checkpoints across

@pytest.mark.parametrize("src,dst", [(mt, mx), (mx, mt)],
                         ids=["port-to-ref", "ref-to-port"])
def test_fit_checkpoint_resumes_in_the_other_package(tmp_path, src, dst):
    ckpt = str(tmp_path)
    _fit(src, 2, ckpt=src.checkpoint.CheckpointConfig(ckpt,
                                                      async_save=False))
    resumed, w_res = _fit(dst, 4, resume=ckpt)
    _, w_src = _fit(src, 4)
    _, w_dst = _fit(dst, 4)
    _close(w_res, w_src)
    _close(w_res, w_dst)
    assert resumed._optimizer.num_update == 4 * NSAMP // BATCH


# --------------------------------------------------- exact resume, port

def test_resume_epoch_boundary_is_bit_identical(tmp_path):
    _, w_ref = _fit(mt, 4)
    ckpt = mt.checkpoint.CheckpointConfig(str(tmp_path), period_epochs=1)
    _fit(mt, 2, ckpt=ckpt)
    assert mt.checkpoint.list_checkpoints(str(tmp_path))
    _, w_res = _fit(mt, 4, ckpt=ckpt, resume=str(tmp_path))
    _equal(w_res, w_ref)


def test_resume_mid_epoch_is_bit_identical(tmp_path):
    """Stopped in epoch 1 after a batch save: the resumed run skips the
    consumed batches, restores the metric totals, and ends on the
    uninterrupted run's parameters and optimizer states exactly."""
    ref_mod, w_ref = _fit(mt, 2)
    ckpt = mt.checkpoint.CheckpointConfig(str(tmp_path), every_n_batches=3,
                                          period_epochs=1)
    _fit(mt, 2, ckpt=ckpt, stop_after=12)
    latest = mt.checkpoint.restore_latest(str(tmp_path))
    assert latest.mid_epoch and latest.epoch == 1 and \
        latest.batches_done == 3
    assert latest.metric_state["kind"] == "scalar" and \
        latest.metric_state["num_inst"] == 3 * BATCH
    assert "rng:torch:cpu" in latest.tensors
    res_mod, w_res = _fit(mt, 2, ckpt=ckpt, resume=str(tmp_path))
    _equal(w_res, w_ref)
    want, got = _states_by_name(ref_mod), _states_by_name(res_mod)
    for n in want:
        for g, w in zip(got[n], want[n]):
            np.testing.assert_array_equal(g, w, err_msg=n)


def test_module_checkpoint_files_carry_optimizer_states(tmp_path):
    """``save_checkpoint(save_optimizer_states=True)``, the
    ``module_checkpoint`` callback and ``Module.load(...,
    load_optimizer_states=True)`` (each raised before this slice)."""
    prefix = str(tmp_path / "mlp")
    a = _bound(mt, 2)
    mt.callback.module_checkpoint(a, prefix, save_optimizer_states=True)(0)
    assert os.path.exists(prefix + "-0001.states")
    b = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                           context=mt.cpu())
    b.bind(data_shapes=[("data", (BATCH, FEAT))],
           label_shapes=[("softmax_label", (BATCH,))])
    b.init_optimizer(optimizer="adam", optimizer_params=dict(ADAM))
    assert b._optimizer.num_update == 2
    _equal(_one_more_step(b, mt), _one_more_step(a, mt))


def test_fit_checkpoint_needs_a_snapshot(tmp_path):
    class _NoSnapshot(mt.mod.BaseModule):
        pass

    x, y = _data()
    with pytest.raises(mt.MXNetError, match="_checkpoint_snapshot"):
        _NoSnapshot().fit(mt.io.NDArrayIter(x, y, batch_size=BATCH),
                          num_epoch=1, checkpoint=str(tmp_path))


def test_checkpoint_restore_refuses_a_foreign_optimizer_kind(tmp_path):
    mod = _bound(mt, 1)
    tensors, meta = mod._checkpoint_snapshot()
    meta["optimizer"]["kind"] = "kvstore"
    path = mt.checkpoint.write_checkpoint(str(tmp_path), 1, tensors, meta)
    ckpt = mt.checkpoint.manager.Checkpoint(
        path, *mt.checkpoint.read_checkpoint(path))
    with pytest.raises(mt.checkpoint.CheckpointError, match="A9"):
        mod._checkpoint_restore(ckpt)
