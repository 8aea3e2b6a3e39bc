"""The port's one-process KVStore against the reference's.

* ``tests/test_kvstore_parallel.py``'s cases (init / pull, the sum of
  four pushed values, a custom updater, a list of keys, the optimizer's
  states) run in both packages with equal results; the errors, and
  ``create`` of every ``dist`` name raising (ROADMAP.md queue A9).
* Optimizer-state files and ``fit(checkpoint=...)`` directories written
  with a store load in the other package, both ways.
* ``Module.fit`` with a store object equals the port's fit without one
  bit for bit (both take the fused step, as the reference's module does
  with a store that is not ``dist``) and the reference's fit with one
  within 1e-5 of max(1, max|ref|); a hand-written ``update()`` loop
  through the store and a ``gluon.Trainer(kvstore=store)`` match the
  reference's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from test_torch_optimizer_states import (BATCH, NSAMP, _ctx, _data, _init,
                                         _mlp, _nd)

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

SHAPE = (4, 5)
RTOL = 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


# ------------------------------------------ test_kvstore_parallel's cases

def _init_pull(pkg, tmp):
    kv = pkg.kv.create("local")
    kv.init(3, pkg.nd.ones(SHAPE))
    out = pkg.nd.zeros(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _push_aggregation(pkg, tmp):
    kv = pkg.kv.create("local")
    kv.init(3, pkg.nd.zeros(SHAPE))
    rng = np.random.RandomState(1)
    kv.push(3, [pkg.nd.array(rng.randn(*SHAPE), ctx=pkg.cpu(i))
                for i in range(4)])
    out = pkg.nd.zeros(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _updater(pkg, tmp):
    kv = pkg.kv.create("local")
    kv.init("w", pkg.nd.ones(SHAPE))

    def updater(key, grad, weight):
        weight -= 0.1 * grad

    kv.set_updater(updater)
    kv.push("w", [pkg.nd.ones(SHAPE)] * 2)
    out = pkg.nd.zeros(SHAPE)
    kv.pull("w", out=out)
    return [out.asnumpy()]


def _list_keys(pkg, tmp):
    kv = pkg.kv.create("device")
    keys = [5, 7, 9]
    rng = np.random.RandomState(2)
    kv.init(keys, [pkg.nd.array(rng.randn(*SHAPE)) for _ in keys])
    kv.push(keys, [[pkg.nd.array(rng.randn(*SHAPE)) for _ in range(2)]
                   for _ in keys])
    outs = [pkg.nd.zeros(SHAPE) for _ in keys]
    kv.pull(keys, out=outs)
    return [o.asnumpy() for o in outs]


def _optimizer_states(pkg, tmp):
    kv = pkg.kv.create("local")
    kv.init(0, pkg.nd.ones((2,)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv.push(0, pkg.nd.ones((2,)))
    f = str(tmp / ("%s.states" % pkg.__name__))
    kv.save_optimizer_states(f)
    kv.load_optimizer_states(f)
    assert (kv.rank, kv.num_workers) == (0, 1)
    kv.push(0, pkg.nd.array([0.5, -2.0]))
    out = pkg.nd.zeros((2,))
    kv.pull(0, out=out)
    return [out.asnumpy(), kv._updater_obj.states[0].asnumpy()]


@pytest.mark.parametrize("case", [_init_pull, _push_aggregation, _updater,
                                  _list_keys, _optimizer_states],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_store_case_equals_the_reference(case, tmp_path):
    want, got = case(mx, tmp_path), case(mt, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_store_errors():
    for pkg in (mx, mt):
        kv = pkg.kv.create("local")
        kv.init(1, pkg.nd.ones(SHAPE))
        with pytest.raises(pkg.MXNetError, match="already initialized"):
            kv.init(1, pkg.nd.ones(SHAPE))
        with pytest.raises(pkg.MXNetError, match="not initialized"):
            kv.push(2, pkg.nd.ones(SHAPE))
        with pytest.raises(pkg.MXNetError, match="not initialized"):
            kv.pull(2, out=pkg.nd.zeros(SHAPE))
        with pytest.raises(pkg.MXNetError, match="Unknown KVStore"):
            pkg.kv.create("nccl")
        with pytest.raises(TypeError):
            pkg.kv.create(3)
    kv = mt.kv.create("device")
    assert (kv.type, kv.is_worker_node(), kv.is_server_node(),
            kv.get_num_dead_node(0)) == ("device", True, False, 0)
    with pytest.raises(MXNetError, match="optimizer"):
        kv.save_optimizer_states("unused")
    assert mt.kvstore is mt.kv and mt.kv.KVStore is mt.kvstore.KVStore


@pytest.mark.parametrize("name", ["dist_sync", "dist_async", "dist",
                                  "dist_device_sync", "dist_dev_sync"])
def test_create_dist_raises_naming_a9(name):
    """A departure from the reference, which raises only when no cluster
    is set up: the port's ``dist`` stores are ROADMAP.md queue A9."""
    with pytest.raises(MXNetError, match="kvstore.*A9"):
        mt.kv.create(name)
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    with pytest.raises(MXNetError, match="A9"):
        mt.gluon.Trainer(net.collect_params(), "sgd", kvstore=name)


@pytest.mark.parametrize("src,dst", [(mt, mx), (mx, mt)],
                         ids=["port-to-ref", "ref-to-port"])
def test_store_states_file_crosses(tmp_path, src, dst):
    rng = np.random.RandomState(4)
    w0, grads = rng.randn(*SHAPE), [rng.randn(*SHAPE) for _ in range(3)]
    stores = []
    for pkg in (src, dst):
        kv = pkg.kv.create("local")
        kv.init(0, pkg.nd.array(w0))
        kv.set_optimizer(pkg.optimizer.create("adam", learning_rate=0.01))
        stores.append(kv)
    for g in grads[:2]:
        stores[0].push(0, src.nd.array(g))
    fname = str(tmp_path / "kv.states")
    stores[0].save_optimizer_states(fname)
    stores[1].load_optimizer_states(fname)
    for g, w in zip(stores[1]._updater_obj.states[0],
                    stores[0]._updater_obj.states[0]):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    out = [src.nd.zeros(SHAPE), dst.nd.zeros(SHAPE)]
    stores[0].pull(0, out=out[0])
    stores[1]._store[0][:] = dst.nd.array(out[0].asnumpy())
    # the file holds no update counts: Adam's bias correction continues
    # from the count the reader is given
    stores[1]._updater_obj.optimizer._index_update_count[0] = 2
    for kv, pkg, o in zip(stores, (src, dst), out):
        kv.push(0, pkg.nd.array(grads[2]))
        kv.pull(0, out=o)
    _close(out[1].asnumpy(), out[0].asnumpy(), "the step after the file")


def test_create_kvstore_decides_as_the_reference():
    arrs = {"w": mt.nd.zeros((2, 2))}
    big = {"w": mt.nd.zeros((1, 1 << 24))}
    store = mt.kv.create("local")
    for args, want in (((None, 1, arrs), (None, False)),
                       (("local", 1, arrs), (None, False)),
                       (("device", 1, arrs), (None, False)),
                       ((store, 1, arrs), (store, True))):
        assert mt.model._create_kvstore(*args) == want
    kv, up = mt.model._create_kvstore("local", 2, arrs)
    assert kv.type == "local" and up is False
    kv, up = mt.model._create_kvstore("local", 2, big)
    assert up is True
    assert mt.model._create_kvstore("device", 2, arrs)[1] is True
    with pytest.raises(MXNetError, match="A9"):
        mt.model._create_kvstore("dist_sync", 1, arrs)
    with pytest.raises(TypeError):
        mt.model._create_kvstore(3, 1, arrs)
    assert mt.model.BatchEndParam is mt.callback.BatchEndParam


# ------------------------------------------------------------ Module

def _fit(pkg, epochs, kvstore, ckpt=None, resume=None):
    """One fit of the MLP with SGD (momentum, wd) from the reference's
    initial parameters, with ``kvstore``."""
    x, y = _data()
    pkg.random.seed(7)
    mod = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
    kw = {} if resume is not None else {
        "arg_params": {k: _nd(pkg, v) for k, v in _init().items()}}
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=epochs,
            optimizer="sgd", optimizer_params=dict(SGD), kvstore=kvstore,
            checkpoint=ckpt, resume_from=resume, **kw)
    return mod


def test_fit_with_a_store_equals_fit_without_and_the_reference():
    store = mt.kv.create("local")
    with_store = _fit(mt, 2, store)
    assert with_store._kvstore is store and with_store._update_on_kvstore
    assert sorted(store._store) == list(range(4))
    without = _fit(mt, 2, None)
    assert without._kvstore is None and not without._update_on_kvstore
    got, bare = _params(with_store), _params(without)
    for k in bare:
        np.testing.assert_array_equal(got[k], bare[k], err_msg=k)
    ref = _fit(mx, 2, mx.kv.create("local"))
    assert ref._update_on_kvstore
    want = _params(ref)
    for k in want:
        _close(got[k], want[k], k)
    # the fused step leaves the store's copies as init_optimizer made them
    np.testing.assert_array_equal(store._store[0].asnumpy(),
                                  _init()["fc1_weight"].astype(np.float32))


def test_fit_strings_keep_the_storeless_path():
    mods = [_fit(mt, 1, kv) for kv in ("local", "device", None)]
    assert all(m._kvstore is None for m in mods)
    for k, v in _params(mods[0]).items():
        for m in mods[1:]:
            np.testing.assert_array_equal(_params(m)[k], v, err_msg=k)
    with pytest.raises(MXNetError, match="kvstore.*A9"):
        _fit(mt, 1, "dist_sync")


def _bound(pkg, kvstore):
    mod = pkg.mod.Module(_mlp(pkg), context=_ctx(pkg))
    mod.bind(data_shapes=[("data", (BATCH, _data()[0].shape[1]))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.set_params({k: _nd(pkg, v) for k, v in _init().items()}, {})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=dict(SGD))
    return mod


def _update_steps(pkg, mod, steps):
    x, y = _data()
    for i in range(steps):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        mod.forward_backward(pkg.io.DataBatch([_nd(pkg, x[sl])],
                                              [_nd(pkg, y[sl])]))
        mod.update()
    return _params(mod)


def test_update_loop_through_the_store_matches_the_reference():
    store = mt.kv.create("local")
    port = _bound(mt, store)
    got = _update_steps(mt, port, 3)
    ref = _bound(mx, mx.kv.create("local"))
    want = _update_steps(mx, ref, 3)
    for k in want:
        _close(got[k], want[k], k)
    # the store ran the optimizer: its copies are the weights, its
    # updater counted three updates of each key, the module's none
    for idx, name in enumerate(port._param_names):
        np.testing.assert_array_equal(store._store[idx].asnumpy(), got[name])
        assert store._updater_obj.optimizer._index_update_count[idx] == 3
    assert not port._updater.states
    bare = _update_steps(mt, _bound(mt, None), 3)
    for k in bare:
        _close(got[k], bare[k], k)


def test_module_states_with_a_store_cross(tmp_path):
    """``save_optimizer_states`` writes the fused states even with a
    store (the reference's order), and an Updater's file goes to the
    store's optimizer when the module updates on a store."""
    ref = _bound(mx, mx.kv.create("local"))
    _update_steps(mx, ref, 2)
    fname = str(tmp_path / "kv.states")
    ref._kvstore.save_optimizer_states(fname)
    port = _bound(mt, mt.kv.create("local"))
    port.load_optimizer_states(fname)
    states = port._kvstore._updater_obj.states
    for idx in ref._kvstore._updater_obj.states:
        np.testing.assert_array_equal(
            states[idx].asnumpy(),
            ref._kvstore._updater_obj.states[idx].asnumpy())
    assert not port._updater.states
    port.save_optimizer_states(fname)
    fused = _bound(mx, mx.kv.create("local"))
    fused.load_optimizer_states(fname)
    assert fused._fused_num_update == 0


@pytest.mark.parametrize("src,dst", [(mt, mx), (mx, mt)],
                         ids=["port-to-ref", "ref-to-port"])
def test_fit_checkpoint_with_a_store_crosses(tmp_path, src, dst):
    ckpt = str(tmp_path)
    _fit(src, 2, src.kv.create("local"),
         ckpt=src.checkpoint.CheckpointConfig(ckpt, async_save=False))
    resumed = _fit(dst, 4, dst.kv.create("local"), resume=ckpt)
    want = _params(_fit(src, 4, src.kv.create("local")))
    got = _params(resumed)
    for k in want:
        _close(got[k], want[k], k)
    assert resumed._optimizer.num_update == 4 * NSAMP // BATCH


def test_kvstore_kind_restores_into_the_store(tmp_path):
    """The reference writes the ``"kvstore"`` kind for a module without
    a fused step (its ``dist`` stores); its local-store module made to
    write one restores into the port's store's optimizer."""
    ref = _bound(mx, mx.kv.create("local"))
    _update_steps(mx, ref, 2)
    ref._fused = None
    tensors, meta = ref._checkpoint_snapshot()
    assert meta["optimizer"]["kind"] == "kvstore"
    path = mx.checkpoint.write_checkpoint(str(tmp_path), 2, tensors, meta)
    ckpt = mt.checkpoint.manager.Checkpoint(
        path, *mt.checkpoint.read_checkpoint(path))
    port = _bound(mt, mt.kv.create("local"))
    port._checkpoint_restore(ckpt)
    upd = port._kvstore._updater_obj
    want = ref._kvstore._updater_obj
    assert upd.optimizer.num_update == want.optimizer.num_update
    for idx in want.states:
        np.testing.assert_array_equal(upd.states[idx].asnumpy(),
                                      want.states[idx].asnumpy())
        assert upd.optimizer._index_update_count[idx] == 2
    assert not port._updater.states


def test_borrow_optimizer_carries_the_store():
    store = mt.kv.create("local")
    a = _bound(mt, store)
    b = mt.mod.Module(_mlp(mt), context=mt.cpu())
    b.bind(data_shapes=[("data", (BATCH, _data()[0].shape[1]))],
           label_shapes=[("softmax_label", (BATCH,))], shared_module=a)
    b.borrow_optimizer(a)
    assert b._kvstore is store and b._update_on_kvstore


# ----------------------------------------------------------- Trainer

def _trainer_run(pkg, kvstore, steps=3, save=None, load=None):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    rng = np.random.RandomState(3)
    params = []
    for i, shp in enumerate([(5, 4), (5,)]):
        p = pkg.gluon.Parameter("kv%d_weight" % i, shape=shp)
        p.initialize(**ctx)
        p.set_data(pkg.nd.array(rng.randn(*shp), **ctx))
        params.append(p)
    tr = pkg.gluon.Trainer(params, "sgd", dict(SGD), kvstore=kvstore)
    if load is not None:
        tr.load_states(load)
    rng = np.random.RandomState(5)
    for _ in range(steps):
        for p in params:
            p.grad()[:] = pkg.nd.array(rng.randn(*p.shape), **ctx)
        tr.step(batch_size=4)
    if save is not None:
        tr.save_states(save)
    return tr, [p.data().asnumpy() for p in params]


def test_trainer_with_a_store_matches_the_reference(tmp_path):
    store = mt.kv.create("local")
    tr, got = _trainer_run(mt, store, save=str(tmp_path / "p.states"))
    assert tr._kvstore is store
    assert store._updater_obj.optimizer is tr._optimizer
    _, want = _trainer_run(mx, mx.kv.create("local"),
                           save=str(tmp_path / "r.states"))
    for g, w in zip(got, want):
        _close(g, w, "trainer step")
    _, bare = _trainer_run(mt, "device")
    for g, w in zip(got, bare):
        _close(g, w, "trainer step without a store")
    # each package's store states file loads in the other's store
    for pkg, other in ((mt, "r"), (mx, "p")):
        tr, _ = _trainer_run(pkg, pkg.kv.create("local"), steps=0,
                             load=str(tmp_path / ("%s.states" % other)))
        assert sorted(tr._kvstore._updater_obj.states) == [0, 1]


def test_trainer_strings_keep_no_store():
    for kv in ("device", "local", None):
        tr, _ = _trainer_run(mt, kv, steps=1)
        assert tr._kvstore is None and tr._kv_initialized
