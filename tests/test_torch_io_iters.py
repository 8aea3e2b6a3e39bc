"""The port's iterators of ``io/io.py`` against the reference's, batch by
batch: ``ResizeIter``, ``CSVIter``, ``MNISTIter`` and ``PrefetchingIter``
(the reset race, ``close()`` joining its workers, a worker's error
re-raised in ``next()``, the device stage on the CPU).

The oracles are the reference's ``tests/test_io.py`` and
``tests/test_async_fit.py:411-575``. Every thread a test starts ends by a
bounded ``close()``.
"""
import gzip
import struct
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _drain(it):
    out = []
    for b in it:
        out.append(([_np(d) for d in b.data],
                    [_np(lb) for lb in (b.label or [])], b.pad))
    return out


def _assert_same_stream(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, y)


def _pair(make):
    return make(mx), make(mt)


def test_batches_are_host_ndarrays():
    it = mt.io.NDArrayIter(np.zeros((8, 2), np.float32), np.arange(8),
                           batch_size=4)
    b = it.next()
    assert b.data[0].data.device.type == "cpu"
    assert b.label[0].data.device.type == "cpu"


@pytest.mark.parametrize("size", [3, 5, 11])
@pytest.mark.parametrize("reset_internal", [True, False])
def test_resize_iter_matches_reference(size, reset_internal):
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    ref, port = _pair(lambda pkg: pkg.io.ResizeIter(
        pkg.io.NDArrayIter(data, np.arange(20), batch_size=4), size,
        reset_internal=reset_internal))
    for _ in range(2):
        _assert_same_stream(_drain(ref), _drain(port))
        ref.reset()
        port.reset()
    assert port.provide_data == [mt.io.DataDesc("data", (4, 2))]


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("label_shape", [(1,), (2,)])
def test_csv_iter_matches_reference(tmp_path, round_batch, label_shape):
    rng = np.random.RandomState(0)
    data = rng.rand(10, 6).astype(np.float32)
    label = rng.rand(10, label_shape[0]).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    ref, port = _pair(lambda pkg: pkg.io.CSVIter(
        data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
        label_csv=str(tmp_path / "l.csv"), label_shape=label_shape,
        batch_size=4, round_batch=round_batch))
    a, b = _drain(ref), _drain(port)
    _assert_same_stream(a, b)
    assert len(b) == (3 if round_batch else 2)
    assert b[0][0][0].shape == (4, 2, 3)
    assert port.provide_label[0].name == "label"


def _write_idx(path, arr):
    dims = arr.shape
    magic = (0x08 << 8) | len(dims)
    header = struct.pack(">I", magic) + struct.pack(">" + "I" * len(dims),
                                                     *dims)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(str(path), "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("kw", [dict(), dict(flat=True),
                                dict(shuffle=False),
                                dict(input_shape=(1, 28 * 28)),
                                dict(seed=5, gz=True)])
def test_mnist_iter_matches_reference(tmp_path, kw):
    kw = dict(kw)
    ext = ".gz" if kw.pop("gz", False) else ""
    rng = np.random.RandomState(1)
    _write_idx(tmp_path / ("img" + ext),
               rng.randint(0, 256, (30, 28, 28)))
    _write_idx(tmp_path / ("lbl" + ext), rng.randint(0, 10, (30,)))
    ref, port = _pair(lambda pkg: pkg.io.MNISTIter(
        image=str(tmp_path / ("img" + ext)),
        label=str(tmp_path / ("lbl" + ext)), batch_size=8, **kw))
    a, b = _drain(ref), _drain(port)
    _assert_same_stream(a, b)
    assert len(b) == 3                     # discard: 30 // 8
    assert port.provide_data == [mt.io.DataDesc(
        "data", ref.provide_data[0].shape)]


# ------------------------------------------------------- PrefetchingIter

@pytest.mark.parametrize("n_iters", [1, 2])
def test_prefetching_iter_matches_reference(n_iters):
    data = np.arange(24, dtype=np.float32).reshape(12, 2)

    def make(pkg):
        iters = [pkg.io.NDArrayIter(data + i, np.arange(12) + i,
                                    batch_size=4) for i in range(n_iters)]
        rename = [{"data": "data%d" % i} for i in range(n_iters)] \
            if n_iters > 1 else None
        return pkg.io.PrefetchingIter(iters, rename_data=rename)

    ref, port = _pair(make)
    try:
        for _ in range(2):
            _assert_same_stream(_drain(ref), _drain(port))
            ref.reset()
            port.reset()
        assert [d.name for d in port.provide_data] == \
            [d.name for d in ref.provide_data]
    finally:
        assert port.close() and ref.close()


def test_prefetching_iter_close_joins_workers():
    base = mt.io.NDArrayIter(np.zeros((12, 2), np.float32), np.arange(12),
                             batch_size=4)
    before = threading.active_count()
    it = mt.io.PrefetchingIter(base)
    assert threading.active_count() > before
    it.next()
    assert it.close(join_timeout=5.0)
    assert not any(t.is_alive() for t in it._threads)
    assert it.close()              # idempotent
    with pytest.raises(MXNetError, match="after close"):
        it.next()


def test_prefetching_iter_reset_race():
    """A worker holding a pre-reset batch (blocked on a full queue) must
    not leak it into the next epoch: every post-reset epoch starts at
    batch 0 and yields exactly n batches."""
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    base = mt.io.NDArrayIter(data, np.arange(20), batch_size=4)
    it = mt.io.PrefetchingIter(base, prefetch_depth=1)
    try:
        for trial in range(6):
            for _ in range(trial % 4):
                it.next()
            time.sleep(0.01)
            it.reset()
            batches = _drain(it)
            assert len(batches) == 5, "epoch leaked/lost batches"
            np.testing.assert_array_equal(batches[0][0][0], data[:4])
            it.reset()
    finally:
        assert it.close(join_timeout=5.0)


def test_prefetching_iter_device_stage_runs_off_the_consumer():
    data = np.arange(24, dtype=np.float32).reshape(12, 2)
    placed_in = []

    def placer(batch):
        placed_in.append(threading.current_thread().name)
        batch._mx_placed = {"data": batch.data[0]}
        return batch

    it = mt.io.PrefetchingIter(
        mt.io.NDArrayIter(data, np.arange(12), batch_size=4),
        device_placer=placer, device_prefetch=2)
    try:
        batches = list(it)
        assert len(batches) == 3
        assert all(hasattr(b, "_mx_placed") for b in batches)
        main = threading.current_thread().name
        assert placed_in and all(n != main for n in placed_in)
    finally:
        assert it.close(join_timeout=5.0)

    def bad(batch):
        raise RuntimeError("H2D exploded")

    it2 = mt.io.PrefetchingIter(
        mt.io.NDArrayIter(data, np.arange(12), batch_size=4),
        device_placer=bad)
    try:
        with pytest.raises(RuntimeError, match="H2D exploded"):
            it2.next()
    finally:
        assert it2.close(join_timeout=5.0)


class _Exploding(mt.io.DataIter):
    def __init__(self):
        super().__init__(4)
        self._inner = mt.io.NDArrayIter(np.zeros((12, 2), np.float32),
                                        np.arange(12), batch_size=4)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label
        self._n = 0

    def next(self):
        self._n += 1
        if self._n > 1:
            raise IOError("corrupt record")
        return self._inner.next()

    def reset(self):
        self._n = 0
        self._inner.reset()


@pytest.mark.parametrize("placer", [None, lambda b: b])
def test_prefetching_iter_inner_error_reraises(placer):
    it = mt.io.PrefetchingIter(_Exploding(), device_placer=placer)
    try:
        it.next()
        with pytest.raises(IOError, match="corrupt record"):
            it.next()
    finally:
        assert it.close(join_timeout=5.0)


def test_module_placer_through_the_prefetcher_on_the_cpu():
    """The device stage with the module's own placer: on the CPU each
    batch's inputs are host copies of the bound dtype; loading a placed
    batch copies it into the bound inputs (no stale batch is read)."""
    data = mt.sym.Variable("data")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(data, num_hidden=3,
                                                     name="fc"),
                               name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 2))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    x = np.arange(24, dtype=np.float64).reshape(12, 2)
    it = mt.io.PrefetchingIter(mt.io.NDArrayIter(x, np.arange(12),
                                                 batch_size=4),
                               device_placer=mod._device_placer())
    try:
        batches = list(it)
    finally:
        assert it.close(join_timeout=5.0)
    bound = mod._exec.arg_dict["data"].data
    for k in (2, 0, 1):
        placed = batches[k]._mx_placed
        assert placed["data"].dtype == bound.dtype
        assert placed["data"].data_ptr() != bound.data_ptr()
        mod._load_batch(batches[k])
        np.testing.assert_array_equal(bound.numpy(), x[4 * k:4 * k + 4])
        np.testing.assert_array_equal(
            mod._exec.arg_dict["softmax_label"].data.numpy(),
            np.arange(4 * k, 4 * k + 4))
