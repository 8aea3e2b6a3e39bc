"""The port's data plane (``mxnet_tpu_torch.data``) against the
reference's ``mxnet_tpu.data``.

The oracle is the reference's ``tests/test_data.py``: the partition is a
pure function of (seed, epoch, world) and covers the workers disjointly;
the delivered stream equals the reference's, whatever the worker count;
the cursor fast-forwards without decoding, and a cursor of another
stream names the mismatched field; a killed worker is respawned over its
range and the stream replays exactly; a decode fault drops one batch; a
loader that keeps up never stalls. Every worker process ends with the
loader's bounded ``close()`` (terminate, a 5 s join, then kill), and a
worker that is alive but stuck ends its test at the consumer's
``MXNET_TPU_DATA_TIMEOUT`` deadline, set here to 60 s.
"""
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu import data as ref_data
from mxnet_tpu_torch import faults, profiler, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import (DataLoader, PartitionPlan, RawTransform,
                                  StallTransform, epoch_order)
import torch

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

BATCH, FEAT, NCLS, NREC = 4, 6, 3, 48


@pytest.fixture()
def dataset(tmp_path):
    """Record i carries data [i, noise...] and label i % NCLS."""
    rec, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(NREC):
        payload = np.concatenate([[np.float32(i)],
                                  rng.uniform(-1, 1, FEAT - 1)])
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % NCLS),
                                                       i, 0),
                                     payload.astype(np.float32).tobytes()))
    w.close()
    return rec, idx


@pytest.fixture(autouse=True)
def _deadline():
    mt.config.set("MXNET_TPU_DATA_TIMEOUT", 60.0)
    yield
    mt.config.reset("MXNET_TPU_DATA_TIMEOUT")


def _loader(dataset, pkg=None, **kw):
    rec, idx = dataset
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("shuffle", True)
    kw.setdefault("seed", 11)
    kw.setdefault("part", (0, 1))
    if pkg is ref_data:
        kw.setdefault("transform", ref_data.RawTransform((FEAT,)))
        return ref_data.DataLoader(rec, idx_path=idx, **kw)
    kw.setdefault("transform", RawTransform((FEAT,)))
    return DataLoader(rec, idx_path=idx, **kw)


def _batches(dl, close=True):
    out = [(np.array(b.data[0]), np.array(b.label[0])) for b in dl]
    if close:
        dl.close()
    return out


def _ids(batches):
    return [d[:, 0].astype(int).tolist() for d, _ in batches]


def _same(a, b):
    assert len(a) == len(b)
    for (da, la), (db, lb) in zip(a, b):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)


# ------------------------------------------------------------ partition

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("workers,world", [(3, 1), (2, 2), (1, 3)])
def test_partition_matches_reference(shuffle, workers, world):
    for rank in range(world):
        args = (100, 8)
        kw = dict(seed=5, epoch=2, rank=rank, world_size=world,
                  num_workers=workers, shuffle=shuffle)
        plan, ref = PartitionPlan(*args, **kw), \
            ref_data.PartitionPlan(*args, **kw)
        assert plan.describe() == ref.describe()
        np.testing.assert_array_equal(plan.local_order, ref.local_order)
        for w in range(workers):
            assert plan.owned_ranges(w, 3) == ref.owned_ranges(w, 3)
        owned = sorted(k for w in range(workers)
                       for k in plan.owned_batches(w))
        assert owned == list(range(plan.num_batches))
    np.testing.assert_array_equal(epoch_order(10, 3, 1),
                                  ref_data.epoch_order(10, 3, 1))
    with pytest.raises(ValueError, match="outside world"):
        PartitionPlan(10, 2, seed=0, epoch=0, rank=2, world_size=2)


# ------------------------------------------------------- stream identity

@pytest.mark.parametrize("workers", [0, 1, 2, 4])
def test_stream_equals_reference_across_worker_counts(dataset, workers):
    want = _batches(_loader(dataset, ref_data, num_workers=2))
    got = _batches(_loader(dataset, num_workers=workers))
    _same(got, want)
    assert _ids(got) != [list(range(i, i + BATCH))
                         for i in range(0, NREC, BATCH)]


def test_epochs_are_deterministic_and_distinct(dataset):
    def epochs(workers):
        dl = _loader(dataset, num_workers=workers)
        e0 = _batches(dl, close=False)
        dl.reset()
        return e0, _batches(dl)

    (a0, a1), (b0, b1) = epochs(2), epochs(0)
    _same(a0, b0)
    _same(a1, b1)
    assert _ids(a0) != _ids(a1)
    assert sorted(i for b in _ids(a0) for i in b) == list(range(NREC))


def test_world_partition_and_auto(dataset):
    per_host = [_ids(_batches(_loader(dataset, num_workers=2,
                                      part=(r, 2)))) for r in range(2)]
    flat = sorted(i for s in per_host for b in s for i in b)
    assert flat == list(range(NREC))
    dl = _loader(dataset, num_workers=0, part="auto")
    assert (dl.rank, dl.world_size) == (0, 1)
    dl.close()
    with pytest.raises(MXNetError, match="A9"):
        _loader(dataset, num_workers=0, mesh=object())


def test_construction_errors_match_reference(dataset):
    rec, idx = dataset
    with pytest.raises(MXNetError, match="cannot fill"):
        DataLoader(rec, idx_path=idx, batch_size=NREC // 2,
                   transform=RawTransform((FEAT,)), part=(0, 4))
    with pytest.raises(ValueError, match="transform"):
        DataLoader(rec, idx_path=idx, batch_size=BATCH)
    dl = _loader(dataset, num_workers=0)
    with pytest.raises(MXNetError, match="after close"):
        dl.close()
        dl.next()


# ------------------------------------------------------------ the cursor

@pytest.mark.parametrize("workers", [0, 1, 4])
def test_fast_forward_matches_uninterrupted(dataset, workers):
    base = _batches(_loader(dataset, num_workers=2))
    dl = _loader(dataset, num_workers=workers)
    cur = dl._mx_cursor(epoch=0, batches_done=5)
    ref = _loader(dataset, ref_data, num_workers=0)
    assert cur == ref._mx_cursor(epoch=0, batches_done=5) | \
        {"num_workers": workers}
    ref.close()
    decoded = []
    real = dl.transform

    def counting(raw):
        decoded.append(1)
        return real(raw)

    dl.transform = counting
    dl._mx_fast_forward(0, 5, cursor=cur)
    got = _batches(dl)
    _same(got, base[5:])
    if workers == 0:       # inline decode: the skipped batches cost nothing
        assert len(decoded) == (len(base) - 5) * BATCH


@pytest.mark.parametrize("field,kw", [("seed", dict(seed=99)),
                                      ("batch_size",
                                       dict(batch_size=BATCH * 2)),
                                      ("shuffle", dict(shuffle=False))])
def test_cursor_mismatch_names_the_field(dataset, field, kw):
    dl = _loader(dataset, num_workers=0)
    cur = dl._mx_cursor(epoch=0, batches_done=3)
    dl.close()
    other = _loader(dataset, num_workers=0, **kw)
    with pytest.raises(MXNetError, match=field):
        other._mx_fast_forward(0, 3, cursor=cur)
    with pytest.raises(MXNetError, match="version"):
        other._mx_fast_forward(0, 3, cursor=dict(cur,
                                                 version=cur["version"] + 1))
    other.close()


# ---------------------------------------------------------------- faults

def test_worker_death_replays_exactly(dataset):
    base = _batches(_loader(dataset, num_workers=2))
    before = profiler.get_counter("data_worker_respawn")
    faults.install("data.worker@1:sigkill")
    try:
        survived = _batches(_loader(dataset, num_workers=2))
    finally:
        faults.clear()
    _same(survived, base)
    assert profiler.get_counter("data_worker_respawn") > before


@pytest.mark.parametrize("workers,nth", [(1, 3), (0, 2)])
def test_decode_fault_poisons_one_batch(dataset, workers, nth):
    base = _ids(_batches(_loader(dataset, num_workers=workers)))
    before = profiler.get_counter("data_batch_poisoned")
    faults.install("data.decode@%d:raise" % nth)
    try:
        poisoned = _ids(_batches(_loader(dataset, num_workers=workers)))
    finally:
        faults.clear()
    assert len(poisoned) == len(base) - 1
    assert profiler.get_counter("data_batch_poisoned") == before + 1
    assert [b for b in base if b in poisoned] == poisoned


def test_steady_state_has_zero_stalls(dataset):
    before = profiler.get_counter("data_stall")
    dl = _loader(dataset, num_workers=2, queue_depth=8)
    n = 0
    for _ in dl:
        n += 1
        time.sleep(0.01)
    dl.close()
    assert n == NREC // BATCH
    assert profiler.get_counter("data_stall") == before


def test_stall_transform_delays(dataset):
    dl = _loader(dataset, num_workers=0,
                 transform=StallTransform(RawTransform((FEAT,)), 0.002))
    t0 = time.perf_counter()
    next(dl)
    assert time.perf_counter() - t0 >= 0.002 * BATCH
    dl.close()


class _StuckInWorkers(object):
    """RawTransform that sleeps a minute a record in any process but the
    one that made it (the loader's constructor decodes record 0 inline
    to learn the shapes)."""

    def __init__(self):
        import os
        self.inner = RawTransform((FEAT,))
        self.pid = os.getpid()

    def __call__(self, raw):
        import os
        if os.getpid() != self.pid:
            time.sleep(60.0)
        return self.inner(raw)


def test_a_stuck_worker_ends_at_the_deadline(dataset):
    """A worker that stays alive and delivers nothing ends next() with
    MXNetError at MXNET_TPU_DATA_TIMEOUT, and the pool is reaped: the
    consumer never waits forever on a live process."""
    mt.config.set("MXNET_TPU_DATA_TIMEOUT", 0.5)
    dl = _loader(dataset, num_workers=1, transform=_StuckInWorkers())
    t0 = time.monotonic()
    with pytest.raises(MXNetError, match="alive but delivered no batch"):
        next(dl)
    assert time.monotonic() - t0 < 10.0
    assert dl._procs == []
    dl.close()


@pytest.mark.parametrize("bad", ["0", "-1"])
def test_deadline_knob_must_be_positive(bad):
    with pytest.raises(ValueError, match="MXNET_TPU_DATA_TIMEOUT"):
        mt.config.KNOBS["MXNET_TPU_DATA_TIMEOUT"].typ(bad)


# -------------------------------------------------------- ImageTransform

@pytest.fixture()
def images(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    rng = np.random.RandomState(2)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(16):
        im = (rng.rand(30 + i, 40, 3) * 255).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i % 4),
                                                           i, 0),
                                         cv2.GaussianBlur(im, (5, 5), 0),
                                         quality=95))
    w.close()
    return rec, idx


def _image_stream(images, pkg, workers):
    t = (ref_data if pkg == "ref" else mt.data).ImageTransform(
        (3, 24, 24), mean=100.0, scale=0.5)
    return _batches(_loader(images, ref_data if pkg == "ref" else None,
                            num_workers=workers, transform=t))


def test_image_transform_python_path_equals_reference(images):
    mt.config.set("MXNET_USE_NATIVE_IO", False)
    try:
        got = _image_stream(images, "port", 2)
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")
    _same(got, _image_stream(images, "ref", 0))


def test_image_transform_native_within_a_level_of_cv2(images):
    got = _image_stream(images, "port", 2)
    want = _image_stream(images, "ref", 2)
    assert len(got) == len(want)
    for (dg, lg), (dw, lw) in zip(got, want):
        np.testing.assert_array_equal(lg, lw)
        # libjpeg decodes as cv2 does; the bilinear resize is within one
        # level of cv2's (0.5 after the scale)
        assert np.abs(dg - dw).max() <= 0.5
    _same(_image_stream(images, "port", 4), got)


def test_image_transform_without_cv2_raises(images, monkeypatch):
    """MXNET_USE_NATIVE_IO=0 with no cv2 names the fix instead of
    swapping in another decoder."""
    rec, _ = images
    raw = recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
    try:
        buf = raw.read_idx(0)
    finally:
        raw.close()
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    mt.config.set("MXNET_USE_NATIVE_IO", False)
    try:
        with pytest.raises(MXNetError, match="cv2 does not import"):
            mt.data.ImageTransform((3, 24, 24))(buf)
    finally:
        mt.config.reset("MXNET_USE_NATIVE_IO")


_BIG_DEATH = r"""
import os, signal, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.data import DataLoader, RawTransform
rec, idx, feat, marker = sys.argv[2], sys.argv[3], int(sys.argv[4]), \
    sys.argv[5]
PARENT = os.getpid()


class KillOnce(object):
    # a worker (never the consumer, which decodes record 0 at
    # construction) reaching record ``at`` dies once, 0.3 s in: by then
    # its feeder thread is blocked half way through the previous batch,
    # which the consumer has not read yet
    def __init__(self, inner, at):
        self.inner, self.at = inner, at

    def __call__(self, raw):
        header, _ = recordio.unpack(raw)
        if header.id == self.at and os.getpid() != PARENT \
                and not os.path.exists(marker):
            open(marker, "w").close()
            time.sleep(0.3)
            os.kill(os.getpid(), signal.SIGKILL)
        return self.inner(raw)


def stream(transform, pause):
    dl = DataLoader(rec, idx_path=idx, batch_size=4, transform=transform,
                    shuffle=False, num_workers=2, part=(0, 1))
    out = []
    for b in dl:
        out.append(np.array(b.data[0][:, 0]))
        time.sleep(pause)
    dl.close()
    return out


base = stream(RawTransform((feat,)), 0.0)
# batch 3 (records 12-15) is worker 1's second: it dies there while batch
# 1's megabytes are still in its pipe
got = stream(KillOnce(RawTransform((feat,)), 12), 0.6)
assert os.path.exists(marker)
assert len(got) == len(base) and all((a == b).all()
                                     for a, b in zip(got, base))
print("REPLAYED", len(got))
"""


def test_worker_killed_while_writing_a_large_batch(tmp_path):
    """A batch of megabytes is still in the pipe when its worker is
    killed at the next batch's start: the consumer reads end of file
    (it holds no writer), respawns the worker and replays; a consumer
    holding the writer would wait for the rest of the message forever.
    Run in a subprocess under a deadline, so a regression fails instead
    of hanging the suite."""
    import os
    import subprocess
    import sys
    feat = 1 << 18                    # 1 MiB a record, 4 MiB a batch
    rec, idx = str(tmp_path / "big.rec"), str(tmp_path / "big.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(24):
        payload = np.full(feat, i, np.float32)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     payload.tobytes()))
    w.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _BIG_DEATH, root, rec, idx,
                           str(feat), str(tmp_path / "killed")],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REPLAYED 6" in proc.stdout


def test_close_is_prompt_under_a_parent_sigterm_handler(dataset):
    """fit(checkpoint=...) installs a SIGTERM handler that only sets a
    flag; workers forked under it reset SIGTERM, so the loader's
    terminate() ends them at once rather than at the 5 s join deadline."""
    import signal
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        dl = _loader(dataset, num_workers=2, queue_depth=1)
        next(dl)
        time.sleep(0.2)            # both workers blocked on a full queue
        t0 = time.monotonic()
        dl.close()
        assert time.monotonic() - t0 < 3.0
        assert not any(p is not None and p.is_alive() for p in dl._procs)
    finally:
        signal.signal(signal.SIGTERM, prev)
