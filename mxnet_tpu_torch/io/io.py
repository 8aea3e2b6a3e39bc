"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter`` and
``MNISTIter``.

The port's own copy of the reference's ``io/io.py`` (numpy-based there
too). A batch holds the port's NDArrays on the host, as MXNet's
iterators hand out host batches; the module copies them onto its device
when it loads the batch, or ``PrefetchingIter``'s device stage (the
module's ``_device_placer``, which ``fit`` attaches) copies them ahead
of the step that reads them.
"""
from __future__ import annotations

import gzip
import queue
import struct
import threading
import time
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .. import lockcheck as _lockcheck
from .. import ndarray as nd
from .. import profiler as _profiler
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Name, shape, dtype and layout of one input stream."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), np.dtype(dtype),
                               layout)


class DataBatch(object):
    """One batch: lists of data and label arrays."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [lb.shape for lb in self.label] if self.label \
            else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter(object):
    """Base iterator."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize input to a sorted list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {}
    for k, v in data.items():
        out[k] = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (shuffle; last batch pad, discard or
    roll_over)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.data_list = [x[1] for x in self.data] + \
            [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [nd.array(v[self.cursor:self.cursor + self.batch_size],
                             ctx=cpu(), dtype=v.dtype) for _, v in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                         ctx=cpu(), dtype=v.dtype) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        end = min(self.cursor + self.batch_size, self.num_data)
        return self.idx[self.cursor:end]


class ResizeIter(DataIter):
    """Truncate/extend an iterator to a fixed number of batches per epoch
    (reference: io.py:275)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffered prefetch over one or more iterators via background
    threads (reference: io.py:340 PrefetchingIter ≡ dmlc::ThreadedIter,
    src/io/iter_prefetcher.h:46-147).

    Concurrency contract:

    * Every queue entry is tagged with the epoch counter at the moment the
      worker *started* reading it; ``reset()`` bumps the counter under the
      per-iterator lock, so a batch a worker was holding across a reset
      (mid-``put`` on a full queue — the old reset race) carries a stale
      tag and is discarded by the consumer instead of leaking into the
      next epoch.
    * ``close()`` stops the workers and joins them — iterators are no
      longer daemon-fire-and-forget; ``fit()`` closes the wrapper it
      creates, and ``__del__`` is only the last-resort cleanup.
    * ``device_placer`` adds a device-prefetch stage: the worker thread
      runs it on each batch it fetched (the module's ``_device_placer``:
      an H2D copy from pinned staging buffers on a dedicated CUDA
      stream) while the consumer's current step computes, buffered to
      ``device_prefetch`` depth (``MXNET_TPU_DEVICE_PREFETCH``).
    """

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth: int = 2, device_placer=None,
                 device_prefetch: Optional[int] = None):
        super().__init__()
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        # a descriptor may be a DataDesc or a plain (name, shape) pair,
        # as Module.bind takes either
        first = DataDesc(*self.provide_data[0])
        self.batch_size = first.shape[0]
        self._queues = [queue.Queue(maxsize=prefetch_depth)
                        for _ in range(self.n_iter)]
        self._epoch = 0
        self._iter_locks = [_lockcheck.Lock(name="io.iter_lock[%d]" % i)
                            for i in range(self.n_iter)]
        self._closed = False
        self._started = True
        self._first_fetch = True
        self._device_placer = device_placer
        if device_placer is not None:
            # the placement runs inside the (single) worker thread rather
            # than a separate stage: one thread and one queue hop keeps
            # scheduling latency down on small hosts, and the H2D copy
            # still overlaps the consumer's compute
            assert self.n_iter == 1, \
                "device prefetch supports a single wrapped iterator"
            # the device path hands the inner iterator's batch through
            # verbatim (no merge/rewrap), so renames would silently not
            # apply to the yielded batches
            assert rename_data is None and rename_label is None, \
                "device prefetch does not support rename_data/rename_label"
            if device_prefetch is None:
                from .. import config as _config
                device_prefetch = _config.get("MXNET_TPU_DEVICE_PREFETCH")
            self._queues = [queue.Queue(maxsize=max(1, device_prefetch))]
        self._threads = []
        for i in range(self.n_iter):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)

    # -------------------------------------------------------- stage threads
    def _put_tagged(self, q, entry):
        """Blocking put that abandons ship on close and lets reset-stale
        entries through (the consumer discards them by tag)."""
        while self._started:
            try:
                q.put(entry, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, i):
        while self._started:
            with self._iter_locks[i]:
                # the tag is read under the same lock reset() bumps it
                # under, so a reset can never interleave with next()
                epoch = self._epoch
                try:
                    batch = self.iters[i].next()
                    entry = (epoch, "data", batch)
                except StopIteration:
                    entry = (epoch, "stop", None)
                except Exception as exc:               # noqa: BLE001
                    # a dead worker would hang the consumer's blocking
                    # get() forever — carry the error across instead,
                    # re-raised in the thread that can actually catch it
                    entry = (epoch, "error", exc)
            if entry[1] == "data" and self._device_placer is not None \
                    and epoch == self._epoch:
                # device-prefetch stage: issue the H2D copy here so it
                # overlaps the consumer's current step
                try:
                    entry = (epoch, "data", self._device_placer(entry[2]))
                    _profiler.incr_counter("loop_prefetch_placed")
                except Exception as exc:               # noqa: BLE001
                    entry = (epoch, "error", exc)
            self._put_tagged(self._queues[i], entry)
            if entry[1] in ("stop", "error"):
                # parked (end-of-epoch or failed) until reset() bumps the
                # tag — a raising iterator must not be re-driven
                while self._started and self._epoch == epoch:
                    time.sleep(0.01)

    @staticmethod
    def _reraise_worker_error(exc):
        """Re-raise an exception carried over from a prefetch worker, with
        a breadcrumb: the traceback points into the worker thread, which
        surprises users whose iterator fit() auto-wrapped."""
        if hasattr(exc, "add_note"):                       # Python >= 3.11
            exc.add_note(
                "(raised inside a PrefetchingIter worker thread — the "
                "inner iterator's next() runs off the main thread under "
                "device prefetch; set MXNET_TPU_DEVICE_PREFETCH=0 for "
                "thread-affine iterators)")
        raise exc

    def _host_next_tagged(self):
        """One merged host batch off the worker queues, tag-preserving.
        Entries from before the last reset are dropped here."""
        cur = self._epoch
        batches = []
        for q in self._queues:
            while True:
                epoch, kind, batch = q.get()
                if epoch != cur:
                    continue        # pre-reset leftover: discard
                break
            if kind == "error":
                self._reraise_worker_error(batch)
            if kind == "stop":
                return cur, None
            batches.append(batch)
        data = sum([b.data for b in batches], [])
        label = sum([(b.label or []) for b in batches], [])
        return cur, DataBatch(data=data, label=label or None,
                              pad=batches[0].pad, index=batches[0].index,
                              provide_data=self.provide_data,
                              provide_label=self.provide_label)

    # ------------------------------------------------------------- provides
    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    # ------------------------------------------------------------ lifecycle
    def reset(self):
        # bump the epoch under every iterator lock: workers are guaranteed
        # not mid-next(), and anything they already produced (or are
        # blocked putting) carries the old tag and gets discarded
        for lock in self._iter_locks:
            lock.acquire()
        try:
            self._epoch += 1
            for it in self.iters:
                it.reset()
            # drain BEFORE releasing: a worker needs the iterator lock to
            # produce a fresh-epoch batch, so everything in the queues here
            # is stale by construction — draining after release could
            # discard a new epoch's batch 0 (already consumed from the
            # inner iterator = silent data loss). A worker mid-put with a
            # stale batch lands after the drain; the consumer's tag check
            # discards it.
            self._drain()
            self._first_fetch = True
        finally:
            for lock in self._iter_locks:
                lock.release()

    def _drain(self):
        for q in self._queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def close(self, join_timeout=10.0):
        """Stop and join the prefetch threads (idempotent). After close the
        iterator is dead — create a new one to iterate again. Returns True
        when every worker joined inside `join_timeout` seconds; False means
        a worker is still wedged inside the inner iterator's next() and the
        inner iterator must not be touched from another thread."""
        if self._closed:
            return all(not t.is_alive() for t in self._threads)
        self._closed = True
        self._started = False
        deadline = time.monotonic() + join_timeout
        for t in self._threads:
            # workers blocked on a full queue poll _started with a 50ms
            # timeout; drain anyway so they exit on the fast path
            while t.is_alive() and time.monotonic() < deadline:
                self._drain()
                t.join(timeout=0.05)
        self._drain()
        return all(not t.is_alive() for t in self._threads)

    def next(self):
        if self._closed:
            # the workers are gone and nothing will ever be queued again:
            # a blocking get() here would hang forever, silently
            raise MXNetError("PrefetchingIter used after close()")
        if self._device_placer is not None:
            q = self._queues[0]
            try:
                entry = q.get_nowait()
            except queue.Empty:
                # the step outran the placement stage: pipeline bubble —
                # except on the first fetch of an epoch, where the queue
                # is cold by construction and an empty queue says nothing
                # about steady-state health
                if not self._first_fetch:
                    _profiler.incr_counter("loop_prefetch_stall")
                entry = q.get()
            self._first_fetch = False
            while entry[0] != self._epoch:
                entry = q.get()
            _profiler.set_gauge("loop_prefetch_depth", q.qsize())
            _epoch, kind, batch = entry
            if kind == "stop":
                raise StopIteration
            if kind == "error":
                self._reraise_worker_error(batch)
            return batch
        _epoch, batch = self._host_next_tagged()
        if batch is None:
            raise StopIteration
        return batch

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False

    def __del__(self):
        try:
            # GC must never block for seconds on a wedged worker: flip the
            # flags and drain, but don't wait on the join
            self.close(join_timeout=0.0)
        except Exception:                                  # noqa: BLE001
            pass


class CSVIter(DataIter):
    """Iterate CSV files (reference: src/io/iter_csv.cc:150 — data_csv,
    data_shape, label_csv, batch_size, round_batch)."""

    def __init__(self, data_csv: str, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype=np.float32, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_shape = tuple(label_shape)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        self._data = data.reshape((-1,) + self.data_shape)
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype, ndmin=2)
            self._label = label.reshape((-1,) + self.label_shape)
            if self.label_shape == (1,):
                self._label = self._label.reshape(-1)
        else:
            self._label = np.zeros(self._data.shape[0], dtype=dtype)
        self.round_batch = round_batch
        self._iter = NDArrayIter(
            self._data, self._label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            data_name="data", label_name="label")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()

    def getindex(self):
        return self._iter.getindex()


def _read_idx_file(path: str, expected_magic_dims):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xff
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


class MNISTIter(DataIter):
    """MNIST idx-format iterator (reference: src/io/iter_mnist.cc:259 —
    image=, label=, batch_size, shuffle, flat, seed, silent)."""

    def __init__(self, image: str, label: str, batch_size=128, shuffle=True,
                 flat=False, seed=0, silent=False, input_shape=None, **kwargs):
        super().__init__(batch_size)
        images = _read_idx_file(image, 3).astype(np.float32) / 255.0
        labels = _read_idx_file(label, 1).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        elif input_shape is not None:
            images = images.reshape((-1,) + tuple(input_shape))
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        if shuffle:
            rng = np.random.RandomState(seed)
            order = rng.permutation(images.shape[0])
            images, labels = images[order], labels[order]
        self._iter = NDArrayIter(images, labels, batch_size=batch_size,
                                 last_batch_handle="discard",
                                 data_name="data", label_name="label")

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()

    def getindex(self):
        return self._iter.getindex()
