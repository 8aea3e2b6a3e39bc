"""DataLoader: the port's copy of the reference's
``gluon/data/dataloader.py`` — batches a Dataset with a Sampler; with
``num_workers`` > 0 one background thread prefetches batches (the
reference package's replacement for MXNet's worker processes). Batches
of numpy samples become arrays on the current device
(``context.current_device``).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ... import ndarray as nd
from ...context import current_device, device_scope
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: dataloader.py
    default_batchify_fn)."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class DataLoader(object):
    """(reference: dataloader.py DataLoader)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._make_batch(batch_idx)
            return

        # double-buffered background prefetch on the caller's device (the
        # device scope is per thread); a failure in the thread is raised
        # here, at the batch it would have produced
        q: "queue.Queue" = queue.Queue(maxsize=max(2, self._num_workers))
        sentinel = object()
        dev = current_device()

        def worker():
            try:
                with device_scope(dev):
                    for batch_idx in self._batch_sampler:
                        q.put((self._make_batch(batch_idx), None))
            except Exception as exc:            # re-raised by the reader
                q.put((None, exc))
            finally:
                q.put((sentinel, None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item, exc = q.get()
            if exc is not None:
                raise exc
            if item is sentinel:
                break
            yield item
        t.join()

    def __len__(self):
        return len(self._batch_sampler)
