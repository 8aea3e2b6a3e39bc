"""Datasets: the port's copy of the reference's ``gluon/data/dataset.py``
— Dataset (with ``transform`` / ``transform_first``), SimpleDataset and
ArrayDataset. ``RecordFileDataset``, over RecordIO files, is not ported
yet (ROADMAP.md A5, with ``data/vision.py``'s file-backed datasets).
"""
from __future__ import annotations

from ... import ndarray as nd

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset"]


class Dataset(object):
    """Abstract dataset (reference: dataset.py Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """Return a dataset with fn applied to each sample."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Apply fn to the first element of each sample only."""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    """Wrap a list/array into a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of arrays (reference: dataset.py ArrayDataset)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    "All arrays must have the same length; array[0] has %d "
                    "while array[%d] has %d." % (self._length, i, len(data)))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length
