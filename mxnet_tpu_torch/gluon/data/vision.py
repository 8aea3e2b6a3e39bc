"""Vision datasets.

Reference: ``python/mxnet/gluon/data/vision.py`` — MNIST, FashionMNIST,
CIFAR10/100, ImageRecordDataset, ImageFolderDataset.

The port's copy of the reference package's ``gluon/data/vision.py``.
Downloads are disabled, as there: datasets read standard files from
``root`` (idx files for MNIST, binary batches for CIFAR, RecordIO for
ImageRecordDataset) and raise a clear error if absent. Images are host
NDArrays.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ... import ndarray as nd
from ... import recordio
from ...context import cpu
from .dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files (reference: vision.py MNIST)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read(self, name):
        path = os.path.join(self._root, name)
        for cand in (path, path + ".gz"):
            if os.path.exists(cand):
                opener = gzip.open if cand.endswith(".gz") else open
                with opener(cand, "rb") as f:
                    return f.read()
        raise FileNotFoundError(
            "MNIST file %s not found under %s (downloads are disabled in "
            "this environment; place the standard idx files there)"
            % (name, self._root))

    def _get_data(self):
        img_name, lbl_name = self._train_files if self._train \
            else self._test_files
        lbl_buf = self._read(lbl_name)
        magic, num = struct.unpack(">II", lbl_buf[:8])
        label = np.frombuffer(lbl_buf, np.uint8, offset=8).astype(np.int32)
        img_buf = self._read(img_name)
        magic, num, rows, cols = struct.unpack(">IIII", img_buf[:16])
        data = np.frombuffer(img_buf, np.uint8, offset=16).reshape(
            num, rows, cols, 1)
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)
        self._label = label


class FashionMNIST(MNIST):
    """(reference: vision.py FashionMNIST — same idx format)."""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python/binary batches (reference: vision.py
    CIFAR10)."""

    _num_classes = 10

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            buf = np.frombuffer(fin.read(), np.uint8)
        row = 3072 + (1 if self._num_classes == 10 else 2)
        buf = buf.reshape(-1, row)
        label = buf[:, 0 if self._num_classes == 10 else 1].astype(np.int32)
        data = buf[:, -3072:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return data, label

    def _get_data(self):
        names = ["data_batch_%d.bin" % i for i in range(1, 6)] \
            if self._train else ["test_batch.bin"]
        paths = [os.path.join(self._root, n) for n in names]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                "CIFAR batches missing: %s (downloads are disabled in this "
                "environment)" % missing)
        parts = [self._read_batch(p) for p in paths]
        data = np.concatenate([p[0] for p in parts])
        label = np.concatenate([p[1] for p in parts])
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)
        self._label = label


class CIFAR100(CIFAR10):
    """(reference: vision.py CIFAR100)."""

    _num_classes = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        names = ["train.bin"] if self._train else ["test.bin"]
        paths = [os.path.join(self._root, n) for n in names]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                "CIFAR-100 batches missing: %s" % missing)
        parts = [self._read_batch(p) for p in paths]
        self._data = nd.array(np.concatenate([p[0] for p in parts]),
                              ctx=cpu(), dtype=np.uint8)
        self._label = np.concatenate([p[1] for p in parts])


class ImageRecordDataset(RecordFileDataset):
    """Images from a RecordIO pack (reference: vision.py
    ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        from ...io.image_record import imdecode
        image = imdecode(img, to_rgb=bool(self._flag))
        label = header.label
        if self._transform is not None:
            return self._transform(image, label)
        return image, label


class ImageFolderDataset(Dataset):
    """``root/class/img.jpg`` layout (reference: vision.py
    ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".npy")
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith(self._exts):
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith(".npy"):
            image = nd.array(np.load(path), ctx=cpu())
        else:
            from ...io.image_record import imread
            image = imread(path, to_rgb=bool(self._flag))
        if self._transform is not None:
            return self._transform(image, label)
        return image, label

    def __len__(self):
        return len(self.items)
