"""Gluon's file datasets in the port against the reference's:
``RecordFileDataset``, ``vision.MNIST`` / ``FashionMNIST``,
``CIFAR10`` / ``CIFAR100``, ``ImageRecordDataset`` and
``ImageFolderDataset``, each read from tiny files the test writes in its
format (downloads are disabled in both packages), and ``tools.im2rec``
packing a directory the reference's reader takes.
"""
import gzip
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu.gluon.data import vision as ref_vision
from mxnet_tpu_torch.gluon.data import vision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same_items(a, b, n):
    assert len(a) == len(b) == n
    for i in range(n):
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(_np(x), _np(y))


def _idx(path, arr, gz=False):
    dims = arr.shape
    head = struct.pack(">I", (0x08 << 8) | len(dims)) + \
        struct.pack(">" + "I" * len(dims), *dims)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("cls,gz,train", [("MNIST", False, True),
                                          ("MNIST", True, False),
                                          ("FashionMNIST", False, True)])
def test_mnist_datasets_match_reference(tmp_path, cls, gz, train):
    rng = np.random.RandomState(0)
    names = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte") if train \
        else ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    ext = ".gz" if gz else ""
    _idx(str(tmp_path / (names[0] + ext)), rng.randint(0, 256, (7, 28, 28)),
         gz)
    _idx(str(tmp_path / (names[1] + ext)), rng.randint(0, 10, (7,)), gz)
    port = getattr(vision, cls)(root=str(tmp_path), train=train)
    ref = getattr(ref_vision, cls)(root=str(tmp_path), train=train)
    _same_items(port, ref, 7)
    assert port[0][0].shape == (28, 28, 1)
    assert port[0][0].data.device.type == "cpu"
    t = getattr(vision, cls)(root=str(tmp_path), train=train,
                             transform=lambda d, lab: (d, lab + 1))
    assert t[3][1] == port[3][1] + 1


def test_missing_files_fail_loudly(tmp_path):
    for cls in ("MNIST", "CIFAR10", "CIFAR100"):
        with pytest.raises(FileNotFoundError, match="disabled|missing"):
            getattr(vision, cls)(root=str(tmp_path / cls))


@pytest.mark.parametrize("cls", ["CIFAR10", "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_cifar_datasets_match_reference(tmp_path, cls, train):
    rng = np.random.RandomState(1)
    row = 3072 + (1 if cls == "CIFAR10" else 2)
    if cls == "CIFAR10":
        names = ["data_batch_%d.bin" % i for i in range(1, 6)] if train \
            else ["test_batch.bin"]
    else:
        names = ["train.bin"] if train else ["test.bin"]
    for name in names:
        rng.randint(0, 100, (3, row)).astype(np.uint8).tofile(
            str(tmp_path / name))
    port = getattr(vision, cls)(root=str(tmp_path), train=train)
    ref = getattr(ref_vision, cls)(root=str(tmp_path), train=train)
    _same_items(port, ref, 3 * len(names))
    assert port[0][0].shape == (32, 32, 3)


@pytest.fixture()
def packed(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = ref_rio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        img = np.random.RandomState(i).randint(0, 255, (12, 10 + i, 3))
        w.write_idx(i, ref_rio.pack_img(ref_rio.IRHeader(0, float(i % 2),
                                                         i, 0),
                                        img.astype(np.uint8),
                                        img_fmt=".png"))
    w.close()
    return rec, cv2


def test_record_file_dataset_matches_reference(packed):
    rec, _ = packed
    port = mt.gluon.data.RecordFileDataset(rec)
    ref = mx.gluon.data.RecordFileDataset(rec)
    assert len(port) == len(ref) == 5
    assert [port[i] for i in range(5)] == [ref[i] for i in range(5)]


@pytest.mark.parametrize("flag", [1, 0])
def test_image_record_dataset_matches_reference(packed, flag):
    rec, _ = packed
    port = vision.ImageRecordDataset(rec, flag=flag)
    ref = ref_vision.ImageRecordDataset(rec, flag=flag)
    _same_items(port, ref, 5)
    t = vision.ImageRecordDataset(rec, transform=lambda d, lab: (d, -lab))
    assert t[1][1] == -port[1][1]


def test_image_folder_dataset_matches_reference(tmp_path):
    cv2 = pytest.importorskip("cv2")
    for c, cls in enumerate(("cat", "dog")):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            img = np.random.RandomState(c * 10 + i).randint(0, 255,
                                                            (9, 11, 3))
            cv2.imwrite(str(tmp_path / cls / ("%d.png" % i)),
                        img.astype(np.uint8))
        np.save(str(tmp_path / cls / "x.npy"), np.ones((2, 2, 3)))
        open(tmp_path / cls / "notes.txt", "w").close()
    port = vision.ImageFolderDataset(str(tmp_path))
    ref = ref_vision.ImageFolderDataset(str(tmp_path))
    assert port.synsets == ref.synsets == ["cat", "dog"]
    assert port.items == ref.items
    _same_items(port, ref, 8)


def test_im2rec_packs_what_both_readers_take(tmp_path):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "images"
    for c, cls in enumerate(("a", "b")):
        os.makedirs(root / cls)
        for i in range(2):
            img = np.random.RandomState(c * 5 + i).randint(0, 255,
                                                           (30, 40, 3))
            cv2.imwrite(str(root / cls / ("%d.jpg" % i)),
                        img.astype(np.uint8))
    prefix = str(tmp_path / "out" / "set")
    os.makedirs(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in (["--list"], ["--resize", "20"]):
        proc = subprocess.run([sys.executable, "-m",
                               "mxnet_tpu_torch.tools.im2rec", prefix,
                               str(root)] + extra, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    lines = open(prefix + ".lst").read().splitlines()
    assert len(lines) == 4 and lines[2].split("\t")[-1] == "b/0.jpg"
    for pkg in (mt.recordio, ref_rio):
        r = pkg.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
        assert r.keys == [0, 1, 2, 3]
        header, img = pkg.unpack_img(r.read_idx(3))
        assert header.label == 1.0 and min(img.shape[:2]) == 20
        r.close()
