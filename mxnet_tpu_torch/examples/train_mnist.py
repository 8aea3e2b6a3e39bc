"""Train LeNet/MLP on a generated MNIST-like dataset, end to end.

A copy of the reference's ``examples/train_mnist.py`` on the port: the
digits are deterministic synthetic glyphs (each class a distinct bar
pattern plus noise), trained through the fit harness (a ``KVStore``,
Speedometer, lr steps, checkpoints) from an ``NDArrayIter`` or, with
``--use-rec``, from RecordIO through ``ImageRecordIter``.

Run:  python -m mxnet_tpu_torch.examples.train_mnist --num-epochs 5
"""
import argparse
import atexit
import os
import shutil
import tempfile

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples.common import fit as fit_mod
from mxnet_tpu_torch.examples import common


def synth_mnist(n=2000, seed=0):
    """Deterministic 28x28 10-class glyphs: class c = c-th horizontal bar
    + c/10-scaled checkerboard + noise."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.3
    yy, xx = np.mgrid[0:28, 0:28]
    checker = ((yy // 4 + xx // 4) % 2).astype(np.float32)
    for c in range(10):
        idx = y == c
        bar = np.zeros((28, 28), np.float32)
        bar[2 * c:2 * c + 3, :] = 1.0
        x[idx, 0] += bar + 0.1 * c * checker
    return x / x.max(), y.astype(np.float32)


def get_mlp():
    data = mt.sym.Variable("data")
    net = mt.sym.Flatten(data)
    net = mt.sym.FullyConnected(net, num_hidden=128, name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def get_lenet():
    data = mt.sym.Variable("data")
    c1 = mt.sym.Convolution(data, kernel=(5, 5), num_filter=20)
    a1 = mt.sym.Activation(c1, act_type="tanh")
    p1 = mt.sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = mt.sym.Convolution(p1, kernel=(5, 5), num_filter=50)
    a2 = mt.sym.Activation(c2, act_type="tanh")
    p2 = mt.sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = mt.sym.Flatten(p2)
    f1 = mt.sym.FullyConnected(f, num_hidden=500)
    a3 = mt.sym.Activation(f1, act_type="tanh")
    f2 = mt.sym.FullyConnected(a3, num_hidden=10)
    return mt.sym.SoftmaxOutput(f2, name="softmax")


def _pack_rec(x, y, path):
    """Pack the synthetic set into a .rec file of PNGs."""
    import cv2
    rec = mt.recordio.MXRecordIO(path, "w")
    for i in range(x.shape[0]):
        img = (x[i, 0] * 255).astype(np.uint8)
        ok, enc = cv2.imencode(".png", img)
        rec.write(mt.recordio.pack(
            mt.recordio.IRHeader(0, float(y[i]), i, 0), enc.tobytes()))
    rec.close()


def data_loader(args, kv):
    x, y = synth_mnist(args.num_examples, seed=7)
    split = int(0.9 * len(y))
    if args.use_rec:
        d = tempfile.mkdtemp()
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        _pack_rec(x[:split], y[:split], os.path.join(d, "train.rec"))
        _pack_rec(x[split:], y[split:], os.path.join(d, "val.rec"))
        train = mt.io.ImageRecordIter(
            path_imgrec=os.path.join(d, "train.rec"),
            data_shape=(1, 28, 28), batch_size=args.batch_size,
            shuffle=True, scale=1.0 / 255)
        val = mt.io.ImageRecordIter(
            path_imgrec=os.path.join(d, "val.rec"),
            data_shape=(1, 28, 28), batch_size=args.batch_size,
            scale=1.0 / 255)
        return train, val
    train = mt.io.NDArrayIter(x[:split], y[:split], args.batch_size,
                              shuffle=True, label_name="softmax_label")
    val = mt.io.NDArrayIter(x[split:], y[split:], args.batch_size,
                            label_name="softmax_label")
    return train, val


def main(argv=None):
    parser = argparse.ArgumentParser(description="train a digit classifier")
    fit_mod.add_fit_args(parser)
    parser.add_argument("--num-examples", type=int, default=2000)
    parser.add_argument("--use-rec", action="store_true",
                        help="train through the RecordIO image pipeline")
    parser.set_defaults(network="mlp", num_epochs=5, lr=0.1,
                        batch_size=100, disp_batches=10)
    args = parser.parse_args(argv)

    net = get_lenet() if args.network == "lenet" else get_mlp()
    # load once; the val iterator scores the result (with --use-rec a
    # second load would pack the whole dataset again)
    cache = {}

    def loader(a, kv):
        if "iters" not in cache:
            cache["iters"] = data_loader(a, kv)
        return cache["iters"]

    mod = fit_mod.fit(args, net, loader)

    _, val = cache["iters"]
    val.reset()
    score = mod.score(val, "acc")
    print("final validation accuracy: %.4f" % score[0][1])
    common.gate(score[0][1] > 0.9, "failed to learn the synthetic digits")
    if args.model_prefix:
        print("checkpoints at %s-*.params" % args.model_prefix)
    return {"accuracy": float(score[0][1])}


if __name__ == "__main__":
    main()
