"""Train a small ResNet on a generated CIFAR-like dataset, end to end.

A copy of the reference's ``examples/train_cifar10.py`` on the port:
ResNet-8 for 28x28 crops of 32x32 color textures (10 classes by hue and
stripe direction), trained through the fit harness from RecordIO with
random crops and mirrors, the lr stepped down at epochs 4 and 6.

Run:  python -m mxnet_tpu_torch.examples.train_cifar10 --num-epochs 8
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
from mxnet_tpu_torch.models import resnet

NUM_CLASSES = 10


def synth_cifar(n=2000, seed=0):
    """32x32x3 textures: class = dominant hue pair + stripe direction."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, NUM_CLASSES, n)
    x = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.3
    yy, xx = np.mgrid[0:32, 0:32]
    hstripe = ((yy // 4) % 2).astype(np.float32)
    vstripe = ((xx // 4) % 2).astype(np.float32)
    for c in range(NUM_CLASSES):
        idx = y == c
        x[idx, c % 3] += 0.4
        x[idx, (c // 3) % 3] += 0.3 * (hstripe if c % 2 else vstripe)
    return np.clip(x, 0, 1), y.astype(np.float32)


def _pack_rec(x, y, path):
    import cv2
    rec = mt.recordio.MXRecordIO(path, "w")
    for i in range(x.shape[0]):
        img = (x[i].transpose(1, 2, 0)[:, :, ::-1] * 255).astype(np.uint8)
        ok, enc = cv2.imencode(".png", img)
        rec.write(mt.recordio.pack(
            mt.recordio.IRHeader(0, float(y[i]), i, 0), enc.tobytes()))
    rec.close()


def data_loader(args, kv):
    x, y = synth_cifar(args.num_examples, seed=11)
    split = int(0.9 * len(y))
    d = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    _pack_rec(x[:split], y[:split], os.path.join(d, "train.rec"))
    _pack_rec(x[split:], y[split:], os.path.join(d, "val.rec"))
    train = mt.io.ImageRecordIter(
        path_imgrec=os.path.join(d, "train.rec"),
        data_shape=(3, 28, 28), batch_size=args.batch_size, shuffle=True,
        rand_crop=True, rand_mirror=True, scale=1.0 / 255)
    val = mt.io.ImageRecordIter(
        path_imgrec=os.path.join(d, "val.rec"),
        data_shape=(3, 28, 28), batch_size=args.batch_size,
        scale=1.0 / 255)
    return train, val


def get_symbol():
    # ResNet-8, the small-image variant
    return resnet.get_symbol(num_classes=NUM_CLASSES, num_layers=8,
                             image_shape="3,28,28")


def main(argv=None):
    parser = argparse.ArgumentParser(description="train cifar10-style")
    fit_mod.add_fit_args(parser)
    parser.add_argument("--num-examples", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=42)
    # the lr steps make the final epoch the converged one: at a flat lr
    # of 0.1 SGD oscillates from epoch to epoch on the small val set
    parser.set_defaults(network="resnet", num_epochs=8, lr=0.1,
                        lr_step_epochs="4,6", batch_size=100,
                        disp_batches=10)
    args = parser.parse_args(argv)
    np.random.seed(args.seed)     # initializers draw from the global RNG
    mt.random.seed(args.seed)

    net = get_symbol()
    cache = {}

    def loader(a, kv):
        if "iters" not in cache:
            cache["iters"] = data_loader(a, kv)
        return cache["iters"]

    mod = fit_mod.fit(args, net, loader)
    _, val = cache["iters"]
    val.reset()
    score = mod.score(val, "acc")
    # the final epoch's accuracy is the gate, not a mid-run peak
    print("final validation accuracy: %.4f" % score[0][1])
    common.gate(score[0][1] > 0.85, "failed to learn the synthetic textures")
    return {"accuracy": float(score[0][1])}


if __name__ == "__main__":
    main()
