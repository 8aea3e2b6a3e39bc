"""Gluon super-resolution: a sub-pixel (pixel-shuffle) upscaling CNN.

A copy of the reference's ``examples/super_resolution.py`` on the port
(ESPCN, Shi et al.: a conv stack, a Conv2D to upscale^2 channels and a
pixel-shuffle reorder to the upscaled image, L2 loss, a global residual
over nearest upscaling). The images are synthetic band-limited
mixtures of low-frequency sinusoids; the net's PSNR must beat nearest
upscaling's.

Run:  python -m mxnet_tpu_torch.examples.super_resolution --num-epochs 14
"""
import argparse
import math
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common


def make_images(n, hw, seed=0):
    """Band-limited images: sums of low-frequency sinusoid products."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw),
                         indexing="ij")
    imgs = np.zeros((n, 1, hw, hw), np.float32)
    for i in range(n):
        img = np.zeros((hw, hw), np.float32)
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            img += rng.uniform(0.3, 1.0) * np.sin(
                2 * np.pi * fx * xx + ph[0]) * np.sin(
                2 * np.pi * fy * yy + ph[1])
        img = (img - img.min()) / (img.max() - img.min() + 1e-6)
        imgs[i, 0] = img
    return imgs


def downscale(imgs, factor):
    """Box-average downscale (the LR inputs)."""
    n, c, h, w = imgs.shape
    return imgs.reshape(n, c, h // factor, factor,
                        w // factor, factor).mean((3, 5))


def nearest_upscale(imgs, factor):
    return imgs.repeat(factor, axis=2).repeat(factor, axis=3)


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


class SuperResolutionNet:
    """conv5x5(64) -> conv3x3(64) -> conv3x3(32) -> conv3x3(r^2) ->
    pixel shuffle, in ``pkg``'s Gluon."""

    def __init__(self, pkg, upscale):
        nn = pkg.gluon.nn
        self.pkg = pkg
        self.upscale = upscale
        net = nn.HybridSequential()
        net.add(nn.Conv2D(64, kernel_size=5, padding=2, activation="relu"))
        net.add(nn.Conv2D(64, kernel_size=3, padding=1, activation="relu"))
        net.add(nn.Conv2D(32, kernel_size=3, padding=1, activation="relu"))
        net.add(nn.Conv2D(upscale * upscale, kernel_size=3, padding=1))
        self.body = net

    def __call__(self, x):
        nd = self.pkg.nd
        r = self.upscale
        y = self.body(x)                             # (N, r*r, H, W)
        n, _, h, w = y.shape
        # pixel shuffle: (N, r*r, H, W) -> (N, 1, H*r, W*r)
        y = nd.reshape(y, (n, r, r, h, w))
        y = nd.transpose(y, axes=(0, 3, 1, 4, 2))    # (N, H, r, W, r)
        y = nd.reshape(y, (n, 1, h * r, w * r))
        # global residual: the net predicts the correction to nearest
        # upscaling, so training starts at the baseline's PSNR
        near = nd.repeat(nd.repeat(x, repeats=r, axis=2),
                         repeats=r, axis=3)
        return y + near

    def collect_params(self):
        return self.body.collect_params()

    def initialize(self, init):
        self.body.initialize(init)


def main(argv=None):
    p = argparse.ArgumentParser(description="ESPCN super resolution")
    p.add_argument("--num-epochs", type=int, default=14)
    p.add_argument("--num-examples", type=int, default=96)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--upscale", type=int, default=2)
    p.add_argument("--hw", type=int, default=32, help="high-res size")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    np.random.seed(args.seed)   # initializers draw from the global RNG

    hi = make_images(args.num_examples, args.hw)
    lo = downscale(hi, args.upscale)
    n_val = max(args.batch_size, args.num_examples // 6)
    tr_lo, tr_hi = lo[n_val:], hi[n_val:]
    va_lo, va_hi = lo[:n_val], hi[:n_val]

    net = SuperResolutionNet(mt, args.upscale)
    net.initialize(mt.init.Xavier())
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": args.lr})

    nb = len(tr_lo) // args.batch_size
    if nb < 1:
        p.error("--num-examples %d leaves %d training images after the "
                "validation split; need at least one batch of %d"
                % (args.num_examples, len(tr_lo), args.batch_size))
    for epoch in range(args.num_epochs):
        tic = time.perf_counter()
        tot = 0.0
        for b in range(nb):
            x = mt.nd.array(tr_lo[b * args.batch_size:
                                  (b + 1) * args.batch_size])
            y = mt.nd.array(tr_hi[b * args.batch_size:
                                  (b + 1) * args.batch_size])
            with mt.autograd.record():
                out = net(x)
                loss = mt.nd.mean(mt.nd.square(out - y))
            loss.backward()
            trainer.step(args.batch_size)
            tot += float(loss.asnumpy())
        print("Epoch[%d] mse=%.5f (%.1fs)"
              % (epoch, tot / nb, time.perf_counter() - tic), flush=True)

    pred = net(mt.nd.array(va_lo)).asnumpy()
    base = nearest_upscale(va_lo, args.upscale)
    p_net = psnr(pred, va_hi)
    p_base = psnr(base, va_hi)
    print("PSNR: net=%.2f dB baseline(nearest)=%.2f dB" % (p_net, p_base))
    common.gate(p_net > p_base, "super-resolution net did not beat nearest")
    return {"psnr": p_net, "baseline_psnr": p_base}


if __name__ == "__main__":
    main()
