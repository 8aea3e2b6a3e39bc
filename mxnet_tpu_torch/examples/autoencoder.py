"""Stacked autoencoder: layer-wise pretraining, then fine-tuning.

A copy of the reference's ``examples/autoencoder.py`` on the port: each
(encoder, decoder) pair of Dense layers is pretrained on the frozen
encoding below it, then the whole stack is fine-tuned end to end with
Gluon's Trainer (Adam). The data lie near a 4-dimensional linear
manifold in 32 dimensions, so the reconstruction error must end far
below that of predicting the mean.

Run:  python -m mxnet_tpu_torch.examples.autoencoder --num-epochs 12
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common

DIM = 32
DIMS = (DIM, 16, 4)


def synth_data(n, seed=0):
    """Points near a 4-dim linear manifold inside DIM dims + noise."""
    rng = np.random.RandomState(seed)
    basis = rng.randn(4, DIM).astype(np.float32)
    codes = rng.randn(n, 4).astype(np.float32)
    return codes @ basis + 0.05 * rng.randn(n, DIM).astype(np.float32)


def build_stack(pkg=mt):
    """``(encoders, decoders)``: Dense layers in ``pkg``'s Gluon (this
    package's by default)."""
    nn = pkg.gluon.nn
    n = len(DIMS) - 1
    encoders = [nn.Dense(DIMS[i + 1], activation=None if i == n - 1
                         else "relu", in_units=DIMS[i]) for i in range(n)]
    decoders = [nn.Dense(DIMS[i], activation=None if i == 0 else "relu",
                         in_units=DIMS[i + 1]) for i in range(n)]
    return encoders, decoders


def full(encoders, decoders, z):
    """The whole stack: every encoder, then the decoders in reverse."""
    h = z
    for enc in encoders:
        h = enc(h)
    for dec in reversed(decoders):
        h = dec(h)
    return h


def main(argv=None):
    p = argparse.ArgumentParser(description="stacked autoencoder")
    p.add_argument("--num-epochs", type=int, default=12)
    p.add_argument("--pretrain-epochs", type=int, default=4)
    p.add_argument("--num-examples", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)
    np.random.seed(args.seed)

    x = synth_data(args.num_examples)
    n_val = args.num_examples // 5
    tr, va = x[n_val:], x[:n_val]

    encoders, decoders = build_stack()
    for blk in encoders + decoders:
        blk.initialize(mt.init.Xavier())

    def run_epochs(param_blocks, fwd, epochs, data, tag):
        trainer = mt.gluon.Trainer(sum([list(b.collect_params().values())
                                        for b in param_blocks], []),
                                   "adam", {"learning_rate": args.lr})
        nb = len(data) // args.batch_size
        if nb < 1:
            p.error("--batch-size %d exceeds the %d-row training slice"
                    % (args.batch_size, len(data)))
        for ep in range(epochs):
            tot = 0.0
            for b in range(nb):
                xb = mt.nd.array(data[b * args.batch_size:
                                      (b + 1) * args.batch_size])
                with mt.autograd.record():
                    loss = mt.nd.mean(mt.nd.square(fwd(xb) - xb))
                loss.backward()
                trainer.step(args.batch_size)
                tot += float(loss.asnumpy())
            print("%s epoch[%d] mse=%.5f" % (tag, ep, tot / nb),
                  flush=True)

    # greedy layer-wise pretraining: (enc_i, dec_i) on the frozen
    # encoding below
    feats = tr
    for i, (enc, dec) in enumerate(zip(encoders, decoders)):
        run_epochs([enc, dec], lambda z, e=enc, d=dec: d(e(z)),
                   args.pretrain_epochs, feats, "pretrain-layer%d" % i)
        feats = enc(mt.nd.array(feats)).asnumpy()

    # end-to-end fine-tune of the full stack
    run_epochs(encoders + decoders,
               lambda z: full(encoders, decoders, z), args.num_epochs, tr,
               "finetune")

    rec = full(encoders, decoders, mt.nd.array(va)).asnumpy()
    mse = float(np.mean((rec - va) ** 2))
    base = float(np.mean((va - tr.mean(0)) ** 2))
    print("val mse=%.5f mean-baseline=%.5f" % (mse, base))
    common.gate(mse < base * 0.2, "autoencoder failed to learn the manifold")
    return {"mse": mse, "baseline": base}


if __name__ == "__main__":
    main()
