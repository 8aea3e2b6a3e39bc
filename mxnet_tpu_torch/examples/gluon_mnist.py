"""Gluon imperative training on the synthetic digit set.

A copy of the reference's ``examples/gluon_mnist.py`` on the port: a
``nn.HybridSequential`` MLP trained under ``autograd.record`` by a
``gluon.Trainer`` (``--hybridize`` runs the forward as one cached
graph), on :func:`.train_mnist.synth_mnist`'s digits.

Run:  python -m mxnet_tpu_torch.examples.gluon_mnist --hybridize
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.examples import common
from mxnet_tpu_torch.examples.train_mnist import synth_mnist


def build_net():
    nn = gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Flatten())
        net.add(nn.Dense(128, activation="relu"))
        net.add(nn.Dense(64, activation="relu"))
        net.add(nn.Dense(10))
    return net


def evaluate(net, x, y, batch_size, ctx):
    correct = 0
    batch_size = min(batch_size, len(y))
    n = (len(y) // batch_size) * batch_size
    for s in range(0, n, batch_size):
        out = net(mt.nd.array(x[s:s + batch_size], ctx=ctx))
        correct += int((out.asnumpy().argmax(1) ==
                        y[s:s + batch_size]).sum())
    return correct / n


def main(argv=None):
    parser = argparse.ArgumentParser(description="gluon digit classifier")
    parser.add_argument("--num-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--num-examples", type=int, default=2000)
    parser.add_argument("--hybridize", action="store_true")
    args = parser.parse_args(argv)

    ctx = mt.context.current_context()
    x, y = synth_mnist(args.num_examples, seed=7)
    split = int(0.9 * len(y))

    net = build_net()
    net.initialize(mt.init.Xavier(), ctx=ctx)
    if args.hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    bs = args.batch_size
    for epoch in range(args.num_epochs):
        perm = np.random.RandomState(epoch).permutation(split)
        tot = 0.0
        for s in range(0, split - bs + 1, bs):
            idx = perm[s:s + bs]
            data = mt.nd.array(x[idx], ctx=ctx)
            label = mt.nd.array(y[idx], ctx=ctx)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(bs)
            tot += float(loss.asnumpy().mean())
        print("epoch %d loss %.4f" % (epoch, tot / max(split // bs, 1)))

    acc = evaluate(net, x[split:], y[split:], bs, ctx)
    print("final validation accuracy: %.4f" % acc)
    common.gate(acc > 0.9, "failed to learn the synthetic digits")
    return {"accuracy": float(acc)}


if __name__ == "__main__":
    main()
