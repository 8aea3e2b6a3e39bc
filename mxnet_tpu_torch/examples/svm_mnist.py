"""Large-margin classification with SVMOutput.

A copy of the reference's ``examples/svm_mnist.py`` on the port: the
same conv features under three loss heads, ``SVMOutput`` with the
squared-hinge (L2) and hinge (L1) losses and ``SoftmaxOutput``, each
trained by ``forward_backward`` + ``update`` on synthetic digits; all
three must clear the accuracy bar.

Run:  python -m mxnet_tpu_torch.examples.svm_mnist --num-epochs 4
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common

HEADS = ("l2-svm", "l1-svm", "softmax")


def synth_digits(n, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 16, 16).astype(np.float32) * 0.25
    for c in range(10):
        r, co = divmod(c, 4)
        x[y == c, 0, 4 * r:4 * r + 4, 4 * co:4 * co + 4] += 0.65
    return np.clip(x, 0, 1), y.astype(np.float32)


def build(head, margin=1.0, reg=1.0):
    data = mt.sym.Variable("data")
    h = mt.sym.Convolution(data, num_filter=16, kernel=(3, 3), pad=(1, 1),
                           name="c1")
    h = mt.sym.Activation(h, act_type="relu")
    h = mt.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = mt.sym.FullyConnected(h, num_hidden=10, name="fc")
    label = mt.sym.Variable("softmax_label")
    if head == "softmax":
        return mt.sym.SoftmaxOutput(h, label, name="softmax")
    return mt.sym.SVMOutput(h, label, margin=margin,
                            regularization_coefficient=reg,
                            use_linear=(head == "l1-svm"), name="svm")


def run(head, X, Y, Xv, Yv, args):
    mod = mt.mod.Module(build(head), context=mt.current_context())
    mod.bind(data_shapes=[("data", (args.batch_size, 1, 16, 16))],
             label_shapes=[("softmax_label", (args.batch_size,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    it = mt.io.NDArrayIter(X, Y, args.batch_size, shuffle=True,
                           label_name="softmax_label")
    for epoch in range(args.num_epochs):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
    vit = mt.io.NDArrayIter(Xv, Yv, args.batch_size,
                            label_name="softmax_label")
    score = mod.score(vit, "acc")
    return float(score[0][1])


def main(argv=None):
    p = argparse.ArgumentParser(description="SVM heads vs softmax")
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--num-examples", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    np.random.seed(args.seed)

    X, Y = synth_digits(args.num_examples, seed=1)
    Xv, Yv = synth_digits(300, seed=2)
    scores = {}
    for head in HEADS:
        acc = run(head, X, Y, Xv, Yv, args)
        print("%-8s accuracy: %.4f" % (head, acc))
        common.gate(acc > 0.9, "%s failed to learn" % head)
        scores[head] = acc
    return scores


if __name__ == "__main__":
    main()
