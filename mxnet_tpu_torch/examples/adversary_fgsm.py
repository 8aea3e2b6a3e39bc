"""FGSM adversarial examples: attack a trained classifier through the
gradient on its input.

A copy of the reference's ``examples/adversary_fgsm.py`` on the port
(Goodfellow et al.'s fast gradient sign method): train a small MLP,
then take the loss's gradient with respect to the input images and step
each pixel by ``eps`` in its sign. The accuracy on the perturbed images
must collapse while the perturbation stays within ``eps``.

Run:  python -m mxnet_tpu_torch.examples.adversary_fgsm
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common


def synth_digits(n, seed=0):
    """10-class 16x16 'digit' patterns: class = which cell of a 4-row
    template grid is lit, plus noise."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 1, 16, 16).astype(np.float32) * 0.25
    for c in range(10):
        r, co = divmod(c, 4)
        x[y == c, 0, 4 * r:4 * r + 4, 4 * co:4 * co + 4] += 0.65
    return np.clip(x, 0, 1), y.astype(np.float32)


def build_net(pkg=mt):
    """The classifier, in ``pkg``'s Gluon (this package's by
    default)."""
    nn = pkg.gluon.nn
    net = nn.Sequential()
    net.add(nn.Flatten(), nn.Dense(128, activation="relu"), nn.Dense(10))
    return net


def fgsm(net, loss_fn, x, y, eps):
    """``(x_adv, gradient)``: ``x`` stepped by ``eps`` in the sign of
    the mean loss's gradient on it, clipped to [0, 1]."""
    xv = mt.nd.array(x)
    xv.attach_grad()
    with mt.autograd.record():
        loss = mt.nd.mean(loss_fn(net(xv), mt.nd.array(y)))
    loss.backward()
    g = xv.grad.asnumpy()
    return np.clip(x + eps * np.sign(g), 0, 1), g


def main(argv=None):
    p = argparse.ArgumentParser(description="FGSM adversarial attack")
    p.add_argument("--num-epochs", type=int, default=6)
    p.add_argument("--eps", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    np.random.seed(args.seed)

    X, Y = synth_digits(1500, seed=1)
    Xv, Yv = synth_digits(300, seed=2)

    net = build_net()
    net.initialize(mt.init.Xavier())
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    sce = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    bs = 100
    for epoch in range(args.num_epochs):
        for i in range(0, len(Y), bs):
            xb = mt.nd.array(X[i:i + bs])
            yb = mt.nd.array(Y[i:i + bs])
            with mt.autograd.record():
                loss = mt.nd.mean(sce(net(xb), yb))
            loss.backward()
            trainer.step(1)

    clean_acc = float((net(mt.nd.array(Xv)).asnumpy().argmax(1)
                       == Yv).mean())
    x_adv, _ = fgsm(net, sce, Xv, Yv, args.eps)
    adv_acc = float((net(mt.nd.array(x_adv)).asnumpy().argmax(1)
                     == Yv).mean())
    linf = float(np.abs(x_adv - Xv).max())
    print("clean accuracy: %.3f   FGSM(eps=%.2f) accuracy: %.3f   "
          "Linf=%.3f" % (clean_acc, args.eps, adv_acc, linf))
    common.gate(clean_acc > 0.95, "model failed to train")
    common.gate(adv_acc < 0.5 * clean_acc, "attack did not degrade the model")
    common.gate(linf <= args.eps + 1e-6, "perturbation exceeded the budget")
    return {"clean_accuracy": clean_acc, "fgsm_accuracy": adv_acc,
            "linf": linf}


if __name__ == "__main__":
    main()
