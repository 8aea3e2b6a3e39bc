"""Neural style transfer: optimize the input image, not the weights.

A copy of the reference's ``examples/neural_style.py`` on the port
(Gatys et al.): a fixed random convolutional feature extractor defines
a content loss (deep feature match) and a style loss (Gram-matrix
match), and normalized gradient descent runs on the image's pixels
(``x.attach_grad()`` + ``autograd.record``). The style loss must fall
to under a quarter while the image stays much closer to the content
than the style image is.

Run:  python -m mxnet_tpu_torch.examples.neural_style --num-steps 120
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common


def make_images(size=48, seed=0):
    """Content: centered disc. Style: diagonal stripes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    content = np.stack([
        ((yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.09).astype(np.float32),
        ((yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.04).astype(np.float32),
        np.zeros((size, size), np.float32)])
    stripes = (np.sin((yy + xx) * 40) > 0).astype(np.float32)
    style = np.stack([stripes, 1 - stripes,
                      0.5 * np.ones((size, size), np.float32)])
    content += 0.05 * rng.rand(3, size, size).astype(np.float32)
    style += 0.05 * rng.rand(3, size, size).astype(np.float32)
    return content[None], style[None]


def feature_weights():
    """The fixed random conv stack's two weights (numpy)."""
    rng = np.random.RandomState(3)
    return (rng.randn(16, 3, 3, 3).astype(np.float32) * 0.4,
            rng.randn(32, 16, 3, 3).astype(np.float32) * 0.2)


def features(pkg, x, W1, W2):
    """The two feature levels of ``x`` in ``pkg``'s ``nd``."""
    nd = pkg.nd
    h1 = nd.Activation(
        nd.Convolution(x, W1, num_filter=16, kernel=(3, 3), pad=(1, 1),
                       no_bias=True),
        act_type="relu")
    h2 = nd.Activation(
        nd.Convolution(nd.Pooling(h1, kernel=(2, 2), stride=(2, 2),
                                  pool_type="avg"),
                       W2, num_filter=32, kernel=(3, 3), pad=(1, 1),
                       no_bias=True),
        act_type="relu")
    return h1, h2


def gram(pkg, f):
    n, c = f.shape[0], f.shape[1]
    flat = pkg.nd.reshape(f, (n, c, -1))
    hw = flat.shape[2]
    return pkg.nd.batch_dot(flat, flat, transpose_b=True) / float(hw)


def losses(pkg, x, W1, W2, c_feats, s_grams):
    """``(content loss, style loss)`` of image ``x``."""
    nd = pkg.nd
    f1, f2 = features(pkg, x, W1, W2)
    closs = nd.mean(nd.square(f2 - c_feats[1]))
    sloss = nd.mean(nd.square(gram(pkg, f1) - s_grams[0])) + \
        nd.mean(nd.square(gram(pkg, f2) - s_grams[1]))
    return closs, sloss


def main(argv=None):
    p = argparse.ArgumentParser(description="neural style transfer")
    p.add_argument("--num-steps", type=int, default=120)
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--style-weight", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    np.random.seed(args.seed)

    content, style = make_images(args.size)
    W1, W2 = (mt.nd.array(w) for w in feature_weights())

    c_feats = [f.detach() for f in features(mt, mt.nd.array(content),
                                            W1, W2)]
    s_grams = [gram(mt, f) for f in features(mt, mt.nd.array(style),
                                             W1, W2)]

    x = mt.nd.array(content.copy())
    x.attach_grad()

    c0, s0 = (float(v.asnumpy())
              for v in losses(mt, x, W1, W2, c_feats, s_grams))
    # the scale for "content survived": how far the style image is from
    # the content features; the result must stay much closer than that
    _, sf2 = features(mt, mt.nd.array(style), W1, W2)
    c_of_style = float(mt.nd.mean(
        mt.nd.square(sf2 - c_feats[1])).asnumpy())
    for step in range(args.num_steps):
        with mt.autograd.record():
            closs, sloss = losses(mt, x, W1, W2, c_feats, s_grams)
            loss = closs + args.style_weight * sloss
        loss.backward()
        # gradient descent on the pixels, normalized by the mean |grad|
        # so the step is on the image's scale
        g = x.grad.asnumpy()
        g /= np.abs(g).mean() + 1e-8
        x = mt.nd.array(np.clip(x.asnumpy() - args.lr * g, -0.2, 1.4))
        x.attach_grad()
        if step % 30 == 0:
            print("step %3d  content=%.5f style=%.5f"
                  % (step, float(closs.asnumpy()),
                     float(sloss.asnumpy())), flush=True)

    c1, s1 = (float(v.asnumpy())
              for v in losses(mt, x, W1, W2, c_feats, s_grams))
    print("style loss %.5f -> %.5f (%.1fx down); content %.5f "
          "(style image itself: %.5f)" % (s0, s1, s0 / max(s1, 1e-12),
                                          c1, c_of_style))
    common.gate(s1 < 0.25 * s0, "style statistics did not move to the target")
    common.gate(c1 < 0.5 * c_of_style, "content was destroyed")
    return {"style_ratio": s1 / s0, "content": c1,
            "content_of_style": c_of_style}


if __name__ == "__main__":
    main()
