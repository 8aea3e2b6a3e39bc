"""CNN text classification (Kim 2014) through the Module API.

A copy of the reference's ``examples/cnn_text_classification.py`` on
the port: embedding, parallel convolutions over windows of 3, 4 and 5
tokens, max-over-time pooling, concat, dropout and softmax, trained by
``Module.fit`` on a synthetic corpus where each class plants one of its
signature trigrams in noise.

Run:  python -m mxnet_tpu_torch.examples.cnn_text_classification
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.examples import common

VOCAB, NCLASS, SEQ = 60, 4, 24


def synth_corpus(n, seed=0):
    """Each class plants one of its two signature trigrams somewhere in a
    noise sequence."""
    rng = np.random.RandomState(seed)
    sigs = {c: [(10 + 3 * c + np.arange(3)) % VOCAB,
                (30 + 3 * c + np.arange(3)) % VOCAB]
            for c in range(NCLASS)}
    x = rng.randint(0, VOCAB, (n, SEQ))
    y = rng.randint(0, NCLASS, n)
    for i in range(n):
        pos = rng.randint(0, SEQ - 2)   # inclusive last start SEQ-3
        x[i, pos:pos + 3] = sigs[y[i]][rng.randint(2)]
    return x.astype(np.float32), y.astype(np.float32)


def get_symbol(num_embed=32, num_filter=32, dropout=0.3):
    data = mt.sym.Variable("data")                     # (N, SEQ)
    emb = mt.sym.Embedding(data, mt.sym.Variable("embed_weight"),
                           input_dim=VOCAB, output_dim=num_embed,
                           name="embed")               # (N, SEQ, E)
    emb = mt.sym.reshape(emb, (-1, 1, SEQ, num_embed))  # NCHW
    pooled = []
    for ws in (3, 4, 5):
        c = mt.sym.Convolution(emb, kernel=(ws, num_embed),
                               num_filter=num_filter,
                               name="conv%d" % ws)     # (N, F, SEQ-ws+1, 1)
        c = mt.sym.Activation(c, act_type="relu")
        c = mt.sym.Pooling(c, kernel=(SEQ - ws + 1, 1), pool_type="max",
                           name="pool%d" % ws)         # (N, F, 1, 1)
        pooled.append(c)
    h = mt.sym.Concat(*pooled)                         # (N, 3F, 1, 1)
    h = mt.sym.Flatten(h)
    h = mt.sym.Dropout(h, p=dropout)
    fc = mt.sym.FullyConnected(h, num_hidden=NCLASS, name="fc")
    return mt.sym.SoftmaxOutput(fc, name="softmax")


def main(argv=None):
    p = argparse.ArgumentParser(description="Kim-CNN text classification")
    p.add_argument("--num-epochs", type=int, default=6)
    p.add_argument("--num-examples", type=int, default=1200)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args(argv)
    np.random.seed(args.seed)

    x, y = synth_corpus(args.num_examples)
    n_val = args.num_examples // 6
    train = mt.io.NDArrayIter(x[n_val:], y[n_val:],
                              batch_size=args.batch_size, shuffle=True)
    val = mt.io.NDArrayIter(x[:n_val], y[:n_val],
                            batch_size=args.batch_size)

    mod = mt.mod.Module(get_symbol(), context=mt.current_context())
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            initializer=mt.init.Xavier(), eval_metric="acc",
            num_epoch=args.num_epochs)
    val.reset()
    score = mod.score(val, "acc")[0][1]
    print("final validation accuracy: %.4f (chance %.2f)"
          % (score, 1.0 / NCLASS))
    common.gate(score > 0.7, "text CNN failed to find the signature trigrams")
    return {"accuracy": float(score)}


if __name__ == "__main__":
    main()
