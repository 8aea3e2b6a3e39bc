"""AlexNet symbol builder.

The port's copy of the reference package's ``models/alexnet.py``, over
the port's ``symbol``: upstream MXNet's
``example/image-classification/symbols/alexnet.py``, the single-tower
"one weird trick" variant of the perf tables (LRN after the first two
convolutions, dropout 0.5 in the two 4096-wide layers), with the same
node names and parameter shapes."""
from .. import symbol as sym

__all__ = ["get_symbol"]


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, kernel=(11, 11), stride=(4, 4),
                         num_filter=96, name="conv1")
    r1 = sym.Activation(data=c1, act_type="relu", name="relu1")
    n1 = sym.LRN(data=r1, alpha=0.0001, beta=0.75, knorm=2, nsize=5,
                 name="norm1")
    p1 = sym.Pooling(data=n1, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="pool1")
    c2 = sym.Convolution(data=p1, kernel=(5, 5), pad=(2, 2), num_filter=256,
                         name="conv2")
    r2 = sym.Activation(data=c2, act_type="relu", name="relu2")
    n2 = sym.LRN(data=r2, alpha=0.0001, beta=0.75, knorm=2, nsize=5,
                 name="norm2")
    p2 = sym.Pooling(data=n2, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="pool2")
    c3 = sym.Convolution(data=p2, kernel=(3, 3), pad=(1, 1), num_filter=384,
                         name="conv3")
    r3 = sym.Activation(data=c3, act_type="relu", name="relu3")
    c4 = sym.Convolution(data=r3, kernel=(3, 3), pad=(1, 1), num_filter=384,
                         name="conv4")
    r4 = sym.Activation(data=c4, act_type="relu", name="relu4")
    c5 = sym.Convolution(data=r4, kernel=(3, 3), pad=(1, 1), num_filter=256,
                         name="conv5")
    r5 = sym.Activation(data=c5, act_type="relu", name="relu5")
    p3 = sym.Pooling(data=r5, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="pool3")
    f = sym.Flatten(data=p3)
    fc1 = sym.FullyConnected(data=f, num_hidden=4096, name="fc1")
    r6 = sym.Activation(data=fc1, act_type="relu", name="relu6")
    d1 = sym.Dropout(data=r6, p=0.5, name="drop1")
    fc2 = sym.FullyConnected(data=d1, num_hidden=4096, name="fc2")
    r7 = sym.Activation(data=fc2, act_type="relu", name="relu7")
    d2 = sym.Dropout(data=r7, p=0.5, name="drop2")
    fc3 = sym.FullyConnected(data=d2, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(data=fc3, name="softmax")
