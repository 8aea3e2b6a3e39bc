"""LeNet symbol builder: the port's copy of the reference package's
``models/lenet.py`` (upstream ``example/image-classification/symbols/
lenet.py``), over the port's ``symbol``."""
from .. import symbol as sym

__all__ = ["get_symbol"]


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    c1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20, name="conv1")
    a1 = sym.Activation(data=c1, act_type="tanh", name="tanh1")
    p1 = sym.Pooling(data=a1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                     name="pool1")
    c2 = sym.Convolution(data=p1, kernel=(5, 5), num_filter=50, name="conv2")
    a2 = sym.Activation(data=c2, act_type="tanh", name="tanh2")
    p2 = sym.Pooling(data=a2, pool_type="max", kernel=(2, 2), stride=(2, 2),
                     name="pool2")
    f = sym.Flatten(data=p2)
    fc1 = sym.FullyConnected(data=f, num_hidden=500, name="fc1")
    a3 = sym.Activation(data=fc1, act_type="tanh", name="tanh3")
    fc2 = sym.FullyConnected(data=a3, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(data=fc2, name="softmax")
