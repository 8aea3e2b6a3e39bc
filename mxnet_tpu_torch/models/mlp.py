"""MLP symbol builder: the port's copy of the reference package's
``models/mlp.py`` (upstream ``example/image-classification/symbols/
mlp.py``), over the port's ``symbol``."""
from .. import symbol as sym

__all__ = ["get_symbol"]


def get_symbol(num_classes=10, hidden=(128, 64), **kwargs):
    data = sym.Variable("data")
    net = sym.Flatten(data=data)
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(data=net, num_hidden=h, name="fc%d" % (i + 1))
        net = sym.Activation(data=net, act_type="relu", name="relu%d" % (i + 1))
    net = sym.FullyConnected(data=net, num_hidden=num_classes,
                             name="fc%d" % (len(hidden) + 1))
    return sym.SoftmaxOutput(data=net, name="softmax")
