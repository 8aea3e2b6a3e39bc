"""Symbol-level model definitions, the port's copies of the reference
package's ``models/``: ResNet, the zoo decoder LM, and the perf-table
image nets (MLP, LeNet, AlexNet, VGG, Inception-BN and Inception-v3).
They build ``mt.sym`` graphs for ``mt.mod.Module``.
"""
from . import alexnet, inception, lenet, mlp, resnet, vgg
from .resnet import get_symbol as get_resnet

__all__ = ["resnet", "mlp", "lenet", "alexnet", "vgg", "inception",
           "get_resnet"]
