"""Vision model zoo: the port's copy of the reference's
``gluon/model_zoo/vision/`` — alexnet, densenet, inception-v3, resnet
v1/v2 (18-152), squeezenet, vgg 11-19 (± BN), mobilenet.

``pretrained``: ``True`` (the reference's download from its model
store) raises, as in the reference package; a path loads the weights
from a local file — either package's ``save_params`` output or a binary
``.params`` file (``arg:``/``aux:`` module-checkpoint prefixes are
stripped; see ``_pretrained.py``).
"""
from .alexnet import *
from .densenet import *
from .inception import *
from .resnet import *
from .squeezenet import *
from .vgg import *
from .mobilenet import *

_models = {}


def _register_models():
    import importlib
    mods = [importlib.import_module(__name__ + "." + m)
            for m in ("alexnet", "densenet", "inception", "resnet",
                      "squeezenet", "vgg", "mobilenet")]
    for mod in mods:
        for name in mod.__all__:
            fn = getattr(mod, name)
            if callable(fn) and not name[0].isupper() and \
                    not name.startswith("get_"):
                _models[name] = fn


_register_models()


def get_model(name, pretrained=False, **kwargs):
    """Create a model by name (reference: model_zoo/__init__.py
    get_model). ``pretrained`` may be a checkpoint path/URI — see the
    module docstring."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available: %s"
            % (name, sorted(_models.keys())))
    # factories handle pretrained themselves (vision/_pretrained.py)
    return _models[name](pretrained=pretrained, **kwargs)


__all__ = ["get_model"] + sorted(_models.keys())
