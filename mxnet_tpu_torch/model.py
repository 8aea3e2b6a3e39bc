"""Checkpoint files of a trained model: the symbol and its parameters.

The port's counterpart of the reference's ``model.py``
``save_checkpoint`` / ``load_checkpoint``, with its files:
``prefix-symbol.json`` (the symbol JSON) and ``prefix-%04d.params``
(the arg and aux params under ``arg:<name>`` and ``aux:<name>``, in
:func:`ndarray.save`'s npz archive; ``load_checkpoint`` also reads
MXNet's binary ``.params`` format). A checkpoint either package writes
loads in the other.
"""
from __future__ import annotations

import logging
from typing import Dict

from . import ndarray as nd
from . import symbol as sym
from .ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix: str, epoch: int, symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray]) -> None:
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix: str, epoch: int):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays
    on the current device (``device_scope``; else ``cuda:0``)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        kind, name = k.split(":", 1)
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
