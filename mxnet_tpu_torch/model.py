"""Checkpoint files of a trained model: the symbol and its parameters.

The port's counterpart of the reference's ``model.py``
``save_checkpoint`` / ``load_checkpoint``, with its files:
``prefix-symbol.json`` (the symbol JSON) and ``prefix-%04d.params``
(the arg and aux params under ``arg:<name>`` and ``aux:<name>``, in
:func:`ndarray.save`'s npz archive; ``load_checkpoint`` also reads
MXNet's binary ``.params`` format). A checkpoint either package writes
loads in the other. ``_create_kvstore`` is the reference's decision of
a store and of ``update_on_kvstore``, which ``Module`` and
``gluon.Trainer`` make.
"""
from __future__ import annotations

import logging
from typing import Dict

from . import ndarray as nd
from . import symbol as sym
from .ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]


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


def _create_kvstore(kvstore, num_device: int, arg_params):
    """``(store or None, update_on_kvstore)`` for ``kvstore`` (a
    :class:`..kvstore.KVStore`, a name or None) over ``num_device``
    devices: a store object is used as given and updates on the store;
    a name on one device without ``dist`` gives no store; ``"local"``
    over several devices updates on the store only when some parameter
    holds 16M elements or more."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(arr.size) for arr in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


from .callback import BatchEndParam  # noqa: E402  (the reference re-exports it)
