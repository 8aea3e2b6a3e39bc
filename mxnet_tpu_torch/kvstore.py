"""KVStore: the parameter store that Module and gluon.Trainer push
gradients to and pull weights from.

The port's counterpart of the reference's ``kvstore.py``, for one
process: ``init`` stores a copy of each key's value, ``push`` sums a
list of per-device values onto the first value's device and runs the
updater on the stored weight (or adds into it when no updater is set),
``pull`` copies the stored value into every out array.
``set_optimizer`` installs an :class:`..optimizer.Updater`, whose
``get_states`` bytes are the optimizer-state file; a file either
package writes loads in the other.

``create`` takes the reference's names. Every name containing ``dist``
raises, naming ROADMAP.md queue A9, whatever the environment (the
reference raises only when no cluster is set up): the multi-process
store is not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError
from .checkpoint.atomic import atomic_open
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_VALID = ("local", "local_allreduce_cpu", "local_update_cpu", "device",
          "dist_sync", "dist_dev_sync", "dist_device_sync", "dist_async",
          "dist")


def _key_list(key):
    single = not isinstance(key, (list, tuple))
    return ([key] if single else list(key)), single


def _val_list(value, n_keys):
    """Per key, the list of its per-device values."""
    if not isinstance(value, (list, tuple)):
        value = [value]
    if n_keys == 1 and all(isinstance(v, NDArray) for v in value):
        return [list(value)]
    return [list(v) if isinstance(v, (list, tuple)) else [v] for v in value]


class KVStore(object):
    """A one-process store of ``type`` ``kind``."""

    def __init__(self, kind: str):
        self._kind = kind
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._updater_obj: Optional[opt.Updater] = None

    @property
    def type(self) -> str:
        return self._kind

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        """Wait for the device work queued so far."""
        nd.waitall()

    def init(self, key, value):
        """Store a copy of each key's (first) value, once per key."""
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = vlist[0].copy()

    @staticmethod
    def _local_reduce(vlist) -> torch.Tensor:
        """The sum of the values, in order, on the first one's device."""
        acc = vlist[0].data
        for v in vlist[1:]:
            acc = acc + v.data.to(acc.device)
        return acc

    def push(self, key, value, priority: int = 0):
        """Sum each key's values and run the updater on the stored
        weight with the sum, or add the sum into it without one."""
        keys, _ = _key_list(key)
        for k, vlist in zip(keys, _val_list(value, len(keys))):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            merged = vlist[0] if len(vlist) == 1 \
                else NDArray(self._local_reduce(vlist))
            if self._updater is not None:
                self._updater(k, merged, self._store[k])
            else:
                stored = self._store[k]
                stored._commit(stored.data + merged.data)

    def pull(self, key, out=None, priority: int = 0):
        """Copy each key's stored value into every one of its out
        arrays."""
        if out is None:
            raise MXNetError("pull needs out arrays")
        keys, _ = _key_list(key)
        if len(keys) == 1:
            outs = [[out] if isinstance(out, NDArray) else list(out)]
        else:
            outs = [[o] if isinstance(o, NDArray) else list(o) for o in out]
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r not initialized" % (k,))
            for o in olist:
                self._store[k].copyto(o)

    def set_updater(self, updater: Callable):
        """Run ``updater(key, merged, stored)`` on every push."""
        self._updater = updater

    def set_optimizer(self, optimizer: opt.Optimizer):
        """Run ``optimizer`` on every push, through an Updater whose
        states :meth:`save_optimizer_states` writes."""
        self._updater_obj = opt.get_updater(optimizer)
        self._updater = self._updater_obj

    def save_optimizer_states(self, fname: str):
        if self._updater_obj is None:
            raise MXNetError("the store has no optimizer (set_optimizer) "
                             "whose states could be saved")
        with atomic_open(fname, "wb") as fout:
            fout.write(self._updater_obj.get_states())

    def load_optimizer_states(self, fname: str):
        if self._updater_obj is None:
            raise MXNetError("the store has no optimizer (set_optimizer) "
                             "to load states into")
        with open(fname, "rb") as fin:
            self._updater_obj.set_states(fin.read())

    # one process has no servers or scheduler: the cluster calls answer
    # for a lone worker
    def send_command_to_servers(self, head: int, body: str):
        pass

    def get_num_dead_node(self, node_id: int, timeout: int = 0) -> int:
        return 0

    @staticmethod
    def is_worker_node() -> bool:
        return True

    @staticmethod
    def is_server_node() -> bool:
        return False

    @staticmethod
    def is_scheduler_node() -> bool:
        return False


def create(name: str = "local") -> KVStore:
    """A store of type ``name``: one of the reference's names; a
    ``dist`` name raises (ROADMAP.md queue A9)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _VALID:
        raise MXNetError("Unknown KVStore type %r" % name)
    if "dist" in name:
        raise MXNetError(
            "kvstore %r is distributed: the multi-process store is "
            "ROADMAP.md queue A9; on one device use 'local' or 'device'"
            % name)
    return KVStore(name)
