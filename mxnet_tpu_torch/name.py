"""Automatic symbol naming and scoped symbol attributes.

The port's copy of the reference's ``name.py``: ``NameManager`` (per
op-type counters, ``fullyconnected0``), its ``Prefix`` variant, and
``AttrScope``, which attaches attributes such as ``ctx_group`` or
``__lr_mult__`` to every symbol created inside it (the model-parallel
placement of ``simple_bind(group2ctx=)``). One thread-local holds the
current manager and scope.

A name is resolved once per node, so ``with Prefix("p_"):`` names the
node ``p_fc`` and its weight ``p_fc_weight``, as upstream MXNet does.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["NameManager", "Prefix", "AttrScope", "current_name_manager",
           "current_attr_scope"]

_local = threading.local()


class NameManager:
    """Per-op-type counter naming: ``fullyconnected0``, ``conv1``, ..."""

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old: Optional[NameManager] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        hint = hint.lower()
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        self._old = current_name_manager()
        _local.name_manager = self
        return self

    def __exit__(self, *exc):
        _local.name_manager = self._old


class Prefix(NameManager):
    """Prepends a fixed prefix to every name it resolves."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current_name_manager() -> NameManager:
    nm = getattr(_local, "name_manager", None)
    if nm is None:
        nm = NameManager()
        _local.name_manager = nm
    return nm


class AttrScope:
    """``with AttrScope(ctx_group="dev1"):`` attaches the attributes to
    every symbol created inside the block; nested scopes merge, the
    inner one winning."""

    def __init__(self, **kwargs):
        self._attrs = {k: str(v) for k, v in kwargs.items()}
        self._old = None

    @property
    def attrs(self) -> Dict[str, str]:
        return dict(self._attrs)

    def get(self, user_attrs: Optional[Dict[str, str]]) -> Dict[str, str]:
        """The scope's attributes, updated by ``user_attrs``."""
        out = dict(self._attrs)
        if user_attrs:
            out.update(user_attrs)
        return out

    def __enter__(self):
        parent = current_attr_scope()
        merged = dict(parent._attrs) if parent else {}
        merged.update(self._attrs)
        self._old = parent
        self._attrs = merged
        _local.attr_scope = self
        return self

    def __exit__(self, *exc):
        _local.attr_scope = self._old


def current_attr_scope() -> Optional[AttrScope]:
    return getattr(_local, "attr_scope", None)
