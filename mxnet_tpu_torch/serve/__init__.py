"""Generative serving on the port (counterpart of ``mxnet_tpu.serve``).

``GenerativeServer`` serves the zoo transformer LM with continuous
batching over a preallocated KV cache; its prefill attention runs on
the port's flash-attention kernel. The modules load lazily on first
attribute access, so ``import mxnet_tpu_torch.serve`` stays cheap.
"""
from __future__ import annotations

import importlib

__all__ = ["GenerativeServer", "GenerateHandle", "ServeError",
           "ServerClosed", "QueueFull", "DeadlineExceeded", "KVCache",
           "PageLedger", "DecodeEngine"]

_HOME = {"KVCache": "kv_cache", "PageLedger": "kv_cache",
         "DecodeEngine": "decode"}


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(name)
    mod = importlib.import_module(
        "%s.%s" % (__name__, _HOME.get(name, "server")))
    return getattr(mod, name)
