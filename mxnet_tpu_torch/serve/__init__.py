"""``mt.serve`` — dynamic-batching and generative serving on the port
(counterpart of ``mxnet_tpu.serve``).

    server = mt.serve.InferenceServer(predictor, max_batch_size=32)
    futures = [server.submit(x) for x in requests]
    results = [f.result() for f in futures]
    server.stats()   # p50/p95/p99, occupancy, per-bucket runners
    server.close()   # graceful drain

Generative decode (continuous batching over a preallocated bucketed KV
cache, f32 or int8 — :mod:`.kv_cache` / :mod:`.decode`; prefill
attention on the port's flash-attention kernel):

    gen = mt.serve.GenerativeServer(module, n_heads=16)
    handle = gen.submit_generate(prompt_ids, max_new_tokens=64)
    for tok in handle:      # per-token streaming
        ...

Kill switch: ``MXNET_TPU_SERVE=0`` degrades every ``submit`` to an eager
per-request forward in the caller thread.

Zero-cost gate: importing this package does NOT import the decode path
(:mod:`.kv_cache` / :mod:`.decode`): those load on the first
``GenerativeServer`` construction or attribute access below.
"""
from .bucketing import BucketSpec, decode_buckets
from .server import (DeadlineExceeded, GenerateHandle, GenerativeServer,
                     InferenceServer, QueueFull, ServeError, ServerClosed,
                     wrap_model)
from .stats import DecodeLatencyStats, LatencyStats

__all__ = [
    "InferenceServer", "GenerativeServer", "GenerateHandle", "BucketSpec",
    "decode_buckets", "LatencyStats", "DecodeLatencyStats", "wrap_model",
    "ServeError", "ServerClosed", "QueueFull", "DeadlineExceeded",
    "KVCache", "PageLedger", "max_slots_for", "DecodeEngine",
]

# lazy decode-path exports: module-level __getattr__ keeps kv_cache /
# decode unimported until someone reaches for them
_LAZY = {
    "KVCache": ("kv_cache", "KVCache"),
    "PageLedger": ("kv_cache", "PageLedger"),
    "CacheFull": ("kv_cache", "CacheFull"),
    "max_slots_for": ("kv_cache", "max_slots_for"),
    "DecodeEngine": ("decode", "DecodeEngine"),
    "DecodeConfig": ("decode", "DecodeConfig"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module("." + mod, __name__), attr)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
