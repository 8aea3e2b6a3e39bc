"""The environment-variable knob layer, for the knobs the port reads.

The port's own copy of the reference package's ``config.py``: the same
``register``/``get``/``set``/``reset``/``on_change`` surface, and the
same names and defaults for the knobs this package reads — the
``MXNET_TPU_SERVE_*`` knobs that ``GenerativeServer`` and ``KVCache``
consult, ``MXNET_TPU_LOCKCHECK`` and ``MXNET_TPU_FAULTS`` read by
the copies of ``lockcheck.py`` and ``faults.py``, and the
``MXNET_TPU_CKPT_*`` knobs of :mod:`.checkpoint`. Knobs of features the
port does not have yet (the batch ``InferenceServer``, int8 KV) arrive
with those features.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict

__all__ = ["get", "set", "reset", "register", "on_change", "KNOBS"]


class _Knob:
    def __init__(self, name: str, typ: Callable, default: Any, doc: str):
        self.name = name
        self.typ = typ
        self.default = default
        self.doc = doc


KNOBS: Dict[str, _Knob] = {}
_overrides: Dict[str, Any] = {}
_listeners: Dict[str, list] = {}


def register(name: str, typ, default, doc: str) -> None:
    KNOBS[name] = _Knob(name, typ, default, doc)


def on_change(name: str, fn: Callable[[Any], None]) -> None:
    """Call ``fn(new_value)`` whenever ``set``/``reset`` changes the knob."""
    KNOBS[name]   # raise on unknown
    _listeners.setdefault(name, []).append(fn)


def _notify(name: str) -> None:
    for fn in _listeners.get(name, ()):
        fn(get(name))


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def _parse_lockcheck(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "off", "false", "no", "none"):
        return "off"
    if s in ("warn", "warning", "1", "on", "true", "yes"):
        return "warn"
    if s == "abort":
        return "abort"
    raise ValueError(
        "MXNET_TPU_LOCKCHECK must be off|warn|abort, got %r" % (v,))


register("MXNET_TPU_SERVE_QUEUE_BOUND", int, 1024,
         "serve: default admission bound; submit_generate() load-sheds "
         "(QueueFull) when this many requests are already queued")
register("MXNET_TPU_SERVE_MAX_SEQUENCES", int, 8,
         "serve.GenerativeServer: default max resident decode sequences "
         "(the KV cache's preallocated slot count; also the decode "
         "batch width). Overridden by the max_sequences argument")
register("MXNET_TPU_SERVE_PREFILL_TOKENS", int, 2048,
         "serve.GenerativeServer: prefill token budget per scheduler "
         "iteration — joins admitted between two decode steps may "
         "prefill at most this many (bucket-padded) prompt tokens")
register("MXNET_TPU_SERVE_DECODE_BUCKETS", str, "",
         "serve.GenerativeServer: explicit comma-separated decode "
         "sequence-length bucket ladder (e.g. '128,256,512'); empty = "
         "powers of two from the page size up to the model's max "
         "sequence length. Every bucket must be a multiple of the KV "
         "page size")
register("MXNET_TPU_SERVE_KV_PAGE", int, 16,
         "serve.GenerativeServer: KV-cache page size in tokens — slot "
         "capacity is accounted page-at-a-time. Must divide every "
         "decode bucket")
register("MXNET_TPU_FAULTS", str, "",
         "deterministic fault injection: comma list of "
         "<site>@<nth>[:kind] specs fired at named injection points "
         "(serve.submit, serve.decode, serve.evict, ...). Parsed once "
         "at import by mxnet_tpu_torch.faults; zero-cost when empty. "
         "NEVER set in production")
register("MXNET_TPU_LOCKCHECK", _parse_lockcheck, "off",
         "runtime lock witness: wrap locks created through the "
         "lockcheck funnels to record acquisition order and flag the "
         "first observed lock-order inversion. warn = log, abort = "
         "raise MXNetError before the inversion's blocking acquire; "
         "off = plain threading primitives")

register("MXNET_TPU_CKPT_ASYNC", _parse_bool, True,
         "checkpoint: hand checkpoint serialization (device fetch, "
         "checksums, npz encode, fsync) to the bounded background writer "
         "thread so the step loop resumes after snapshot capture; 0 = "
         "synchronous saves that block the caller for the full write")
register("MXNET_TPU_CKPT_KEEP", int, 5,
         "checkpoint: retention — keep the newest N valid checkpoints "
         "after each save (keep-every-K survivors and the newest valid "
         "checkpoint are always kept); 0 = keep everything")
register("MXNET_TPU_CKPT_WRITE_RETRIES", int, 3,
         "checkpoint: bounded retry of a failed checkpoint write on "
         "TRANSIENT IO errors (EIO/ENOSPC/EINTR) with exponential "
         "backoff before the failure is recorded and re-raised at "
         "close; each retry counts ckpt_write_retry. 0 = fail on the "
         "first error")


def get(name: str):
    """Current value: runtime override > environment > default."""
    knob = KNOBS[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    return knob.typ(raw)


def set(name: str, value) -> None:     # noqa: A001 (reference-style name)
    """Runtime override (takes precedence over the environment)."""
    knob = KNOBS[name]
    _overrides[name] = knob.typ(value)
    _notify(name)


def reset(name: str) -> None:
    """Drop a runtime override, reverting to environment/default."""
    _overrides.pop(name, None)
    _notify(name)
