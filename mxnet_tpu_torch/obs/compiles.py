"""Always-on compile accounting: who built what, and how long it took.

The port's counterpart of the reference package's ``obs/compiles.py``.
The reference's event source is ``jax.monitoring`` (trace / lower /
backend-compile durations, fired on the compiling thread); the port has
no compiler of whole programs, so its records come from the points where
it really builds something, each of which calls :func:`record` on the
building thread:

* ``_build.build``: ``nvcc`` of a kernel library (``source`` "nvcc");
* ``_build.build_cubin``: ``nvcc -cubin`` of a user kernel ("nvcc-cubin");
* ``native.build``: ``g++`` of the data pipeline ("g++");
* an ``Executor``'s graph function and scan plan ("graph": ``trace_ms``);
* a serve runner's first bind, the one that counts ``<name>_compile``
  ("runner": its first call's host time);
* ``Predictor.export`` ("export": ``trace_ms`` the graph function,
  ``compile_ms`` the ``torch.export`` wall time).

A build that was already on disk (an up-to-date library or cubin) is a
load, not a build, and is not recorded. ``lower_ms`` is 0 in every
record. The build sites import this module when they build, so a build
that runs before anything imported :mod:`mxnet_tpu_torch.obs` still
lands in the ring.

Each record is attributed to whatever :class:`scope` the building thread
has open (the fused train step, an executor, a serve bucket), or None,
and lands in a bounded ring (``mt.obs.report()["compiles"]``) with the
always-on aggregates:

* counter ``obs_compile_count`` — records made;
* histograms ``obs_bind_ms`` (trace + lower + compile per record) and
  ``obs_trace_ms`` (trace alone);
* counters ``obs_bind_ms_total`` / ``obs_trace_ms_total`` /
  ``obs_compile_ms_total`` — integer-ms totals for rate math.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from .. import lockcheck as _lockcheck
from .. import profiler as _profiler

__all__ = ["scope", "record", "snapshot", "native_builds", "RING_CAPACITY",
           "NATIVE_SOURCES"]

RING_CAPACITY = 256
# the ring's sources of a native build: a kernel library, a user
# kernel's cubin, the data pipeline's library
NATIVE_SOURCES = ("nvcc", "nvcc-cubin", "g++")

_ring: "collections.deque[Dict[str, Any]]" = \
    collections.deque(maxlen=RING_CAPACITY)
_ring_lock = _lockcheck.Lock(name="obs.compiles.ring_lock")
_tls = threading.local()
# t_offset_s counts from the profiler's tick 0, the trace's time origin
_t0 = _profiler._t0


class scope(object):
    """Attribute builds made inside the ``with`` body to ``(name,
    signature)``. Nestable (innermost wins); costs two thread-local
    writes, so hot paths keep it open around every dispatch rather than
    trying to predict which call will build."""

    __slots__ = ("name", "signature", "_prev")

    def __init__(self, name: str, signature: Any = None):
        self.name = name
        self.signature = signature

    def __enter__(self):
        self._prev = getattr(_tls, "scope", None)
        _tls.scope = (self.name, self.signature)
        return self

    def __exit__(self, *exc):
        _tls.scope = self._prev
        return False


def _sig_str(sig: Any) -> Optional[str]:
    if sig is None:
        return None
    s = repr(sig)
    return s if len(s) <= 512 else s[:509] + "..."


def record(compile_ms: float, trace_ms: float = 0.0,
           source: Optional[str] = None) -> Dict[str, Any]:
    """One build, made on the calling thread under its open scope:
    append it to the ring and feed the aggregates. Returns the record."""
    sc = getattr(_tls, "scope", None)
    trace_ms = float(trace_ms)
    compile_ms = float(compile_ms)
    bind_ms = trace_ms + compile_ms
    rec = {
        "scope": sc[0] if sc else None,
        "signature": _sig_str(sc[1]) if sc else None,
        "source": source,
        "trace_ms": round(trace_ms, 3),
        "lower_ms": 0.0,
        "compile_ms": round(compile_ms, 3),
        "bind_ms": round(bind_ms, 3),
        "t_offset_s": round(time.perf_counter() - _t0, 3),
        "thread": threading.current_thread().name,
    }
    with _ring_lock:
        _ring.append(rec)
    _profiler.incr_counter("obs_compile_count")
    _profiler.incr_counter("obs_trace_ms_total", int(trace_ms))
    _profiler.incr_counter("obs_compile_ms_total", int(compile_ms))
    _profiler.incr_counter("obs_bind_ms_total", int(bind_ms))
    _profiler.observe("obs_bind_ms", bind_ms)
    _profiler.observe("obs_trace_ms", trace_ms)
    return rec


def snapshot() -> List[Dict[str, Any]]:
    """The compile ring, oldest first (bounded at RING_CAPACITY)."""
    with _ring_lock:
        return list(_ring)


def native_builds() -> int:
    """Native builds this process made (0 when every library loaded
    from the build directory)."""
    return sum(1 for c in snapshot() if c.get("source") in NATIVE_SOURCES)
