"""Always-on counters, gauges and histograms.

The part of the reference package's ``profiler.py`` that the serving
and training paths read: counters (``<name>_compile``, ``<name>_tokens``,
``remat_applied``, ``accum_steps``, ...) with ``counter_delta``,
gauges (queue depth, KV occupancy) and the fixed-bucket histograms
behind the TTFT/TPOT percentiles. Trace spans, the chrome-trace dump
and the flight recorder are not ported yet.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional

__all__ = ["incr_counter", "get_counter", "counters", "counter_delta",
           "set_gauge",
           "get_gauge", "gauges", "Histogram", "histogram"]

_lock = threading.Lock()
_counters: dict = {}
_gauges: dict = {}


# ------------------------------------------------------------- counters

def incr_counter(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def get_counter(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def counters() -> dict:
    """Snapshot of all counters."""
    with _lock:
        return dict(_counters)


class counter_delta(object):
    """Context manager snapshotting the counter table so tests and benches
    can assert on the increments one region produced (``with
    counter_delta() as d: ...; d.get("remat_applied")``) without clearing
    the global registry under concurrent users."""

    def __enter__(self):
        self._snap = counters()
        return self

    def __exit__(self, *exc):
        return False

    def get(self, name: str) -> int:
        return get_counter(name) - self._snap.get(name, 0)

    def all(self) -> dict:
        now = counters()
        return {k: v - self._snap.get(k, 0) for k, v in now.items()
                if v != self._snap.get(k, 0)}


# -------------------------------------------------------------- gauges

def set_gauge(name: str, value: float) -> None:
    with _lock:
        _gauges[name] = value


def get_gauge(name: str, default: float = 0.0) -> float:
    with _lock:
        return _gauges.get(name, default)


def gauges() -> dict:
    """Snapshot of all gauges."""
    with _lock:
        return dict(_gauges)


# ---------------------------------------------------------- histograms
# 96 log-spaced bounds, 1e-5 .. ~1.4e7, factor 2^0.25 apart: a quantile
# estimate lands within one bucket (<= 19%) of the exact order statistic.
_DEFAULT_BOUNDS = tuple(1e-5 * (2.0 ** (i / 4.0)) for i in range(96))


class Histogram(object):
    """Thread-safe fixed-bucket histogram (cumulative since last reset)."""

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_min", "_max",
                 "_hlock")

    def __init__(self, bounds=None):
        self.bounds = tuple(float(b) for b in (bounds or _DEFAULT_BOUNDS))
        if any(a >= b for a, b in zip(self.bounds, self.bounds[1:])):
            raise ValueError("histogram bounds must be strictly increasing")
        # one overflow bucket past the last bound
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._hlock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.bounds, v)
        with self._hlock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    def reset(self) -> None:
        with self._hlock:
            for i in range(len(self._counts)):
                self._counts[i] = 0
            self._sum = 0.0
            self._count = 0
            self._min = None
            self._max = None

    def snapshot(self) -> dict:
        """Consistent copy: {bounds, counts, sum, count, min, max}."""
        with self._hlock:
            return {"bounds": self.bounds, "counts": list(self._counts),
                    "sum": self._sum, "count": self._count,
                    "min": self._min, "max": self._max}


def snapshot_quantile(snap: dict, q: float) -> Optional[float]:
    """Linear interpolation inside the bucket holding the target rank."""
    count = snap["count"]
    if count == 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    target = q * count
    bounds, counts = snap["bounds"], snap["counts"]
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        prev_cum = cum
        cum += c
        if cum >= target:
            lo = bounds[i - 1] if i > 0 else max(
                0.0, snap["min"] if snap["min"] is not None else 0.0)
            hi = bounds[i] if i < len(bounds) else \
                (snap["max"] if snap["max"] is not None else bounds[-1])
            lo = max(lo, snap["min"]) if snap["min"] is not None else lo
            hi = min(hi, snap["max"]) if snap["max"] is not None else hi
            if hi <= lo:
                return lo
            frac = (target - prev_cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return snap["max"]


_histograms: Dict[str, Histogram] = {}


def histogram(name: str, bounds=None) -> Histogram:
    """Get-or-create the registry histogram ``name`` (shared across the
    process, like counters/gauges)."""
    with _lock:
        h = _histograms.get(name)
        if h is None:
            h = Histogram(bounds)
            _histograms[name] = h
        return h
