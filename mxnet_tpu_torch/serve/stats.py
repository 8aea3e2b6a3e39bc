"""Serving observability: latency distributions.

A copy of the reference package's ``serve/stats.py``. Latencies land in
the shared bounded histogram primitive (:class:`..profiler.Histogram`:
fixed log-spaced buckets, factor ``2^0.25``, so a quantile estimate
stays within one bucket, <= 19%, of the exact order statistic). Memory
is O(buckets) at any request volume; same-name servers aggregate, like
the ``<name>_*`` serve counters. Percentiles are computed on snapshot,
not on record.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from .. import profiler as _profiler

__all__ = ["LatencyStats", "DecodeLatencyStats", "monotonic"]


class LatencyStats:
    """Thread-safe latency distribution (seconds) over the shared
    registry histogram ``name``."""

    def __init__(self, name: str = "serve_latency_seconds"):
        self.name = name
        self._hist = _profiler.histogram(name)

    def record(self, seconds: float) -> None:
        self._hist.observe(seconds)

    @property
    def count(self) -> int:
        return self._hist.count

    def reset(self) -> None:
        """Drop the retained distribution (e.g. after warmup, so
        first-call latencies don't pollute steady-state percentiles)."""
        self._hist.reset()

    def snapshot(self) -> Optional[Dict[str, float]]:
        """{p50, p95, p99, mean, max, window} in milliseconds since the
        last reset; None before the first request."""
        snap = self._hist.snapshot()
        n = snap["count"]
        if n == 0:
            return None
        p50, p95, p99 = (_profiler.snapshot_quantile(snap, q)
                         for q in (0.50, 0.95, 0.99))
        return {
            "p50_ms": round(float(p50) * 1e3, 4),
            "p95_ms": round(float(p95) * 1e3, 4),
            "p99_ms": round(float(p99) * 1e3, 4),
            "mean_ms": round(snap["sum"] / n * 1e3, 4),
            "max_ms": round(float(snap["max"]) * 1e3, 4),
            "window": int(n),
        }


class DecodeLatencyStats:
    """The generative-serving latency pair: time-to-first-token and
    time-per-output-token, each a :class:`LatencyStats` over its own
    registry histogram (``<name>_ttft_seconds`` / ``<name>_tpot_seconds``).

    TTFT spans submit → first streamed token (queueing + prefill + first
    sample); TPOT is the inter-token gap inside steady-state decode.
    """

    def __init__(self, name: str = "serve"):
        self.name = name
        self.ttft = LatencyStats(name=name + "_ttft_seconds")
        self.tpot = LatencyStats(name=name + "_tpot_seconds")

    def reset(self) -> None:
        self.ttft.reset()
        self.tpot.reset()

    def snapshot(self) -> Dict[str, Optional[Dict[str, float]]]:
        return {"ttft": self.ttft.snapshot(), "tpot": self.tpot.snapshot()}


def monotonic() -> float:
    """The one clock every serve timestamp uses (monotonic: deadlines
    must survive wall-clock steps)."""
    return time.monotonic()
