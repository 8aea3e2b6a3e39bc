"""``mt.profiler`` — execution tracing, counters/gauges/histograms, spans.

The port's counterpart of the reference package's ``profiler.py``, with
its names, counters and chrome-trace schema, so one dashboard or trace
viewer reads both packages. Four layers:

* A framework-level event recorder: while the state is ``run``, every
  imperative op dispatch (``nd.<op>``) and every executor forward +
  backward logs a chrome-trace complete event. The op is waited on
  before its event closes (a CUDA stream sync on the card), so the
  duration is device time, as the reference's sync-dispatch profiling
  mode. ``dump()`` writes ``{"traceEvents": [...]}`` for
  chrome://tracing / Perfetto.
* Structured **spans** with stable per-thread **lanes** and chrome-trace
  **flow events**: subsystems wrap their pipeline stages in
  ``span(name, flow=batch_id)`` so one batch's journey (prefetch →
  device-place → step dispatch → metric) or one request's (serve:
  submit → coalesce → launch → resolve) renders as connected slices
  across threads. Spans are recorded while the profiler runs OR while
  the ``MXNET_TPU_OBS`` knob is on — otherwise ``span()`` returns a
  shared no-op and allocates nothing (the ``obs_spans`` counter holds
  that). A span times the host: on the card it covers the dispatch of
  the work it wraps, not the work itself.
* The device trace: ``start_xla_trace(logdir)`` / ``stop_xla_trace()``
  keep the reference's names and run a ``torch.profiler`` trace of the
  host and the card (CUPTI), written as a chrome trace into ``logdir``.
  CUPTI may drop kernel records from such a trace.
* Counters/gauges/histograms: always-on, string-keyed, thread-safe —
  used by subsystems to make their hot-path invariants assertable and
  exported in Prometheus text format by :mod:`mxnet_tpu_torch.obs`.

Concurrency contract: every mutation of module state (``_state``,
``_filename``, events, counters, gauges, lanes, flow table) happens under
``_lock``. The hot paths read two cached module booleans (``_tracing``,
``_spans_on``) WITHOUT the lock as an early-out — a benign race whose
worst case is one event recorded just after ``set_state("stop")`` or one
skipped just after ``set_state("run")``; the authoritative append is
under the lock, so the event list and the dumped payload are always
consistent.
"""
from __future__ import annotations

import bisect
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

from . import config as _config

__all__ = [
    "profiler_set_config", "profiler_set_state", "dump_profile",
    "set_config", "set_state", "dump", "pause", "resume",
    "start_xla_trace", "stop_xla_trace", "record_event", "state",
    "incr_counter", "get_counter", "counters", "reset_counters",
    "counter_delta",
    "set_gauge", "get_gauge", "gauges", "reset_gauges",
    "span", "record_span", "spans_enabled", "new_flow",
    "register_thread_lane", "set_span_listener", "blackbox",
    "Histogram", "histogram", "observe", "histograms", "reset_histograms",
    "snapshot_quantile", "record",
]

_lock = threading.Lock()
_state = "stop"
_filename = "profile.json"
_events: List[dict] = []
_counters: dict = {}
_t0 = time.perf_counter()

# bound the in-memory trace: a long obs-on run must not grow without
# limit; overflow is counted so a truncated dump is detectable
_MAX_EVENTS = 1 << 20

# cached fast-path flags (see the concurrency contract above)
_tracing = False
_spans_on = False


def _recompute_enabled_locked() -> None:
    """Refresh the cached fast-path flags; caller holds ``_lock``."""
    global _tracing, _spans_on
    _tracing = _state == "run"
    _spans_on = _tracing or bool(_config.get("MXNET_TPU_OBS"))


def state() -> str:
    return _state


def set_config(filename: str = "profile.json", profile_all: bool = True,
               **_ignored) -> None:
    """Where :func:`dump` writes (the reference's mode knobs beyond the
    filename collapse: there is no per-subsystem engine)."""
    global _filename
    with _lock:
        _filename = filename


def set_state(st: str = "stop") -> None:
    """'run' starts recording, 'stop' stops."""
    global _state
    if st not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop', got %r"
                         % (st,))
    with _lock:
        _state = st
        _recompute_enabled_locked()


def pause() -> None:
    set_state("stop")


def resume() -> None:
    set_state("run")


# --------------------------------------------------------------- lanes
# A lane is one timeline track in the trace (a chrome ``tid``). Usually a
# lane IS a thread (auto-registered under the thread's name on first
# event), but a pipeline stage that shares a thread may claim its own
# named lane (``span(..., lane="place")``) so its slices render on a
# separate track. Lane ids are small registered integers, stable across
# dumps within one process.

_lanes: Dict[str, int] = {}            # lane name -> small stable id
_lane_counter = itertools.count(1)
_tls = threading.local()


def _lane_id_locked(name: str) -> int:
    lid = _lanes.get(name)
    if lid is None:
        lid = next(_lane_counter)
        _lanes[name] = lid
    return lid


def register_thread_lane(name: Optional[str] = None) -> int:
    """Name the calling thread's trace lane (defaults to the thread
    name); returns the stable lane id. Subsequent events from this thread
    land on that lane. Re-registering under a new name moves the thread
    to the (possibly fresh) lane."""
    if name is None:
        name = threading.current_thread().name
    with _lock:
        lid = _lane_id_locked(str(name))
    _tls.lane = lid
    return lid


def _current_lane_locked() -> int:
    lid = getattr(_tls, "lane", None)
    if lid is None:
        lid = _lane_id_locked(threading.current_thread().name)
        _tls.lane = lid
    return lid


# --------------------------------------------------------------- flows
# A flow id threads one logical unit of work (a batch, a request) through
# spans on different lanes; the dump carries chrome flow events ("s"
# start / "t" step) that Perfetto renders as arrows between the slices.

_flow_counter = itertools.count(1)
_flows_seen: Dict[int, bool] = {}
_MAX_FLOWS = 8192


def new_flow() -> int:
    """Allocate a process-unique flow id (cheap, lock-free)."""
    return next(_flow_counter)


def _flow_event_locked(fid: int, ts_us: float, lane: int) -> dict:
    if fid in _flows_seen:
        ph = "t"
    else:
        ph = "s"
        if len(_flows_seen) >= _MAX_FLOWS:
            # drop the oldest half: a stale flow re-appearing emits a
            # fresh "s" (one dangling arrow start, not a crash)
            for k in list(_flows_seen)[:_MAX_FLOWS // 2]:
                _flows_seen.pop(k, None)
        _flows_seen[fid] = True
    return {"name": "batch", "cat": "flow", "ph": ph, "id": int(fid),
            "ts": ts_us, "pid": 0, "tid": lane, "bp": "e"}


def record_event(name: str, t_start: float, t_end: float,
                 category: str = "op", flow: Optional[int] = None,
                 lane: Optional[str] = None) -> None:
    """Append one chrome-trace complete event (timestamps from
    ``time.perf_counter()``). Recorded while the profiler state is
    ``run`` (op/graph events); span events come in through :func:`span`,
    which also records under ``MXNET_TPU_OBS``."""
    if not _tracing:
        return
    _append_event(name, t_start, t_end, category, flow, lane)


def _append_event(name, t_start, t_end, category, flow, lane,
                  count_span: bool = False) -> None:
    listener = _span_listener
    if listener is not None and count_span:
        # outside _lock: the listener (flight recorder) may snapshot the
        # counter table, which takes this module's lock itself
        try:
            listener(name, t_start, t_end, category, lane)
        except Exception:                                  # noqa: BLE001
            pass
    with _lock:
        # authoritative re-check under the lock: a concurrent
        # set_state("stop") + dump() must not observe a half-recorded
        # tail growing behind the serialized payload
        if not (_tracing or (count_span and _spans_on)):
            return
        if len(_events) >= _MAX_EVENTS:
            _counters["profiler_events_dropped"] = \
                _counters.get("profiler_events_dropped", 0) + 1
            return
        lid = _lane_id_locked(lane) if lane is not None \
            else _current_lane_locked()
        ts = (t_start - _t0) * 1e6
        ev = {"name": name, "cat": category, "ph": "X", "ts": ts,
              "dur": (t_end - t_start) * 1e6, "pid": 0, "tid": lid}
        if flow is not None:
            ev["args"] = {"flow": int(flow)}
        _events.append(ev)
        if flow is not None:
            _events.append(_flow_event_locked(int(flow), ts, lid))
        if count_span:
            _counters["obs_spans"] = _counters.get("obs_spans", 0) + 1


# --------------------------------------------------------------- spans

# span-close listener (one consumer: the obs.blackbox flight recorder).
# When set, span() stays LIVE even while chrome-trace span recording is
# off, so the recorder's bounded ring sees span closes without the trace
# buffer growing; when None (the default) the shared no-op fast path is
# untouched.
_span_listener = None


def set_span_listener(fn) -> None:
    """Install (``None`` removes) a callback invoked on every span close
    as ``fn(name, t_start, t_end, category, lane)``. Exceptions are
    swallowed — telemetry must never fail the traced code."""
    global _span_listener
    _span_listener = fn


def blackbox():
    """THE flight-recorder gate: the ``obs.blackbox`` module iff armed
    (``MXNET_TPU_OBS_BLACKBOX`` names a directory), else None. Every hook
    site (fit loop, checkpoint writer, fault harness) routes through this
    one function, so the recorder module is never imported while the
    knob is off."""
    if not _config.get("MXNET_TPU_OBS_BLACKBOX"):
        return None
    from .obs import blackbox as _bb
    return _bb


def spans_enabled() -> bool:
    """Fast, lock-free: True when span() currently records (profiler
    running or ``MXNET_TPU_OBS`` on)."""
    return _spans_on


class _NoopSpan(object):
    """Shared disabled-mode span: zero allocations per use."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark_flow(self, fid):
        pass


_NOOP_SPAN = _NoopSpan()


class _Span(object):
    __slots__ = ("name", "category", "flow", "lane", "_t0")

    def __init__(self, name, category, flow, lane):
        self.name = name
        self.category = category
        self.flow = flow
        self.lane = lane
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _append_event(self.name, self._t0, time.perf_counter(),
                      self.category, self.flow, self.lane, count_span=True)
        return False

    def mark_flow(self, fid) -> None:
        """Emit an extra flow step bound to this span's lane at the
        current time (serve: one batch slice carries many request
        flows)."""
        if fid is None:
            return
        now = time.perf_counter()
        with _lock:
            if not _spans_on or len(_events) >= _MAX_EVENTS:
                return
            lid = _lane_id_locked(self.lane) if self.lane is not None \
                else _current_lane_locked()
            _events.append(_flow_event_locked(int(fid),
                                              (now - _t0) * 1e6, lid))


def record_span(name: str, t_start: float, t_end: float,
                category: str = "span", flow: Optional[int] = None,
                lane: Optional[str] = None) -> None:
    """Low-level span record for sites that time conditionally (e.g. the
    serve coalescer, which only emits when a batch actually formed).
    Same gating as :func:`span`."""
    if not _spans_on and _span_listener is None:
        return
    _append_event(name, t_start, t_end, category, flow, lane,
                  count_span=True)


def span(name: str, category: str = "span", flow: Optional[int] = None,
         lane: Optional[str] = None):
    """Context manager timing one pipeline stage into the trace.

    ``flow`` links this slice to the other slices of the same batch or
    request across lanes; ``lane`` overrides the thread's lane with a
    named track. No-op (shared singleton, zero allocations) unless
    :func:`spans_enabled` or a span listener (the flight recorder) is
    installed.
    """
    if not _spans_on and _span_listener is None:
        return _NOOP_SPAN
    return _Span(name, category, flow, lane)


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


def reset_counters() -> None:
    with _lock:
        _counters.clear()


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

_gauges: dict = {}


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


def reset_gauges() -> None:
    with _lock:
        _gauges.clear()


# ---------------------------------------------------------- histograms
# 96 log-spaced bounds, 1e-5 .. ~1.4e7, factor 2^0.25 apart: a quantile
# estimate lands within one bucket (<= 19%) of the exact order statistic.
# Units are the caller's: seconds for latencies, milliseconds for bind
# times.
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

    @property
    def sum(self) -> float:
        return self._sum

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

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1): linear interpolation inside the
        bucket holding the target rank; None while empty."""
        return snapshot_quantile(self.snapshot(), q)

    def quantiles(self, qs) -> List[Optional[float]]:
        snap = self.snapshot()
        return [snapshot_quantile(snap, q) for q in qs]


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


def observe(name: str, value: float) -> None:
    """Record one observation into the registry histogram ``name``."""
    histogram(name).observe(value)


def histograms() -> Dict[str, Histogram]:
    """Snapshot of the histogram registry (name -> Histogram)."""
    with _lock:
        return dict(_histograms)


def reset_histograms() -> None:
    with _lock:
        for h in _histograms.values():
            h.reset()


class record(object):
    """Context manager: time a region into the profile."""

    def __init__(self, name: str, category: str = "region"):
        self.name = name
        self.category = category

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record_event(self.name, self._t, time.perf_counter(),
                     self.category)
        return False


# serializes the file write of dump() without holding the hot-path
# _lock across disk I/O: two concurrent dump() calls to one filename
# must not interleave their buffered writes into unparseable JSON
_dump_lock = threading.Lock()


def dump(finished: bool = True) -> str:
    """Write the chrome-trace JSON; returns the path. The payload AND the
    target filename are captured under the lock (so a concurrent
    ``set_config`` swaps cleanly between dumps), and the write itself is
    serialized under a separate dump lock. ``finished`` clears the
    recorded events (the lane registry stays)."""
    with _dump_lock:
        return _dump_locked(finished)


def _dump_locked(finished: bool) -> str:
    with _lock:
        events = list(_events)
        # lane-name metadata first (only for lanes that actually appear)
        # so every used tid renders under its registered name
        used = {e.get("tid") for e in events}
        meta = []
        for name, lid in sorted(_lanes.items(), key=lambda kv: kv[1]):
            if lid not in used:
                continue
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": lid, "args": {"name": name}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                         "tid": lid, "args": {"sort_index": lid}})
        payload = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        path = _filename
        if finished:
            _events.clear()
            _flows_seen.clear()
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


# reference-compatible names
profiler_set_config = set_config
profiler_set_state = set_state
dump_profile = dump


# ---------------------------------------------------------- device trace

_device_trace = None         # (torch.profiler.profile, logdir) while on


def start_xla_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and, where there is
    one, the card (CUPTI); :func:`stop_xla_trace` writes it into
    ``logdir``. The name is the reference's (a jax/XLA trace there)."""
    global _device_trace
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .base import MXNetError
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _lock:
        if _device_trace is not None:
            raise MXNetError("start_xla_trace: a device trace is already "
                             "running (into %s)" % _device_trace[1])
        prof = profile(activities=activities)
        _device_trace = (prof, str(logdir))
    prof.start()


def stop_xla_trace() -> str:
    """Stop the trace :func:`start_xla_trace` started and write it as
    ``<logdir>/device-trace-<pid>.json`` (a chrome trace); returns the
    path."""
    global _device_trace
    from .base import MXNetError
    with _lock:
        if _device_trace is None:
            raise MXNetError("stop_xla_trace: no device trace is running")
        prof, logdir = _device_trace
        _device_trace = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "device-trace-%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    return path


# keep the cached span flag honest under runtime knob flips
def _on_obs_knob(_value) -> None:
    with _lock:
        _recompute_enabled_locked()


_config.on_change("MXNET_TPU_OBS", _on_obs_knob)
with _lock:
    _recompute_enabled_locked()
