"""Flight recorder — the always-on bounded event ring that survives the
crash (``MXNET_TPU_OBS_BLACKBOX=<dir>``).

The port's counterpart of the reference package's ``obs/blackbox.py``,
with its file names and record schema. The interesting failures of a
training run — a kill, a preemption, a wedge — are exactly the moments
when per-process telemetry dies with the process. This module is the
aircraft black box for them: a bounded, lock-light in-memory ring of
recent events (span closes, counter deltas, fault fires, checkpoint
phases, epoch ends) flushed to ``blackbox-p<rank>.jsonl`` via
``checkpoint.atomic.atomic_open``

* on every :func:`flush` call sites make at a terminal moment (fault
  fire, SIGTERM/143 preemption, NANCHECK abort, an uncaught exception,
  a failed checkpoint write), and
* on a periodic heartbeat (``MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS``), so a
  SIGKILL'd process still leaves its last window on disk.

Every flush atomically REWRITES the whole file (header line + the
current ring), so the artifact is bounded no matter how long the run
and a reader never sees a torn tail. ``python -m mxnet_tpu_torch.obs
blackbox <dir>`` merges every rank's file into one clock-aligned
timeline and prints the post-mortem verdict.

Discipline:

* NO signal handlers are registered here, and nothing here may be
  called from one — the SIGTERM/preemption flush happens on the
  training thread when the flag-only handler's flag is observed.
* Timestamps are ``time.perf_counter()`` everywhere; the wall clock is
  read ONCE at install to anchor the monotonic timeline, with a per-host
  clock offset (``MXNET_TPU_OBS_CLOCK_OFFSET``, or
  :func:`set_clock_offset`) recorded in the header so the merger can
  align ranks.
* Zero cost when the knob is off: call sites gate on the config knob
  (``profiler.blackbox()``) and never import this module.
* The heartbeat is a daemon thread: a forked child (a data-loader
  worker) does not inherit it, and a SIGKILL of the process leaves the
  last periodic window on disk.
"""
from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from .. import config as _config
from .. import lockcheck as _lockcheck
from .. import profiler as _profiler

__all__ = ["enabled", "record", "flush", "set_identity",
           "set_clock_offset", "path", "reset", "ENV_DIR"]

ENV_DIR = "MXNET_TPU_OBS_BLACKBOX"

# env vars whose values identify the run in the header fingerprint
_FINGERPRINT_PREFIXES = ("MXNET_", "DMLC_", "CUDA_VISIBLE_DEVICES")

_lock = _lockcheck.Lock(name="obs.blackbox.lock")   # install / identity
                                                    # / snapshot state
# serializes WHOLE flushes (snapshot + atomic write): without it a
# periodic flush that snapshotted the ring before a terminal flush
# (fault fire, SIGTERM) could finish its rename AFTER it and erase the
# cause-of-death event from the on-disk window. Separate from _lock so
# the disk write never blocks record()/identity state mutation.
_flush_lock = _lockcheck.Lock(name="obs.blackbox.flush_lock")
_seq = itertools.count(1)
_ring: Optional[collections.deque] = None
_installed = False
_dir: Optional[str] = None
_rank = 0
_role = "proc"
_clock_offset = 0.0
_wall_base = 0.0
_perf_base = 0.0
_trace0_wall: Optional[float] = None
_counter_snap: Dict[str, int] = {}
_flush_stop: Optional[threading.Event] = None
_flush_thread: Optional[threading.Thread] = None
_prev_excepthook = None


def enabled() -> bool:
    """True when the recorder is armed (the knob names a directory).
    Call sites normally check the config knob THEMSELVES before
    importing this module — that is the zero-import discipline."""
    return bool(_config.get(ENV_DIR))


def _default_identity() -> tuple:
    """(rank, role) when nobody called :func:`set_identity`: the pod
    rank in ``MXNET_TPU_POD_RANK``, else a launcher worker's
    ``DMLC_WORKER_ID``, else 0."""
    rank = os.environ.get("MXNET_TPU_POD_RANK",
                          os.environ.get("DMLC_WORKER_ID", "0"))
    try:
        rank = int(rank)
    except ValueError:
        rank = 0
    role = "child" if os.environ.get("MXNET_TPU_ELASTIC_COORDINATED") \
        else "proc"
    return rank, role


def _install_locked() -> bool:
    global _installed, _ring, _dir, _rank, _role, _clock_offset
    global _wall_base, _perf_base, _trace0_wall, _flush_stop, _flush_thread
    global _prev_excepthook
    if _installed:
        return True
    directory = str(_config.get(ENV_DIR) or "")
    if not directory:
        return False
    _dir = directory
    try:
        os.makedirs(directory, exist_ok=True)
    except OSError:
        return False
    size = max(16, int(_config.get("MXNET_TPU_OBS_BLACKBOX_RING")))
    _ring = collections.deque(maxlen=size)
    if _rank == 0 and _role == "proc":
        _rank, _role = _default_identity()
    # the ONE wall-clock read: anchors the monotonic timeline so the
    # cross-host merger can align ranks (clock_offset_s in the header
    # re-bases it onto the control-plane host's clock)
    _wall_base = time.time()     # mx-lint: allow(wall-clock)
    _perf_base = time.perf_counter()
    # anchor for merging this process's chrome trace (profiler ts 0)
    _trace0_wall = _wall_base + (_profiler._t0 - _perf_base)
    try:
        off = os.environ.get("MXNET_TPU_OBS_CLOCK_OFFSET")
        if off:
            _clock_offset = float(off)
    except ValueError:
        pass
    period = float(_config.get("MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS"))
    if period > 0:
        _flush_stop = threading.Event()
        stop = _flush_stop

        def _beat():
            while not stop.wait(period):
                try:
                    flush("periodic")
                except Exception:                          # noqa: BLE001
                    pass    # a failing disk must never kill the host

        _flush_thread = threading.Thread(
            target=_beat, name="mxnet_tpu_torch.obs[blackbox]", daemon=True)
        _flush_thread.start()
    # an uncaught exception is a crash: leave the window + the traceback
    _prev_excepthook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            record("crash", exc_type.__name__, message=str(exc)[:500])
            flush("crash")
        except Exception:                                  # noqa: BLE001
            pass
        if _prev_excepthook is not None:
            _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _hook
    atexit.register(_atexit_flush)
    # span closes land in the ring even when the chrome-trace span
    # recording itself is off (the listener makes span() live)
    _profiler.set_span_listener(_on_span)
    _installed = True
    return True


def _ensure() -> bool:
    if _installed:
        return True
    with _lock:
        return _install_locked()


def _atexit_flush() -> None:
    try:
        flush("exit")
    except Exception:                                      # noqa: BLE001
        pass


def _on_span(name, t_start, t_end, category, lane) -> None:
    ring = _ring
    if ring is None:
        return
    ring.append({"s": next(_seq), "p": float(t_end), "kind": "span",
                 "name": str(name), "cat": str(category),
                 "dur_ms": round((t_end - t_start) * 1e3, 3),
                 "lane": lane})


def set_identity(rank: int, role: str) -> None:
    """Name this process's recorder file (``blackbox-p<rank>.jsonl`` for
    training processes, ``blackbox-p<rank>-coord.jsonl`` for a
    coordinator role)."""
    global _rank, _role
    with _lock:
        _rank = int(rank)
        _role = str(role)


def set_clock_offset(offset_s: float) -> None:
    """Record this host's wall-clock offset against a reference host
    (``local_wall - reference_wall``); the merger subtracts it to align
    ranks."""
    global _clock_offset
    _clock_offset = float(offset_s)


def path() -> Optional[str]:
    """The file this recorder flushes to (None while un-installed)."""
    if _dir is None:
        return None
    name = "blackbox-p%d.jsonl" % _rank if _role != "coord" \
        else "blackbox-p%d-coord.jsonl" % _rank
    return os.path.join(_dir, name)


def record(kind: str, name: str = "", /, **data: Any) -> None:
    """Append one event to the ring (lock-light: a deque append). Event
    timestamps are perf_counter; the wall mapping happens at flush.
    ``kind``/``name`` are positional-only so ``data`` may reuse those
    keys (fault events carry a ``kind`` of their own)."""
    if not _ensure():
        return
    ev = {"s": next(_seq), "p": time.perf_counter(), "kind": str(kind),
          "name": str(name)}
    if data:
        ev["data"] = data
    _ring.append(ev)


def _fingerprint() -> Dict[str, Any]:
    env = {k: v for k, v in os.environ.items()
           if k.startswith(_FINGERPRINT_PREFIXES)}
    fp: Dict[str, Any] = {"python": sys.version.split()[0], "env": env}
    torch = sys.modules.get("torch")
    if torch is not None:
        fp["torch"] = getattr(torch, "__version__", "?")
        fp["cuda"] = getattr(torch.version, "cuda", None)
    return fp


def _counter_delta_locked() -> Dict[str, int]:
    now = _profiler.counters()
    # the recorder's own flush counter moves on every flush — counting
    # it would make every window carry a spurious one-entry delta
    delta = {k: v - _counter_snap.get(k, 0) for k, v in now.items()
             if v != _counter_snap.get(k, 0)
             and not k.startswith("obs_blackbox_")}
    _counter_snap.clear()
    _counter_snap.update(now)
    return delta


def flush(reason: str) -> Optional[str]:
    """Atomically rewrite the recorder file with the current window:
    one header line (identity, clock anchors + offset, flush reason,
    counters/gauges snapshot, armed faults, config fingerprint) then
    one line per ring event, newest last. Returns the path. Whole
    flushes are serialized (``_flush_lock``) so snapshot order equals
    on-disk order — an in-flight periodic flush can never rename an
    older window over a terminal one."""
    if not _ensure():
        return None
    from .. import faults as _faults
    from ..checkpoint.atomic import atomic_open
    with _flush_lock:
        return _flush_locked(reason, _faults, atomic_open)


def _flush_locked(reason, _faults, atomic_open) -> Optional[str]:
    with _lock:
        delta = _counter_delta_locked()
        if delta:
            _ring.append({"s": next(_seq), "p": time.perf_counter(),
                          "kind": "counters", "name": "delta",
                          "data": delta})
        events = list(_ring)
        target = path()
        header = {
            "blackbox": 1,
            "rank": _rank,
            "role": _role,
            "pid": os.getpid(),
            "wall_base": _wall_base,
            "perf_base": _perf_base,
            "trace0_wall": _trace0_wall,
            "clock_offset_s": _clock_offset,
            "flush_reason": str(reason),
            "flush_wall": _wall_base + (time.perf_counter() - _perf_base),
            "gen": int(os.environ.get("MXNET_TPU_POD_GEN", "0") or 0),
            "faults_armed": _faults.active_specs(),
            "counters": _profiler.counters(),
            "gauges": _profiler.gauges(),
            "fingerprint": _fingerprint(),
        }
        lines: List[str] = [json.dumps(header, sort_keys=True)]
        for ev in events:
            out = dict(ev)
            out["t"] = round(_wall_base + (out.pop("p") - _perf_base), 6)
            lines.append(json.dumps(out, sort_keys=True, default=str))
    try:
        with atomic_open(target, "w") as f:
            f.write("\n".join(lines) + "\n")
    except OSError:
        return None
    _profiler.incr_counter("obs_blackbox_flush")
    return target


def reset() -> None:
    """Tear the recorder down (tests): stop the heartbeat thread,
    uninstall the span listener and excepthook, drop the ring."""
    global _installed, _ring, _dir, _flush_stop, _flush_thread
    global _prev_excepthook, _rank, _role, _clock_offset
    with _lock:
        if _flush_stop is not None:
            _flush_stop.set()
        thread = _flush_thread
    if thread is not None:
        thread.join(timeout=2.0)
    with _lock:
        _profiler.set_span_listener(None)
        if _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
            _prev_excepthook = None
        _installed = False
        _ring = None
        _dir = None
        _flush_stop = None
        _flush_thread = None
        _rank, _role = 0, "proc"
        _clock_offset = 0.0
        _counter_snap.clear()
