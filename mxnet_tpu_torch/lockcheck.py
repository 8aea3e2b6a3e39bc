"""``MXNET_TPU_LOCKCHECK`` — the runtime lock witness (``off|warn|abort``).

The port's copy of the reference package's ``lockcheck.py``: runtime
modules create locks through the funnels below (:func:`Lock` /
:func:`RLock` / :func:`Condition`). With the knob off (the default) each
funnel returns the plain ``threading`` primitive after one module-bool
check. With ``warn``/``abort`` each lock created afterwards is wrapped
in a :class:`_WitnessLock` that keeps a per-thread held-stack and a
global site-keyed order graph, and flags the first ABBA inversion it
observes — counter ``lockcheck_inversion``, a warning naming both
acquisition chains under ``warn``, ``MXNetError`` before the blocking
acquire under ``abort``.

Graph nodes are creation sites (``file:line`` or the ``name=`` given),
not instances. Non-blocking try-acquires record no edges; reentrant
re-acquires of a held RLock record none either.

Held-lock host sync: the NDArray sync points (``asnumpy`` / ``asscalar``
/ ``wait_to_read``) call :func:`note_sync`; a sync while any witnessed
lock is held counts ``lockcheck_held_sync`` once per (lock site, sync)
pair and warns, or raises under ``abort`` — unless every held lock was
created with ``allow_sync=True`` (serve's model lock, under which the
batch's fetch to the host is the design).
"""
from __future__ import annotations

import logging
import sys
import threading as _threading
from typing import Dict, List, Optional, Set, Tuple

from . import config as _config

__all__ = ["Lock", "RLock", "Condition", "note_sync", "mode",
           "reset_order_graph"]

_MODE = "off"
_ON = False


def _set_mode(value: str) -> None:
    global _MODE, _ON
    _MODE = value
    _ON = value != "off"


_set_mode(_config.get("MXNET_TPU_LOCKCHECK"))
_config.on_change("MXNET_TPU_LOCKCHECK", _set_mode)


def mode() -> str:
    """Current witness mode (``off``/``warn``/``abort``)."""
    return _MODE


# --------------------------------------------------------------- state
# All raw threading primitives: the recorder must never witness itself.
_graph_lock = _threading.Lock()
# (site_a, site_b) -> human chain: how site_b was first acquired under a
_edges: Dict[Tuple[str, str], str] = {}
_flagged: Set[frozenset] = set()        # site pairs already reported
_sync_flagged: Set[Tuple[str, str]] = set()   # (lock site, sync) reported
_tls = _threading.local()


def _held() -> List["_WitnessLock"]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def reset_order_graph() -> None:
    """Forget every recorded edge and report (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _flagged.clear()
        _sync_flagged.clear()


def _shorten(fn: str) -> str:
    for marker in ("mxnet_tpu_torch", "tests"):
        idx = fn.rfind(marker)
        if idx >= 0:
            return fn[idx:]
    return fn


def _caller_site(depth: int) -> str:
    """file:line of the nearest frame OUTSIDE this module."""
    frame = sys._getframe(depth)
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    return "%s:%d" % (_shorten(frame.f_code.co_filename), frame.f_lineno)


def _abort(message: str) -> None:
    from .base import MXNetError
    raise MXNetError(message)


def _flag_inversion(pair_msgs: List[str]) -> None:
    from . import profiler as _profiler
    for msg in pair_msgs:
        _profiler.incr_counter("lockcheck_inversion")
        full = ("lockcheck: lock-order inversion (ABBA) observed — %s. "
                "Two threads taking these paths concurrently deadlock." % msg)
        if _MODE == "abort":
            _abort(full)
        logging.getLogger(__name__).warning(full)


class _WitnessLock:
    """Order-witnessing wrapper around one ``threading`` primitive.

    Duck-types the lock protocol plus the private hooks
    ``threading.Condition`` probes for (``_is_owned``/``_release_save``/
    ``_acquire_restore``), so it can back a Condition transparently.
    """

    __slots__ = ("_inner", "_site", "_allow_sync")

    def __init__(self, inner, site: str, allow_sync: bool = False):
        self._inner = inner
        self._site = site
        self._allow_sync = allow_sync

    # ------------------------------------------------------ lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            self._note_acquire()
        got = self._inner.acquire(blocking, timeout) if blocking \
            else self._inner.acquire(False)
        if got:
            _held().append(self)
        return got

    def release(self):
        self._inner.release()
        h = _held()
        for i in range(len(h) - 1, -1, -1):
            if h[i] is self:
                del h[i]
                break

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # ------------------------------------------- Condition compatibility
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        # Condition.wait drops the lock wholesale (all recursion levels)
        h = _held()
        n = 0
        for i in range(len(h) - 1, -1, -1):
            if h[i] is self:
                del h[i]
                n += 1
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, saved):
        state, n = saved
        # the post-wait re-acquire blocks like any other acquisition
        self._note_acquire()
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        _held().extend([self] * max(1, n))

    # ------------------------------------------------------ order graph
    def _note_acquire(self):
        held = _held()
        if not held or any(h is self for h in held):
            return                       # nothing held, or reentrant
        site_b = self._site
        where = _caller_site(3)
        thread = _threading.current_thread().name
        inversions: List[str] = []
        with _graph_lock:
            for h in held:
                site_a = h._site
                if site_a == site_b:
                    continue             # two instances of one site
                chain = ("thread %r acquires lock[%s] at %s while "
                         "holding lock[%s]" % (thread, site_b, where,
                                               site_a))
                _edges.setdefault((site_a, site_b), chain)
                rev = _edges.get((site_b, site_a))
                pair = frozenset((site_a, site_b))
                if rev is not None and pair not in _flagged:
                    _flagged.add(pair)
                    inversions.append("%s; but earlier %s" % (chain, rev))
        if inversions:
            _flag_inversion(inversions)


# ------------------------------------------------------------- funnels

def Lock(name: Optional[str] = None, allow_sync: bool = False):
    """``threading.Lock()`` through the witness funnel. ``allow_sync``
    exempts the lock from held-sync flagging (:func:`note_sync`): a lock
    under which a device fetch is the design (serve's ``_model_lock``)."""
    if not _ON:
        return _threading.Lock()
    return _WitnessLock(_threading.Lock(), name or _caller_site(2),
                        allow_sync=allow_sync)


def RLock(name: Optional[str] = None, allow_sync: bool = False):
    """``threading.RLock()`` through the witness funnel."""
    if not _ON:
        return _threading.RLock()
    return _WitnessLock(_threading.RLock(), name or _caller_site(2),
                        allow_sync=allow_sync)


def Condition(lock=None, name: Optional[str] = None):
    """``threading.Condition()`` through the witness funnel. A condition
    sharing an already-witnessed lock is witnessed through it; a bare
    ``Condition()`` gets a witnessed RLock like threading's default."""
    if not _ON:
        return _threading.Condition(lock)
    if lock is None:
        lock = _WitnessLock(_threading.RLock(), name or _caller_site(2))
    return _threading.Condition(lock)


# ---------------------------------------------------------- sync hook


def note_sync(what: str = "host-sync") -> None:
    """Called from the NDArray sync points (behind an ``if
    lockcheck._ON`` module-bool, so the off path costs one attribute
    read): flag a device sync made while witnessed locks are held."""
    if not _ON:
        return
    held = [h for h in _held() if not h._allow_sync]
    if not held:
        return
    where = _caller_site(2)
    sites = ", ".join(h._site for h in held)
    keys = [(h._site, what) for h in held]
    with _graph_lock:
        fresh = [k for k in keys if k not in _sync_flagged]
        _sync_flagged.update(fresh)
    if not fresh:
        return
    from . import profiler as _profiler
    _profiler.incr_counter("lockcheck_held_sync", len(fresh))
    msg = ("lockcheck: host sync %r at %s while holding lock(s) [%s] — "
           "other threads queue behind the device, and a callback that "
           "takes the same lock deadlocks. Create the lock with "
           "allow_sync=True only where the fetch under it is the design."
           % (what, where, sites))
    if _MODE == "abort":
        _abort(msg)
    logging.getLogger(__name__).warning(msg)
