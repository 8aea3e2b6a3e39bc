"""Deterministic fault injection — ``MXNET_TPU_FAULTS=<site>@<nth>[:kind]``.

The port's copy of the reference package's ``faults.py``, for the
serving path's, the checkpoint writer's and the data plane's injection
points. Spec grammar (comma-separated list)::

    MXNET_TPU_FAULTS=serve.decode@1
    MXNET_TPU_FAULTS=serve.evict@2:raise

``site`` names an injection point, ``nth`` is the 1-based arrival count
at that site in this process, and ``kind`` picks the failure mode:

===================  ============================  =====================
site                 where                         default kind
===================  ============================  =====================
serve.submit         GenerativeServer.submit_      raise
                     generate
serve.decode         GenerativeServer, before      raise
                     each decode step (kills ONE
                     sequence's stream, never the
                     co-resident batch)
serve.evict          GenerativeServer, during      raise
                     sequence eviction (pages are
                     still freed — no leak)
ckpt.arrays_write    checkpoint write, before      eio
                     any byte lands
ckpt.after_arrays    checkpoint write, after the   sigkill
                     arrays file
ckpt.after_manifest  after the manifest            sigkill
ckpt.before_rename   before the atomic rename      sigkill
fit.batch            Module.fit, after each batch  sigterm
data.worker          data.DataLoader worker        sigkill
                     process, at each batch start
                     (generation 0 only: the
                     respawned worker replays)
data.decode          the decode of one loader      raise
                     batch (poisons that batch,
                     never the epoch)
replica.die          fleet replica wire, after     sigkill
                     each emitted token frame
                     (the gateway re-prefills the
                     victim's sequences on
                     survivors; respawned
                     replicas do not re-fire)
gateway.route        fleet gateway, at each        raise
                     routing decision (kills ONE
                     request legibly, never the
                     gateway)
===================  ============================  =====================

Kinds: ``eio``/``enospc``/``eintr`` raise the matching ``OSError``;
``raise`` raises :class:`FaultInjected`; ``sigterm``/``sigkill`` deliver
the signal to this process; ``slow`` sleeps
``MXNET_TPU_FAULTS_SLOW_SECS`` (default 0.25) and returns;
``hostkill`` SIGKILLs the coordinated supervisor (the parent, only when
it marked this process ``MXNET_TPU_ELASTIC_COORDINATED``, so a drill
never kills a shell or pytest) and then this process. The reference's
other host-level kinds (``wedge``, ``coordsvc``) and file-corruption
kinds (``bitflip``, ``truncate``) belong to subsystems the port does
not have yet.

Call sites guard with ``if faults.ARMED:`` so a disarmed process pays
one attribute read. Every fired fault bumps the ``fault_injected``
counter (plus ``fault_injected.<site>``) before acting.
"""
from __future__ import annotations

import errno
import logging
import os
import signal
import time
from typing import Dict, List, Optional

from . import config as _config
from . import lockcheck as _lockcheck
from .base import MXNetError

__all__ = ["FaultInjected", "ARMED", "fire", "install", "clear",
           "active_specs", "KINDS", "ENV"]

ENV = "MXNET_TPU_FAULTS"

KINDS = ("eio", "enospc", "eintr", "raise", "sigterm", "sigkill", "slow",
         "hostkill")

SITES = frozenset(("serve.submit", "serve.decode", "serve.evict",
                   "ckpt.arrays_write", "ckpt.after_arrays",
                   "ckpt.after_manifest", "ckpt.before_rename",
                   "fit.batch", "data.worker", "data.decode",
                   "replica.die", "gateway.route"))

_ERRNO = {"eio": errno.EIO, "enospc": errno.ENOSPC, "eintr": errno.EINTR}


class FaultInjected(MXNetError):
    """The error raised by ``kind=raise`` injection sites."""


class _Spec(object):
    __slots__ = ("site", "nth", "kind")

    def __init__(self, site: str, nth: Optional[int], kind: Optional[str]):
        self.site = site
        self.nth = nth
        self.kind = kind

    def __repr__(self):
        return "%s@%s%s" % (self.site, self.nth if self.nth else "*",
                            ":" + self.kind if self.kind else "")


_lock = _lockcheck.Lock(name="faults.lock")
_specs: List[_Spec] = []
_hits: Dict[str, int] = {}

# hot-path guard: call sites check `if faults.ARMED:` before calling
# fire() — one attribute read when fault injection is off
ARMED = False


def _parse_one(item: str) -> _Spec:
    item = item.strip()
    if "@" in item:
        site, _, rest = item.partition("@")
        nth_s, _, kind = rest.partition(":")
    else:                       # "<site>:<kind>" fires on EVERY arrival
        site, _, kind = item.partition(":")
        nth_s = ""
    if not site:
        raise ValueError("%s: empty site in %r" % (ENV, item))
    kind = kind.strip().lower() or None
    if kind is not None and kind not in KINDS:
        raise ValueError("%s: unknown fault kind %r in %r (known: %s)"
                         % (ENV, kind, item, ", ".join(KINDS)))
    nth = None
    if nth_s.strip():
        nth = int(nth_s)
        if nth < 1:
            raise ValueError("%s: nth must be >= 1 in %r" % (ENV, item))
    if site not in SITES:
        # accepted (a new site must be armable before the catalog lists
        # it) but warned about: a typo'd site never fires, and the drill
        # would vacuously pass
        logging.getLogger(__name__).warning(
            "%s: %r names no shipped injection site (catalog: %s)",
            ENV, site, ", ".join(sorted(SITES)))
    return _Spec(site, nth, kind)


def install(spec: str) -> None:
    """Arm fault injection in-process: same grammar as the env var.
    Replaces any installed spec and resets arrival counts
    (``install("")`` disarms)."""
    global ARMED
    parsed = [_parse_one(s) for s in spec.split(",") if s.strip()]
    with _lock:
        _specs[:] = parsed
        _hits.clear()
        ARMED = bool(_specs)


def clear() -> None:
    """Disarm all faults and reset arrival counts."""
    install("")


def active_specs() -> List[str]:
    with _lock:
        return [repr(s) for s in _specs]


def _blackbox_note(site: str, count: int, kind: str) -> None:
    """Flight-recorder note BEFORE the fault acts: a kill-kind drill's
    post-mortem must carry its own cause of death, and sigkill leaves no
    later chance to flush. Runs at a normal call site, never a signal
    handler; the recorder is not imported while its knob is off.
    ``slow`` fires every batch, so it records without forcing a flush to
    disk each time."""
    try:
        from . import profiler as _profiler
        _bb = _profiler.blackbox()
        if _bb is None:
            return
        _bb.record("fault", site, arrival=count, kind=kind)
        if kind != "slow":
            _bb.flush("fault:%s@%d:%s" % (site, count, kind))
    except Exception:                                      # noqa: BLE001
        pass    # the recorder must never change drill behavior


def fire(site: str, default_kind: str = "raise") -> None:
    """Arrival at an injection point: fires the matching spec, if any."""
    with _lock:
        if not _specs:
            return
        _hits[site] = _hits.get(site, 0) + 1
        count = _hits[site]
        match = None
        for spec in _specs:
            if spec.site == site and spec.nth in (None, count):
                match = spec
                break
        if match is None:
            return
        kind = match.kind or default_kind
    # act OUTSIDE the lock: raising/killing while holding it would wedge
    # a concurrent arrival on another thread
    from . import profiler as _profiler
    _profiler.incr_counter("fault_injected")
    _profiler.incr_counter("fault_injected.%s" % site)
    _blackbox_note(site, count, kind)
    if kind in _ERRNO:
        raise OSError(_ERRNO[kind], "injected %s fault at %s" % (kind, site),
                      site)
    if kind == "raise":
        raise FaultInjected("injected fault at %s" % site)
    if kind == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
    elif kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "hostkill":
        # the whole host dies: the coordinated supervisor first, then
        # this process. Guarded by the coordinator's env marker so a
        # drill never SIGKILLs an arbitrary parent (a shell, pytest)
        if os.environ.get("MXNET_TPU_ELASTIC_COORDINATED"):
            try:
                os.kill(os.getppid(), signal.SIGKILL)
            except OSError:
                pass
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "slow":
        try:
            delay = float(os.environ.get("MXNET_TPU_FAULTS_SLOW_SECS",
                                         "0.25"))
        except ValueError:
            delay = 0.25
        time.sleep(max(0.0, delay))


# arm from the environment at import (subprocess drills set the env
# before python starts; in-process tests use install()/clear())
if os.environ.get(ENV, "").strip():
    install(os.environ[ENV])

# config.set("MXNET_TPU_FAULTS", spec) is a runtime override: route it
# through install() (an empty value disarms)
_config.on_change(ENV, install)
