"""Deterministic fault injection — ``MXNET_TPU_FAULTS=<site>@<nth>[:kind]``.

The port's copy of the reference package's ``faults.py``, for the
serving path's, the checkpoint writer's and reader's, the fit loop's and
the data plane's injection points. Spec grammar (comma-separated
list)::

    MXNET_TPU_FAULTS=serve.decode@1
    MXNET_TPU_FAULTS=fit.batch@12:sigterm
    MXNET_TPU_FAULTS=ckpt.read_manifest@1:bitflip

``site`` names an injection point, ``nth`` is the 1-based arrival count
at that site in this process, and ``kind`` picks the failure mode. The
legacy ``MXNET_TPU_CKPT_TEST_CRASH=<point>@<n>`` hook is parsed as an
alias for ``ckpt.<point>@<n>:sigkill``.

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
ckpt.read_manifest   reader, before the manifest   bitflip
                     is opened
ckpt.read_arrays     reader, before the arrays     bitflip
                     file is opened
fit.batch            Module.fit, each batch start  sigterm
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
``bitflip`` flips one byte in the middle of the site's file and returns
(the read that follows must detect the corruption); ``truncate`` cuts
the site's file in half and returns; ``hostkill`` SIGKILLs the
coordinated supervisor (the parent, only when it marked this process
``MXNET_TPU_ELASTIC_COORDINATED``, so a drill never kills a shell or
pytest) and then this process; ``wedge`` stops making progress while
staying alive (and SIGSTOPs such a parent first). The pod's sites
(``host.die``, ``leader.die``, ``dist.kv``, ``ckpt.after_record``) and
the ``coordsvc`` kind belong to the pod runtime, ROADMAP queue A9: a
spec naming one is refused with an error that says so.

Hot-path sites guard with ``if faults.ARMED:`` so a disarmed process
pays one attribute read; the checkpoint writer's and reader's sites
call :func:`armed_or_env`, which also notices the environment variables
set after import. Every fired fault bumps the ``fault_injected``
counter (plus ``fault_injected.<site>``) before acting and, when
``MXNET_TPU_FAULTS_TOUCH=<path>`` names a marker file, first appends
``<site>@<arrival>:<kind>`` to it, so even a SIGKILL drill leaves a
trace its parent can read.
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
           "active_specs", "armed_or_env", "KINDS", "ENV", "LEGACY_ENV",
           "MARKER_ENV"]

ENV = "MXNET_TPU_FAULTS"
LEGACY_ENV = "MXNET_TPU_CKPT_TEST_CRASH"
MARKER_ENV = "MXNET_TPU_FAULTS_TOUCH"

KINDS = ("eio", "enospc", "eintr", "raise", "sigterm", "sigkill",
         "bitflip", "truncate", "hostkill", "wedge", "slow")

SITES = frozenset(("serve.submit", "serve.decode", "serve.evict",
                   "ckpt.arrays_write", "ckpt.after_arrays",
                   "ckpt.after_manifest", "ckpt.before_rename",
                   "ckpt.read_manifest", "ckpt.read_arrays",
                   "fit.batch", "data.worker", "data.decode",
                   "replica.die", "gateway.route"))

# the reference's pod sites and kind: they fire only inside the pod
# runtime, which the port does not have yet
_POD_SITES = frozenset(("host.die", "leader.die", "dist.kv",
                        "ckpt.after_record"))
_POD_KINDS = frozenset(("coordsvc",))

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
# install() and clear() are final: armed_or_env() must not resurrect the
# environment's specs they replaced (a one-shot @nth fault re-armed with
# fresh arrival counts would fire a second time)
_env_disarmed = False

# hot-path guard: call sites check `if faults.ARMED:` before calling
# fire() — one attribute read when fault injection is off
ARMED = False


def _parse_one(item: str, default_kind: Optional[str] = None) -> _Spec:
    item = item.strip()
    if "@" in item:
        site, _, rest = item.partition("@")
        nth_s, _, kind = rest.partition(":")
    else:                       # "<site>:<kind>" fires on EVERY arrival
        site, _, kind = item.partition(":")
        nth_s = ""
    if not site:
        raise ValueError("%s: empty site in %r" % (ENV, item))
    kind = kind.strip().lower() or default_kind
    if site in _POD_SITES or kind in _POD_KINDS:
        raise ValueError(
            "%s: %r names the pod runtime's %s, which the port does not "
            "have yet (ROADMAP.md queue A9)"
            % (ENV, item, "site %r" % site if site in _POD_SITES
               else "kind %r" % kind))
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


def _parse_env() -> List[_Spec]:
    specs = [_parse_one(item)
             for item in os.environ.get(ENV, "").split(",") if item.strip()]
    legacy = os.environ.get(LEGACY_ENV, "").strip()
    if legacy:
        # the checkpoint writer's crash hook: <point>@<n> is a SIGKILL at
        # the n-th arrival of the writer's point
        specs.append(_parse_one("ckpt." + legacy, default_kind="sigkill"))
    return specs


def install(spec: str) -> None:
    """Arm fault injection in-process: same grammar as the env var.
    Replaces any installed spec and resets arrival counts. The spec
    installed here is final against the environment: ``install("")``
    disarms for good, as a config override beats the environment."""
    global ARMED, _env_disarmed
    parsed = [_parse_one(s) for s in spec.split(",") if s.strip()]
    with _lock:
        _specs[:] = parsed
        _hits.clear()
        ARMED = bool(_specs)
        _env_disarmed = True


def clear() -> None:
    """Disarm all faults and reset arrival counts. Final: the
    environment's specs do not re-arm after it."""
    install("")


def active_specs() -> List[str]:
    with _lock:
        return [repr(s) for s in _specs]


def armed_or_env() -> bool:
    """The arming check of the cold sites (the checkpoint writer and
    reader): also notices the environment variables set after import,
    as the legacy crash hook allowed (set the variable, then save in the
    same process). Parses the environment at most once per arming;
    hot-path sites read :data:`ARMED` alone."""
    global ARMED
    if ARMED:
        return True
    if _env_disarmed:
        return False
    if not (os.environ.get(ENV) or os.environ.get(LEGACY_ENV)):
        return False
    specs = _parse_env()
    with _lock:
        if specs and not _specs and not _env_disarmed:
            _specs[:] = specs
            _hits.clear()
            ARMED = True
    return ARMED


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


def _corrupt_file(path: str, kind: str) -> None:
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "r+b") as f:
        if kind == "truncate":
            f.truncate(max(1, size // 2))
            return
        f.seek(size // 2)                   # bitflip
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


def _touch(site: str, count: int, kind: str) -> None:
    """The parent-readable trace, written before the fault acts."""
    marker = os.environ.get(MARKER_ENV)
    if not marker:
        return
    try:
        with open(marker, "a") as f:
            f.write("%s@%d:%s\n" % (site, count, kind))
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        pass


def fire(site: str, path: Optional[str] = None,
         default_kind: str = "raise") -> None:
    """Arrival at an injection point: fires the matching spec, if any.
    ``path`` is the file the site is about to read (the ``bitflip`` and
    ``truncate`` kinds corrupt it)."""
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
    _touch(site, count, kind)
    if kind in _ERRNO:
        raise OSError(_ERRNO[kind], "injected %s fault at %s" % (kind, site),
                      path or site)
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
    elif kind == "wedge":
        # alive and making no progress: the failure only a heartbeat
        # deadline catches. A coordinated supervisor is stopped first,
        # as a frozen host stops everything on it
        if os.environ.get("MXNET_TPU_ELASTIC_COORDINATED"):
            try:
                os.kill(os.getppid(), signal.SIGSTOP)
            except OSError:
                pass
        while True:
            time.sleep(3600)
    elif kind in ("bitflip", "truncate"):
        if path is None:
            raise FaultInjected("site %s cannot apply %r (no file)"
                                % (site, kind))
        _corrupt_file(path, kind)
    elif kind == "slow":
        try:
            delay = float(os.environ.get("MXNET_TPU_FAULTS_SLOW_SECS",
                                         "0.25"))
        except ValueError:
            delay = 0.25
        time.sleep(max(0.0, delay))


# arm from the environment at import (subprocess drills set the env
# before python starts; in-process tests use install()/clear())
_env_specs = _parse_env()
if _env_specs:
    _specs.extend(_env_specs)
    ARMED = True
del _env_specs

# config.set("MXNET_TPU_FAULTS", spec) is a runtime override: route it
# through install() (an empty value disarms)
_config.on_change(ENV, install)
