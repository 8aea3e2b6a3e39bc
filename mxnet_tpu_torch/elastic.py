"""The single-host preemption supervisor: restart a training command
after a preemption or a crash, and resume it from its checkpoints.

The port of the reference package's ``elastic.py``, one host's part.
``fit`` already survives a preemption NOTICE: SIGTERM lands a final
synchronous checkpoint and exits 143. This module supplies the half that
re-enters training after it:

* run the training program in a CHILD process (a supervisor that shares
  the training process dies with it; only a process boundary survives
  ``kill -9``);
* treat exit 143 (clean preemption) and any crash (signal death,
  non-zero exit) as a restartable event, bounded by
  ``MXNET_TPU_ELASTIC_MAX_RESTARTS`` with exponential backoff and
  jitter (:func:`backoff_delay`, which the serving fleet's per-replica
  supervisors use too);
* re-probe the visible devices between attempts (:func:`probe_world`);
* the child resumes from the newest valid checkpoint
  (``fit(resume_from=resume_dir(base))``).

The supervisor never initializes CUDA: a CUDA context pins a device view
(and device memory) for the life of the process, and the child needs the
card. ``python -m`` imports the package, torch with it, but nothing here
touches the device: every device query runs in a throwaway subprocess.

CLI::

    python -m mxnet_tpu_torch.elastic [--max-restarts N] [--backoff S]
        [--backoff-max S] -- python train.py --my-args

It exits with the supervisor's status and prints, as its last line,
``ELASTIC-SUPERVISOR-EXIT rc=<rc> restarts=<n> cuda_initialized=<bool>``
(the last: whether this process ever created a CUDA context; it must
not).

Environment exported to every attempt:

* ``MXNET_TPU_ELASTIC_ATTEMPT`` — 0-based attempt index (the training
  script can key per-attempt behavior on it; the fault drills do);
* ``MXNET_TPU_ELASTIC_RESUMED=1`` — on every attempt after the first.

Counters: ``elastic_restart`` (every re-entry), ``elastic_preempt``
(exit-143 children), ``elastic_crash`` (signal/non-zero children),
``elastic_reshard`` (re-entries whose device count changed) and the
``elastic_world`` gauge.

The pod runtime of the reference (``PodCoordinator``, ``--coordinated``)
and its virtual-mesh world schedule (``--world-schedule``, which
rewrites XLA's host device count per attempt) come with ROADMAP.md
queue A9; the CLI refuses both with exit status 2.
"""
from __future__ import annotations

import argparse
import logging
import os
import random as _pyrandom
import signal
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

__all__ = ["Supervisor", "supervise", "resume_dir", "probe_world",
           "backoff_delay", "main"]

log = logging.getLogger(__name__)

_A9 = "ROADMAP.md queue A9 (the pod runtime)"


def backoff_delay(restarts: int, backoff: float, backoff_max: float,
                  rng=None) -> float:
    """Bounded-exponential respawn delay before the Nth restart
    (1-based): ``min(backoff_max, backoff * 2**(restarts-1))``, plus up
    to 25% jitter when ``rng`` (a ``random.Random``) is given, so a
    drill can bound worst-case recovery time from the knobs alone."""
    delay = min(float(backoff_max),
                float(backoff) * (2 ** (max(1, int(restarts)) - 1)))
    if rng is not None:
        delay *= 1.0 + 0.25 * rng.random()
    return delay


def resume_dir(base: str) -> Optional[str]:
    """``base`` if it holds at least one VALID checkpoint, else None —
    the one-liner a training script needs to pass
    ``fit(resume_from=...)`` only when there is something to resume
    (attempt 0 of a supervised run starts from scratch).

    One host writes whole checkpoints, so there is no staging directory
    to audit first: the reference's audit of a pod's orphaned staged
    saves (``finalize_staged_pod_saves``) comes with ROADMAP.md queue
    A9."""
    from .checkpoint import format as _format
    for _step, path in reversed(_format.list_checkpoints(str(base))):
        if _format.probe_valid(path):
            return str(base)
    return None


def probe_world(env: Optional[dict] = None,
                timeout: float = 120.0) -> Optional[int]:
    """Count the visible CUDA devices in a THROWAWAY subprocess (the
    supervisor must never create a CUDA context of its own). Returns
    the count, or None when the probe fails (the caller logs and goes
    on; the child binds whatever it sees)."""
    try:
        out = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=timeout,
            env=env if env is not None else os.environ.copy())
        if out.returncode == 0:
            return int(out.stdout.strip().splitlines()[-1])
    except (subprocess.SubprocessError, ValueError, IndexError, OSError):
        pass
    return None


class Supervisor(object):
    """Run one training command under restarts; see the module
    docstring.

    Parameters
    ----------
    argv : list of str
        The child command. A leading ``*.py`` token is run with the
        current interpreter.
    max_restarts, backoff, backoff_max : optional
        Defaults from the ``MXNET_TPU_ELASTIC_*`` knobs.
    env : dict, optional
        The children's base environment (default: this process's).
    jitter_seed : optional
        Seeds the backoff jitter for deterministic tests.
    on_attempt : callable, optional
        ``on_attempt(attempt, env)`` before each spawn.
    """

    def __init__(self, argv: Sequence[str],
                 max_restarts: Optional[int] = None,
                 backoff: Optional[float] = None,
                 backoff_max: Optional[float] = None,
                 env: Optional[dict] = None,
                 jitter_seed: Optional[int] = None,
                 on_attempt: Optional[Callable[[int, dict], None]] = None):
        from . import config as _config
        argv = list(argv)
        if argv and argv[0].endswith(".py"):
            argv.insert(0, sys.executable)
        if not argv:
            raise ValueError("elastic supervisor needs a child command")
        self.argv = argv
        self.max_restarts = int(
            _config.get("MXNET_TPU_ELASTIC_MAX_RESTARTS")
            if max_restarts is None else max_restarts)
        self.backoff = float(_config.get("MXNET_TPU_ELASTIC_BACKOFF")
                             if backoff is None else backoff)
        self.backoff_max = float(
            _config.get("MXNET_TPU_ELASTIC_BACKOFF_MAX")
            if backoff_max is None else backoff_max)
        self.env = dict(env) if env is not None else None
        self._rng = _pyrandom.Random(jitter_seed)
        self._on_attempt = on_attempt
        self.restarts = 0
        self.reshards = 0
        self._child: Optional[subprocess.Popen] = None
        self._terminated = False

    # ------------------------------------------------------------ signals
    def _install_forwarder(self):
        """Forward a SIGTERM aimed at the supervisor to the child (the
        scheduler preempts the whole allocation: the child must get its
        preemption notice) and stop restarting. Flag-set and os.kill
        only: anything that allocates or locks is unsafe in a
        handler."""
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _handler(_signum, _frame):
                self._terminated = True
                child = self._child
                if child is not None:
                    try:
                        os.kill(child.pid, signal.SIGTERM)
                    except OSError:
                        pass        # already gone

            signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            return None         # not the main thread

        def _restore():
            try:
                signal.signal(signal.SIGTERM, prev)
            except (ValueError, OSError, TypeError):
                pass

        return _restore

    def _backoff_sleep(self, delay: float) -> None:
        """Backoff that a SIGTERM between attempts cuts short: PEP 475
        resumes one long ``time.sleep`` after the flag-only handler
        returns, so sleep in small slices and re-check the flag."""
        deadline = time.monotonic() + max(0.0, delay)
        while not self._terminated:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.25, left))

    def _env_for_attempt(self, attempt: int) -> dict:
        env = dict(self.env if self.env is not None else os.environ)
        env["MXNET_TPU_ELASTIC_ATTEMPT"] = str(attempt)
        if attempt > 0:
            env["MXNET_TPU_ELASTIC_RESUMED"] = "1"
        return env

    # -------------------------------------------------------------- run
    def run(self) -> int:
        from . import profiler as _profiler
        restore_sig = self._install_forwarder()
        attempt = 0
        prev_world: Optional[int] = None
        try:
            while True:
                if self._terminated:
                    # the preemption landed BETWEEN attempts (backoff
                    # sleep, device probe): do not spawn a fresh child
                    # just to have the platform hard-kill it
                    log.warning("elastic: supervisor was SIGTERMed "
                                "between attempts; not restarting")
                    return 143
                env = self._env_for_attempt(attempt)
                world = probe_world(env)
                if world is not None:
                    _profiler.set_gauge("elastic_world", world)
                    if prev_world is not None and world != prev_world:
                        self.reshards += 1
                        _profiler.incr_counter("elastic_reshard")
                        log.warning("elastic: %d -> %d visible devices",
                                    prev_world, world)
                    prev_world = world
                if self._on_attempt is not None:
                    self._on_attempt(attempt, env)
                log.info("elastic attempt %d (devices=%s): %s",
                         attempt, world, " ".join(self.argv))
                self._child = subprocess.Popen(self.argv, env=env)
                rc = self._child.wait()
                self._child = None
                if rc == 0:
                    return 0
                if self._terminated:
                    # the preemption was aimed at US: do not restart,
                    # propagate the conventional status
                    log.warning("elastic: supervisor was SIGTERMed; "
                                "child exited %d; not restarting", rc)
                    return 143
                if rc == 143:
                    _profiler.incr_counter("elastic_preempt")
                    log.warning("elastic: child preempted (exit 143)")
                else:
                    _profiler.incr_counter("elastic_crash")
                    log.warning("elastic: child died (%s)",
                                "signal %d" % -rc if rc < 0
                                else "exit %d" % rc)
                if self.restarts >= self.max_restarts:
                    log.error("elastic: restart budget exhausted "
                              "(%d); giving up with rc=%d",
                              self.max_restarts, rc)
                    return rc
                self.restarts += 1
                _profiler.incr_counter("elastic_restart")
                delay = backoff_delay(self.restarts, self.backoff,
                                      self.backoff_max, rng=self._rng)
                log.info("elastic: restart %d/%d in %.2fs",
                         self.restarts, self.max_restarts, delay)
                self._backoff_sleep(delay)
                attempt += 1
        finally:
            if restore_sig is not None:
                restore_sig()


def supervise(argv: Sequence[str], **kwargs) -> int:
    """One-call form: build a :class:`Supervisor` and run it."""
    return Supervisor(argv, **kwargs).run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.elastic",
        description="preemption-aware training supervisor: runs a "
                    "training command in a child process and restarts "
                    "it on preemption (exit 143) or crash, bounded, "
                    "with backoff")
    parser.add_argument("--max-restarts", type=int, default=None)
    parser.add_argument("--backoff", type=float, default=None,
                        help="base seconds of the exponential backoff")
    parser.add_argument("--backoff-max", type=float, default=None)
    parser.add_argument("--world-schedule", default=None,
                        help="not available: comes with " + _A9)
    parser.add_argument("--coordinated", action="store_true",
                        help="not available: comes with " + _A9)
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="child command (prefix with -- to separate)")
    args = parser.parse_args(argv)
    for flag, given in (("--world-schedule", args.world_schedule),
                        ("--coordinated", args.coordinated)):
        if given:
            print("python -m mxnet_tpu_torch.elastic: %s is not ported "
                  "yet: it comes with %s" % (flag, _A9), file=sys.stderr)
            return 2
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no child command given")
    logging.basicConfig(level=logging.INFO,
                        format="[elastic] %(message)s")
    sup = Supervisor(command, max_restarts=args.max_restarts,
                     backoff=args.backoff, backoff_max=args.backoff_max)
    rc = sup.run()
    torch = sys.modules.get("torch")
    print("ELASTIC-SUPERVISOR-EXIT rc=%d restarts=%d cuda_initialized=%s"
          % (rc, sup.restarts,
             bool(torch is not None and torch.cuda.is_initialized())),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
