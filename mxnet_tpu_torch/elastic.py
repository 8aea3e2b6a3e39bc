"""Supervision helpers of the reference package's ``elastic.py``.

For now this holds only :func:`backoff_delay`, the respawn delay the
serving fleet's per-replica supervisors use
(:mod:`mxnet_tpu_torch.fleet.gateway`). The reference's preemption
supervisor and auto-resume (``Supervisor``, ``supervise``,
``resume_dir``) and the pod coordinator arrive with queue A10d and A9
(ROADMAP.md).
"""
from __future__ import annotations

__all__ = ["backoff_delay"]


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
