"""``mt.mon.Monitor`` — per-op output statistics during training.

The port's copy of the reference's ``monitor.py`` (MXNet's
``Monitor(interval, stat_func, pattern, sort)``): ``install`` hooks an
executor, ``tic`` arms collection for the coming batch when the step
hits the interval, ``toc`` / ``toc_print`` drain the queue. With
``monitor_all`` (the default) every op node's outputs of the forward
are read (``Executor.monitor_values``: the values that ran); otherwise
the graph outputs only, through the executor's forward callback.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import numpy as np

__all__ = ["Monitor"]


class Monitor(object):
    """Collect ``stat_func`` of the outputs whose names match
    ``pattern`` every ``interval`` steps."""

    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        if stat_func is None:
            def stat_func(x):
                # |x|.mean(), the reference's default statistic
                return np.abs(np.asarray(x)).mean()
        self.interval = interval
        self.stat_func = stat_func
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.queue: List[Tuple[int, str, object]] = []
        self.step = 0
        self.activated = False
        self.exes: List[object] = []

    def stat_helper(self, name, arr):
        """The executor callback: queue the statistic of ``arr``."""
        if not self.activated or not self.re_pattern.match(name):
            return
        if hasattr(arr, "asnumpy"):
            arr = arr.asnumpy()
        self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe, monitor_all: bool = True):
        """Attach to an executor: ``monitor_all`` reads every op node's
        outputs at ``toc``, otherwise the graph outputs as each forward
        makes them (the two are exclusive, so no statistic is reported
        twice)."""
        if monitor_all:
            exe.keep_node_outputs = True
        else:
            exe.set_monitor_callback(self.stat_helper)
        self.exes.append((exe, monitor_all))
        return exe

    def tic(self):
        """Arm collection if this step hits the interval."""
        if self.step % self.interval == 0:
            for exe, _ in self.exes:
                for arr in getattr(exe, "arg_arrays", []):
                    arr.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        """Drain the collected statistics: ``[(step, name, str(value))]``."""
        if not self.activated:
            return []
        for exe, monitor_all in self.exes:
            if monitor_all and hasattr(exe, "monitor_values"):
                for name, arr in exe.monitor_values():
                    self.stat_helper(name, arr)
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v in self.queue:
            res.append((n, k, str(v)))
        self.queue = []
        return res

    def toc_print(self):
        """Print what :meth:`toc` drains."""
        for n, k, v in self.toc():
            print("Batch: %7d %30s %s" % (n, k, v))
