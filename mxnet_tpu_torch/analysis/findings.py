"""Finding/Report containers of the analyzer.

The port's copy of the reference's ``analysis/findings.py``: a
:class:`Finding` is one located hazard with a stable ``code``
(the hazard class), a :class:`Severity`, and a human message that names the
offending node/op/file instead of a raw traceback. A :class:`Report`
collects findings, feeds the per-class profiler counters
(``analysis_<code>``), and implements the warn/strict bind-time contract.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

__all__ = ["Severity", "Finding", "Report"]


class Severity(enum.IntEnum):
    """ERROR findings raise under ``MXNET_TPU_ANALYZE=strict``; WARNING
    findings log; INFO findings only appear in reports/CLI output."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name


class Finding:
    """One located hazard.

    ``code`` is the stable hazard-class slug (``cycle``, ``baked-const``,
    ``lock-host-sync``, ...) — the unit tests, the profiler counters and
    the CI baseline all key on it, so it must never encode volatile detail
    (line numbers, shapes) — those live in ``message``/``detail``.
    """

    __slots__ = ("code", "severity", "message", "node", "op", "path",
                 "line", "func", "detail")

    def __init__(self, code: str, severity: Severity, message: str,
                 node: Optional[str] = None, op: Optional[str] = None,
                 path: Optional[str] = None, line: Optional[int] = None,
                 func: Optional[str] = None,
                 detail: Optional[Dict[str, Any]] = None):
        self.code = code
        self.severity = Severity(severity)
        self.message = message
        self.node = node
        self.op = op
        self.path = path
        self.line = line
        self.func = func
        self.detail = detail or {}

    def location(self) -> str:
        if self.path is not None:
            loc = self.path if self.line is None else \
                "%s:%d" % (self.path, self.line)
            return "%s (%s)" % (loc, self.func) if self.func else loc
        if self.node is not None:
            return "%s(name=%r)" % (self.op or "node", self.node)
        return "<program>"

    def format(self) -> str:
        return "%-7s %-16s %s: %s" % (self.severity, self.code,
                                      self.location(), self.message)

    def __repr__(self):
        return "Finding(%s)" % self.format()

    def counter_name(self) -> str:
        return "analysis_" + self.code.replace("-", "_")


class Report:
    """Accumulated findings of one analysis run.

    Every ``add`` bumps the always-on profiler counter for the finding's
    class (``analysis_<code>``), so dashboards and tests can observe
    hazard rates without holding Report objects. ``extras`` carries
    non-finding artifacts (the cost-model summary).
    """

    def __init__(self, context: str = "analysis"):
        self.context = context
        self.findings: List[Finding] = []
        self.extras: Dict[str, Any] = {}

    def add(self, code: str, severity: Severity, message: str,
            **kwargs) -> Finding:
        f = Finding(code, severity, message, **kwargs)
        self.findings.append(f)
        from .. import profiler as _profiler
        _profiler.incr_counter(f.counter_name())
        return f

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.extras.update(other.extras)
        return self

    # ------------------------------------------------------------ queries
    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def at_least(self, severity: Severity) -> List[Finding]:
        return [f for f in self.findings if f.severity >= severity]

    @property
    def errors(self) -> List[Finding]:
        return self.at_least(Severity.ERROR)

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def max_severity(self) -> Optional[Severity]:
        return max((f.severity for f in self.findings), default=None)

    def __len__(self):
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def __bool__(self):
        # a Report is always truthy (even when empty) so callers test
        # `report.findings` / `report.errors`, not the report itself
        return True

    # ---------------------------------------------------------- rendering
    def format(self, min_severity: Severity = Severity.INFO) -> str:
        lines = [f.format() for f in self.findings
                 if f.severity >= min_severity]
        if not lines:
            return "%s: no findings" % self.context
        counts = {}
        for f in self.findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        head = "%s: %s" % (self.context, ", ".join(
            "%d %s" % (counts[s], s) for s in sorted(counts, reverse=True)))
        return "\n".join([head] + lines)

    # --------------------------------------------------------- strictness
    def enforce(self, mode: str, logger=None) -> "Report":
        """Apply the ``MXNET_TPU_ANALYZE`` contract: ``warn`` logs every
        WARNING+ finding, ``strict`` additionally raises ``MXNetError``
        when any ERROR finding exists."""
        import logging
        from ..base import MXNetError
        log = logger or logging.getLogger(__name__)
        for f in self.at_least(Severity.WARNING):
            log.warning("%s: %s", self.context, f.format())
        if mode == "strict" and self.errors:
            raise MXNetError(
                "%s: %d ERROR finding(s) under MXNET_TPU_ANALYZE=strict:\n%s"
                % (self.context, len(self.errors),
                   "\n".join(f.format() for f in self.errors)))
        return self
