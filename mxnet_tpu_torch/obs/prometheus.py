"""Prometheus text-format exposition of the profiler registries.

The port's copy of the reference package's ``obs/prometheus.py``: the
same metric names (default prefix ``mxnet_tpu``), so one scrape config
reads both packages.

``render_prometheus()`` turns the always-on counters/gauges/histograms
(:mod:`mxnet_tpu_torch.profiler`) into the Prometheus text format
(version 0.0.4): counters get a ``_total`` suffix, histograms emit the
standard cumulative ``_bucket{le="..."}`` / ``_sum`` / ``_count`` triple
(sparse: only buckets that hold observations, plus the mandatory
``+Inf``). ``parse_prometheus()`` is the matching pure-Python grammar
check the tests run on the rendered text — no external scrape client
needed to prove the exposition is well-formed.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

from .. import profiler as _profiler

__all__ = ["render_prometheus", "parse_prometheus", "pod_labels"]

_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, name: str) -> str:
    n = _SANITIZE_RE.sub("_", str(name))
    if n and n[0].isdigit():
        n = "_" + n
    return "%s_%s" % (prefix, n)


def _fmt(v) -> str:
    f = float(v)
    if not math.isfinite(f):
        # the text format's spellings — parse_prometheus round-trips them
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def pod_labels() -> Dict[str, str]:
    """Per-process identity labels when a ``torch.distributed`` process
    group of more than one process is up (empty otherwise): every
    process scrapes the same metric names, so without these labels
    federated scrapes would collide. A pure state probe."""
    import sys
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is None or not dist.is_available() or \
                not dist.is_initialized():
            return {}
        rank, world = dist.get_rank(), dist.get_world_size()
    except Exception:                                      # noqa: BLE001
        return {}
    if world <= 1:
        return {}
    return {"process_index": str(rank), "world_size": str(world)}


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = ['%s="%s"' % (k, v) for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{%s}" % ",".join(parts) if parts else ""


def render_prometheus(prefix: str = "mxnet_tpu",
                      labels: Optional[Dict[str, str]] = None) -> str:
    """One scrape body over every registered counter, gauge and
    histogram. Metric names are ``<prefix>_<sanitized registry key>``.

    ``labels`` are attached to every sample; by default they are the
    pod identity labels (:func:`pod_labels` — ``process_index`` /
    ``world_size`` under multi-host, nothing single-process), so
    per-host telemetry federates instead of colliding. Pass ``{}`` to
    force bare samples."""
    if labels is None:
        labels = pod_labels()
    lab = _label_str(labels)
    lines = []
    for name, v in sorted(_profiler.counters().items()):
        m = _metric_name(prefix, name)
        if not m.endswith("_total"):    # registry keys like
            m += "_total"               # obs_bind_ms_total keep one suffix
        lines.append("# TYPE %s counter" % m)
        lines.append("%s%s %s" % (m, lab, _fmt(v)))
    for name, v in sorted(_profiler.gauges().items()):
        m = _metric_name(prefix, name)
        lines.append("# TYPE %s gauge" % m)
        lines.append("%s%s %s" % (m, lab, _fmt(v)))
    for name, h in sorted(_profiler.histograms().items()):
        snap = h.snapshot()
        m = _metric_name(prefix, name)
        lines.append("# TYPE %s histogram" % m)
        cum = 0
        for bound, c in zip(snap["bounds"], snap["counts"]):
            cum += c
            if c:
                lines.append('%s_bucket%s %d'
                             % (m, _label_str(labels,
                                              'le="%.6g"' % bound), cum))
        lines.append('%s_bucket%s %d'
                     % (m, _label_str(labels, 'le="+Inf"'),
                        snap["count"]))
        lines.append("%s_sum%s %s" % (m, lab, _fmt(snap["sum"])))
        lines.append("%s_count%s %d" % (m, lab, snap["count"]))
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- grammar check

_METRIC_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    r"^(?P<name>%s)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?$" % _METRIC_RE)
_LABEL_RE = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')
_COMMENT_RE = re.compile(
    r"^# (?:HELP %s .*|TYPE %s (?:counter|gauge|histogram|summary|"
    r"untyped))$" % (_METRIC_RE, _METRIC_RE))


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)       # raises ValueError on garbage


def parse_prometheus(text: str) \
        -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Strict parse of a text-format exposition; raises ``ValueError``
    on any malformed line. Returns ``{(metric, sorted label tuple):
    value}`` so tests can assert on specific samples."""
    samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for lineno, line in enumerate(text.split("\n"), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not _COMMENT_RE.match(line):
                raise ValueError(
                    "line %d: malformed comment/metadata: %r"
                    % (lineno, line))
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError("line %d: malformed sample: %r"
                             % (lineno, line))
        labels: Tuple[Tuple[str, str], ...] = ()
        raw = m.group("labels")
        if raw is not None:
            pairs = []
            rest = raw
            while rest:
                lm = _LABEL_RE.match(rest)
                if lm is None:
                    raise ValueError("line %d: malformed labels: %r"
                                     % (lineno, raw))
                pairs.append((lm.group("k"), lm.group("v")))
                rest = rest[lm.end():]
                if rest.startswith(","):
                    rest = rest[1:]
                elif rest:
                    raise ValueError("line %d: malformed labels: %r"
                                     % (lineno, raw))
            labels = tuple(sorted(pairs))
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError("line %d: malformed value: %r"
                             % (lineno, m.group("value")))
        samples[(m.group("name"), labels)] = value
    return samples


def sample(samples, name: str, **labels) -> Optional[float]:
    """Convenience lookup into :func:`parse_prometheus` output."""
    return samples.get((name, tuple(sorted(labels.items()))))
