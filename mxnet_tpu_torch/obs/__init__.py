"""``mt.obs`` — unified observability: trace timeline, metrics
exposition, and always-on utilization / compile accounting.

The port's counterpart of the reference package's ``obs/``, with its
names, counters, gauges, histograms and record schemas, so one
dashboard or scrape config reads both packages. Four surfaces, one
package:

* **Spans / lanes / flows** (re-exported from
  :mod:`mxnet_tpu_torch.profiler`, where subsystems record without
  importing obs): ``span()``, ``new_flow()``, ``register_thread_lane()``;
  enabled by the profiler state or the ``MXNET_TPU_OBS`` knob, a shared
  no-op otherwise.
* **Metrics exposition**: ``render_prometheus()`` over the always-on
  counters/gauges/histograms, ``parse_prometheus()`` as the pure-Python
  grammar check, and an opt-in HTTP ``/metrics`` endpoint
  (``start_metrics_server``, started by both servers from their
  ``metrics_port`` or ``MXNET_TPU_OBS_METRICS_PORT``).
* **Compile accounting** (always on, :mod:`.compiles`): every build the
  port makes (``nvcc``, ``g++``, an executor's graph function, a serve
  runner's first bind, ``Predictor.export``) is attributed to the open
  scope and lands in a bounded ring — ``obs_bind_ms`` / ``obs_trace_ms``
  histograms, ``obs_compile_count`` counter.
* **Utilization accounting** (:mod:`.mfu`): modules with a train step
  export ``obs_mfu`` / ``obs_flops_per_sec`` gauges — the analysis cost
  model's FLOPs x measured steps/s between ``report()`` calls.

``report()`` is the one-call snapshot of all of it. The flight
recorder (:mod:`.blackbox`) loads only when its knob is on; the
reference's pod block of ``report()`` (and ``straggler``) arrives with
ROADMAP A9.
"""
from __future__ import annotations

from typing import Any, Dict

from .. import profiler as _profiler
from ..profiler import (span, spans_enabled, new_flow,            # noqa: F401
                        register_thread_lane, Histogram, histogram,
                        observe, counter_delta)
from . import compiles
from .compiles import scope as compile_scope                      # noqa: F401
from .prometheus import (render_prometheus, parse_prometheus,     # noqa: F401
                         pod_labels)
from . import mfu
from .mfu import peak_flops, register_executor                    # noqa: F401
from .http import MetricsServer, start_metrics_server             # noqa: F401

__all__ = [
    "span", "spans_enabled", "new_flow", "register_thread_lane",
    "Histogram", "histogram", "observe", "counter_delta",
    "compile_scope", "compiles",
    "render_prometheus", "parse_prometheus", "pod_labels",
    "mfu", "peak_flops", "register_executor",
    "MetricsServer", "start_metrics_server",
    "report", "probe_score", "blackbox",
]


def __getattr__(name):
    # the flight recorder stays unimported until something arms it:
    # every call site gates on its knob
    if name == "blackbox":
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


def report() -> Dict[str, Any]:
    """One observability snapshot: per-module utilization (this call is
    the rate boundary — see :mod:`.mfu`), roofline reconciliation
    (*why* is MFU what it is — compute- vs memory-bound, attainable vs
    measured; attached when the analysis package is already loaded,
    which the MFU collector's lazy import guarantees whenever there is a
    FLOP count to explain), the compile ring, and the ``obs_*``
    counters/gauges/histogram summaries."""
    executors = mfu.collect()
    import sys
    if __name__.rsplit(".", 1)[0] + ".analysis" in sys.modules:
        from ..analysis import roofline as _roofline
        for rec in executors:
            cost = rec.get("cost") or {}
            if cost.get("flops") and cost.get("bytes_moved"):
                rec["roofline"] = _roofline.explain(
                    cost["flops"], cost["bytes_moved"],
                    measured_mfu=rec.get("mfu"))
    hist = {}
    for name, h in _profiler.histograms().items():
        if not name.startswith("obs_"):
            continue
        snap = h.snapshot()
        hist[name] = {
            "count": snap["count"],
            "sum": round(snap["sum"], 3),
            "max": snap["max"],
            "p50": h.quantile(0.50),
            "p99": h.quantile(0.99),
        }
    out = {
        "executors": executors,
        "compiles": compiles.snapshot(),
        "counters": {k: v for k, v in _profiler.counters().items()
                     if k.startswith("obs_")},
        "gauges": {k: v for k, v in _profiler.gauges().items()
                   if k.startswith("obs_")},
        "histograms": hist,
    }
    labels = pod_labels()
    if labels:
        # several processes: each reports under its own identity
        out["process"] = {"process_index": int(labels["process_index"]),
                          "world_size": int(labels["world_size"])}
    return out


def probe_score() -> Dict[str, Any]:
    """Close the current utilization window and return the compact
    verdict a tuner probe is scored by: the busiest module's
    ``steps_per_sec`` / ``mfu`` / ``flops_per_sec`` and
    ``loop_recompile``. Call once after warm-up to open the window
    (``report()`` works too) and once after the measured region."""
    rep = report()
    best = None
    for rec in rep["executors"]:
        if rec.get("steps_per_sec") and (
                best is None
                or rec["steps_per_sec"] > best["steps_per_sec"]):
            best = rec
    return {
        "steps_per_sec": best["steps_per_sec"] if best else None,
        "mfu": best.get("mfu") if best else None,
        "flops_per_sec": best.get("flops_per_sec") if best else None,
        "pod": rep.get("pod"),
        "loop_recompile": int(
            _profiler.counters().get("loop_recompile", 0)),
    }
