"""``mxnet_tpu_torch.analysis`` — static graph/program/efficiency analysis.

The port of the reference's ``analysis/`` package (its sharding passes
are ROADMAP A9), all sharing one Finding/Report/Severity vocabulary:

* :func:`analyze_symbol` — graph passes over ``Symbol`` DAGs run before
  a bind (cycle / dup-name / dead-node / shape-error / cost-model),
  joined by the **memory passes** (``remat-opportunity``, whose
  suggestion ``MXNET_TPU_REMAT=auto`` applies, and the enforceable
  ``hbm-budget`` — ``MXNET_TPU_ANALYZE_HBM_BUDGET``). Also exposed as
  ``Symbol.analyze()`` and ``Module.analyze()``.
* :func:`analyze_program` — hazard checks over the aten graph a
  fake-tensor trace of a function captured (baked-const / f64-promotion
  / host-callback / donation); :func:`analyze_program_memory` — liveness
  over the same graph (the activation high-water).
* :mod:`.roofline` — the counted cost of one run of a program against
  the analysis FLOP model (``flop-model-drift``), compute- vs
  memory-bound classification, and the ``mt.obs.report()``
  reconciliation that puts a "why" next to every ``obs_mfu`` number.
* :mod:`.tuning` — the cost, remat and layout candidate lists an
  autotuner ranks.
* :func:`lint_paths` — AST concurrency/perf lint for the codebase itself
  (lock-host-sync / lock-dispatch / wall-clock / eager-loop-sync /
  signal-unsafe), with inline ``# mx-lint: allow(code)`` suppressions
  and a CI baseline (``mxnet_tpu_torch/tools/analysis_baseline.json``)
  that fails on drift in either direction.
* :mod:`.concurrency` — the whole-program lock-order pass riding the
  same lint entry points (``lock-order-cycle``, interprocedural
  ``lock-host-sync``, ``unlocked-shared-state``); its runtime twin is
  ``mxnet_tpu_torch.lockcheck``.

Bind-time enforcement rides the ``MXNET_TPU_ANALYZE=off|warn|strict``
knob (:func:`check_bind`, called from ``Executor.__init__`` and from
``Symbol.simple_bind`` before it allocates): ``warn`` logs WARNING+
findings, ``strict`` raises ``MXNetError`` on ERROR findings —
including an over-``MXNET_TPU_ANALYZE_HBM_BUDGET`` bind, rejected
before any array of the bind is allocated. The knob defaults to ``off``
and the hooks import this package lazily, so analysis costs nothing
when disabled.

Every finding increments an always-on profiler counter for its hazard
class (``analysis_<code>``).

CLI: ``python -m mxnet_tpu_torch.analysis {graph,lint,audit,self-check}``.
"""
from __future__ import annotations

from .findings import Finding, Report, Severity
from .graph_passes import GRAPH_PASSES, GraphContext, analyze_symbol
# importing memory_passes registers remat-opportunity + hbm-budget into
# GRAPH_PASSES (after the cost model they read)
from .memory_passes import analyze_program_memory, parse_bytes
from .program_passes import analyze_graph, analyze_program
from .lint import (baseline_key, diff_baseline, lint_paths, lint_source,
                   load_baseline, stale_baseline, write_baseline)
from .concurrency import analyze_sources
from . import concurrency, memory_passes, roofline, tuning

__all__ = [
    "Finding", "Report", "Severity", "GraphContext",
    "analyze_symbol", "analyze_program", "analyze_graph",
    "analyze_program_memory", "parse_bytes",
    "memory_passes", "roofline", "concurrency", "tuning",
    "lint_paths", "lint_source", "analyze_sources",
    "load_baseline", "write_baseline", "diff_baseline", "stale_baseline",
    "baseline_key",
    "check_bind", "GRAPH_PASSES",
]


def check_bind(symbol, input_shapes=None, input_dtypes=None,
               mode: str = "warn", context: str = "bind") -> Report:
    """The bind-time verification hook (``MXNET_TPU_ANALYZE``): run the
    graph passes (structural + cost + memory/budget) with the bind's
    shapes and enforce the mode contract — ``warn`` logs, ``strict``
    raises on ERROR findings. Returns the Report so callers (tests,
    tools) can inspect what fired. The remat pass's calibration, which
    runs one block on the card, stays off: the check computes nothing."""
    report = analyze_symbol(symbol, input_shapes=input_shapes,
                            input_dtypes=input_dtypes, context=context,
                            calibrate_remat=False)
    return report.enforce(mode)
