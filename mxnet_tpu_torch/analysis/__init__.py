"""``mxnet_tpu_torch.analysis`` — static graph analysis, as far as the
compile levers need it.

The port's part of the reference's ``analysis/`` package:
:func:`analyze_symbol` runs the graph passes over a ``Symbol`` with
bind-time shapes: the node-wise shape pass (``shape-error``), the
``cost-model`` pass (FLOPs, bytes and the liveness peak, read by
``Module.analyze`` and the MFU gauge) and the memory pass
``remat-opportunity``, whose suggestion ``MXNET_TPU_REMAT=auto``
applies (:mod:`..remat`). Findings share the reference's
:class:`Finding` / :class:`Report` / :class:`Severity` vocabulary and
each bumps the ``analysis_<code>`` counter. The other passes, the
program and sharding analyzers, the lint and the CLI are queue A10b (the
sharding passes A9).
"""
from __future__ import annotations

from .findings import Finding, Report, Severity
from .graph_passes import GRAPH_PASSES, GraphContext, analyze_symbol
# importing memory_passes registers remat-opportunity into GRAPH_PASSES
# (after the shape pass it reads)
from . import memory_passes

__all__ = ["Finding", "Report", "Severity", "GraphContext",
           "analyze_symbol", "GRAPH_PASSES", "memory_passes"]
