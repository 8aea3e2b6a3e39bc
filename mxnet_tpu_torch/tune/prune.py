"""Static pruning and ranking of the candidate space (the cheap half of
the search: no training step, no subprocess).

The port of the reference package's ``tune/prune.py``, over the port's
cost and memory model (``analysis.tuning``). Three rejections and
orderings:

* **hbm-budget**: a candidate whose static peak (microbatch-aware
  liveness at its ``grad_accum``, minus its remat policy's calibrated
  ``est_peak_saving``, over its layout's per-device sharding) exceeds
  the budget cannot bind — rejected, counted ``tune_pruned``.
* **comm ranking**: layout candidates inherit their
  ``analysis.tuning.rank_layouts`` collective-bytes rank.
* **overhead ordering**: among survivors, prefer the cheaper mechanism
  — no remat over remat (recompute FLOPs), small ``grad_accum`` over
  large, scan+group+async defaults over their off arms — so the probe
  budget is spent on the plausible frontier.

The port's model counts an eager aten graph, so its peak bytes can
differ from the reference's estimate of the same symbol; the decisions
given the same estimates are the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .. import profiler as _profiler
from .space import Candidate

__all__ = ["static_rank"]


def _remat_saving(report, policy: str) -> int:
    from ..analysis import tuning as _tuning
    for cand in _tuning.remat_candidates(report):
        if cand["policy"] == policy or (
                policy == "auto" and cand["policy"] != "off"):
            return int(cand.get("est_peak_saving")
                       or cand.get("est_bytes_saved") or 0)
    return 0


def static_rank(sym, input_shapes: Dict[str, tuple],
                batch_inputs: List[str],
                candidates: List[Candidate],
                budget_bytes: Optional[int] = None,
                layout_rank: Optional[List[Dict[str, Any]]] = None,
                device=None,
                ) -> Tuple[List[Candidate], List[Dict[str, Any]]]:
    """Order ``candidates`` by the static model and drop the ones that
    cannot bind under ``budget_bytes``. Returns ``(ranked_survivors,
    audit)`` where ``audit`` records every candidate's estimated peak,
    remat saving and fate — the machine-readable trail the CLI prints
    and the store persists. ``device`` is where the remat calibration
    runs its one block (None: the card).

    Deterministic: one analyzer run per distinct ``grad_accum`` (cached
    here), a pure score per candidate, and ``Candidate.order_key()``
    (total-orderable even when layout-None and layout-tuple candidates
    tie on the score prefix) as the final tie-break."""
    from ..analysis import tuning as _tuning

    reports: Dict[int, Any] = {}

    def report_for(accum: int):
        if accum not in reports:
            reports[accum] = _tuning.cost_report(
                sym, input_shapes, grad_accum=accum,
                batch_inputs=batch_inputs, device=device)
        return reports[accum]

    lay_pos = {}
    if layout_rank:
        for i, rec in enumerate(layout_rank):
            lay_pos[(rec["data"], rec["fsdp"], rec["tp"])] = (
                i, rec["comm_bytes"])

    audit: List[Dict[str, Any]] = []
    scored: List[Tuple[tuple, Candidate]] = []
    for cand in candidates:
        rep = report_for(cand.grad_accum)
        peak = _tuning.peak_bytes(rep)
        saving = _remat_saving(rep, cand.remat) if cand.remat != "off" \
            else 0
        # floor at the bound buffers: remat recomputes activations but
        # never erases params or inputs
        bound = int((rep.extras.get("cost") or {})
                    .get("bound_bytes") or 0)
        est_peak = None if peak is None else max(bound, peak - saving)
        n_shard = 1
        comm_rank, comm_bytes = 0, 0
        if cand.layout is not None:
            pos = lay_pos.get(cand.layout)
            if pos is None:
                _profiler.incr_counter("tune_pruned")
                audit.append({**cand.to_dict(), "fate": "pruned",
                              "why": "layout does not factor the mesh"})
                continue
            comm_rank, comm_bytes = pos
            # params shard over fsdp*tp, activations over the batch
            # axes — the coarse per-device divisor for the budget check
            n_shard = max(1, cand.layout[1] * cand.layout[2])
        rec = {**cand.to_dict(),
               "est_peak_bytes": est_peak,
               "est_remat_saving": saving,
               "comm_bytes": comm_bytes}
        if budget_bytes and est_peak is not None \
                and est_peak // n_shard > budget_bytes:
            _profiler.incr_counter("tune_pruned")
            audit.append({**rec, "fate": "pruned",
                          "why": "static peak %d > budget %d"
                                 % (est_peak // n_shard, budget_bytes)})
            continue
        audit.append({**rec, "fate": "kept"})
        # overhead ordering: comm rank first (layouts), then the cheap
        # mechanisms; order_key() is the deterministic tail (the
        # dataclass itself would compare a None layout with a tuple)
        score = (comm_rank,
                 0 if cand.remat == "off" else 1,
                 cand.grad_accum,
                 0 if cand.scan_layers == "auto" else 1,
                 0 if cand.group_update else 1,
                 0 if cand.async_window else 1,
                 cand.order_key())
        scored.append((score, cand))
    scored.sort(key=lambda t: t[0])
    return [c for _, c in scored], audit
