"""Machine-readable candidate lists for the autotuner.

The port of the reference's ``analysis/tuning.py``. The analyzer's
passes report *findings* — prose for humans plus ``Report.extras`` for
tools. The autotuner's static pruner (``tune/``, ROADMAP A10d) needs
the extras shaped as *ranked candidate lists* it can iterate, score and
reject without parsing messages. This module is that adapter layer: pure
functions over the existing cost/remat/comm models, no new estimators.

* :func:`cost_report` — one analyzer run per (symbol, shapes,
  grad_accum) with the cost + memory passes, remat calibration on.
* :func:`peak_bytes` / :func:`remat_candidates` — the pruner's inputs:
  the static HBM high-water and the ordered remat policy ladder with
  calibrated ``est_peak_saving``.
* :func:`rank_layouts` — every ``data x fsdp x tp`` factorization of the
  device count, ranked by analytic per-device collective bytes
  (:func:`comm_link_bytes` ring counts — a copy of the reference's
  ``sharding_passes.comm_link_bytes``, the model its HLO collective
  walk prices with) with a per-device memory estimate for the budget
  check.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .findings import Report
from .graph_passes import analyze_symbol

__all__ = ["cost_report", "peak_bytes", "remat_candidates",
           "rank_layouts", "comm_link_bytes"]

# optimizer state multiplier for the per-device memory estimate: params
# + gradient + the two Adam-class moments (SGD carries less — this is a
# budget check, so the conservative bound is the useful one)
_PARAM_STATE_MULT = 4


def cost_report(sym, input_shapes, input_dtypes=None, grad_accum=1,
                batch_inputs=None, device=None) -> Report:
    """One static analysis of ``sym`` at the given microbatching factor:
    cost model (microbatch-aware liveness), remat opportunity with
    calibration forced on (the tuner needs ``est_peak_saving`` to order
    remat candidates even when no remat knob is set; it runs one block
    on ``device``, None: the card), and hbm-budget."""
    return analyze_symbol(
        sym, input_shapes=input_shapes, input_dtypes=input_dtypes,
        passes=("shape-error", "cost-model", "remat-opportunity",
                "hbm-budget"),
        context="tune", calibrate_remat=True, grad_accum=grad_accum,
        batch_inputs=batch_inputs, device=device)


def peak_bytes(report: Report) -> Optional[int]:
    """The static per-device HBM high-water (bound buffers + activation
    peak) the hbm-budget pass enforces; None when shapes were too
    partial to price."""
    cost = report.extras.get("cost")
    if not cost or not cost.get("peak_bytes"):
        return None
    return int(cost["peak_bytes"])


def remat_candidates(report: Report) -> List[Dict[str, Any]]:
    """The remat policy ladder for this graph, strongest saving first:
    ``[{"policy", "est_peak_saving", "est_bytes_saved", "wrap"}, ...]``
    plus the implicit ``{"policy": "off"}`` entry (always first — remat
    costs recompute FLOPs, so "off" is the default until memory forces a
    rung down the ladder)."""
    out: List[Dict[str, Any]] = [
        {"policy": "off", "est_peak_saving": 0, "est_bytes_saved": 0,
         "wrap": None}]
    remat = report.extras.get("remat") or {}
    sug = remat.get("suggestion")
    if sug and sug.get("policy"):
        out.append({
            "policy": str(sug["policy"]),
            "est_peak_saving": int(sug.get("est_peak_saving") or 0),
            "est_bytes_saved": int(sug.get("est_bytes_saved") or 0),
            "wrap": sug.get("wrap"),
        })
    return out


def comm_link_bytes(kind: str, nbytes: int, group_size: int) -> int:
    """Bytes crossing the busiest link for one collective over a ring of
    ``group_size`` devices moving an ``nbytes`` buffer (the standard
    ring-algorithm counts; the model behind the per-axis time
    estimates)."""
    n = max(1, int(group_size))
    if n == 1:
        return 0
    if kind == "all-reduce":
        return int(2 * nbytes * (n - 1) / n)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return int(nbytes * (n - 1) / n)
    if kind == "collective-permute":
        return int(nbytes)
    return int(nbytes)


def _factorizations(n: int) -> List[tuple]:
    out = []
    for fsdp in range(1, n + 1):
        if n % fsdp:
            continue
        rest = n // fsdp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            out.append((rest // tp, fsdp, tp))
    return out


def rank_layouts(n_devices: int, param_bytes: int,
                 activation_bytes: int,
                 max_tp: Optional[int] = None) -> List[Dict[str, Any]]:
    """Every ``(data, fsdp, tp)`` factorization of ``n_devices``, ranked
    by analytic per-device collective bytes per step:

    * data axis — ring all-reduce of the gradients across ``data``;
    * fsdp axis — all-gather of the parameters (forward) plus
      reduce-scatter of the gradients across ``fsdp``;
    * tp axis — per-layer activation all-reduces, priced on the
      activation high-water as the proxy buffer.

    Each record carries ``mem_bytes``: the per-device resident estimate
    (params + grads + optimizer moments sharded over ``fsdp x tp``,
    activations sharded over the batch axes) the pruner checks against
    the HBM budget. Ties (and the ranking itself) are deterministic:
    sorted by (comm_bytes, mem_bytes, -data)."""
    recs = []
    for data, fsdp, tp in _factorizations(max(1, int(n_devices))):
        if max_tp is not None and tp > max_tp:
            continue
        comm = (comm_link_bytes("all-reduce", param_bytes, data)
                + comm_link_bytes("all-gather", param_bytes, fsdp)
                + comm_link_bytes("reduce-scatter", param_bytes, fsdp)
                + comm_link_bytes("all-reduce", activation_bytes, tp))
        mem = (param_bytes * _PARAM_STATE_MULT) // max(1, fsdp * tp) \
            + activation_bytes // max(1, data * fsdp)
        recs.append({"data": data, "fsdp": fsdp, "tp": tp,
                     "comm_bytes": int(comm), "mem_bytes": int(mem)})
    recs.sort(key=lambda r: (r["comm_bytes"], r["mem_bytes"],
                             -r["data"]))
    return recs
