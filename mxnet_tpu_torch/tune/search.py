"""The search: store-first, statically pruned, empirically confirmed.

The port of the reference package's ``tune/search.py``. Given a
bound-able program
(symbol + shapes + optimizer) and a budget, it:

1. computes the :func:`~.store.program_key` and returns a stored
   :class:`~.store.TunedConfig` immediately when one exists (a restart
   pays ZERO search cost);
2. enumerates the knob space (:func:`~.space.enumerate_space`),
   statically prunes and ranks it against the HBM budget and the comm
   model (:func:`~.prune.static_rank` over ``analysis.tuning``) — no
   compiles spent on configs the model already rejects;
3. probes the default plus the top-ranked survivors in subprocesses
   under per-probe and total deadlines (:mod:`~.probe`), scoring by
   ``obs_mfu`` (steps/s as the denominator-free fallback) with
   ``loop_recompile == 0`` required;
4. persists the winner in the store and returns it.

Determinism: with probing disabled (``mode="static"`` or
``max_probes=0``) the result is a pure function of (program, budget,
space) — the search-determinism test pins this. With probes, rate noise
can reorder near-ties, but the candidate LIST and every static decision
remain reproducible (the audit trail records them), and ties fall back
to static rank order.

The probes and the static model's remat calibration run on ``device``
(None: the card).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from .. import profiler as _profiler
from . import probe as _probe
from .prune import static_rank
from .space import DEFAULT, Candidate, enumerate_space
from .store import TunedConfig, load_config, program_key, store_config

__all__ = ["search"]


def _score_key(score: Dict[str, Any]) -> Tuple[float, float, float]:
    """Higher is better: pod throughput (whole-job view when a pod is
    live; none on one device), then MFU, then raw steps/s."""
    pod = score.get("pod") or {}
    return (float(pod.get("flops_per_sec") or 0.0),
            float(score.get("mfu") or 0.0),
            float(score.get("steps_per_sec") or 0.0))


def search(sym, data_shapes, label_shapes=None, *,
           optimizer: str = "sgd", optimizer_params=None,
           budget: Optional[str] = None, n_devices: int = 1,
           mode: str = "auto", probe_steps: Optional[int] = None,
           probe_deadline_s: Optional[float] = None,
           max_probes: Optional[int] = None, seed: int = 0,
           data_dtypes=None, label_dtypes=None,
           use_store: bool = True, log=None, device=None,
           amp: Optional[str] = None) -> TunedConfig:
    """Tune the training configuration for ``sym``.

    ``data_shapes``/``label_shapes`` are ``[(name, shape), ...]`` as
    bound (batch leading). ``budget`` is an HBM byte budget (``"16G"``
    style, parsed by ``analysis.parse_bytes``) or None for unbudgeted.
    ``mode="static"`` skips probing entirely (deterministic model-only
    winner); ``mode="auto"`` probes. Knob defaults come from
    ``MXNET_TPU_TUNE_PROBE_STEPS`` / ``_PROBE_SECS`` / ``_MAX_PROBES``.
    ``device`` is where the probes train and the remat calibration runs
    (None: the card); ``amp`` names the amp policy the program trains
    under (None: this process's), a part of the store key.
    """
    from .. import config as _config
    from ..analysis.memory_passes import parse_bytes
    from ..analysis import tuning as _tuning

    t0 = time.perf_counter()
    if log is None:
        def log(msg):
            pass

    if probe_steps is None:
        probe_steps = int(_config.get("MXNET_TPU_TUNE_PROBE_STEPS"))
    if probe_deadline_s is None:
        probe_deadline_s = float(_config.get("MXNET_TPU_TUNE_PROBE_SECS"))
    if max_probes is None:
        max_probes = int(_config.get("MXNET_TPU_TUNE_MAX_PROBES"))
    if mode == "static":
        max_probes = 0

    symbol_json = sym.tojson()
    data_shapes = [(str(n), tuple(int(d) for d in s))
                   for n, s in data_shapes]
    label_shapes = [(str(n), tuple(int(d) for d in s))
                    for n, s in (label_shapes or [])]
    optimizer_params = dict(optimizer_params or {})
    precision = _probe._precision()
    if amp is None:
        amp = precision["amp"]
    else:
        precision["amp"] = amp
    key = program_key(symbol_json, data_shapes, label_shapes, optimizer,
                      optimizer_params, budget, n_devices, amp=amp)

    if use_store:
        stored = load_config(key)
        if stored is not None:
            log("tune: stored config hit (%s)" % key[:12])
            return stored

    budget_bytes = parse_bytes(budget) if budget else None
    batch = int(data_shapes[0][1][0])

    # ---- static phase: enumerate, model-prune, rank -----------------
    layout_rank = None
    layouts = None
    if n_devices > 1:
        rep1 = _tuning.cost_report(
            sym, dict(data_shapes + label_shapes),
            batch_inputs=[n for n, _ in data_shapes + label_shapes],
            device=device)
        cost = rep1.extras.get("cost") or {}
        param_bytes = max(0, int(cost.get("bound_bytes") or 0))
        act_bytes = max(0, int(cost.get("activation_peak_bytes") or 0))
        layout_rank = _tuning.rank_layouts(n_devices, param_bytes,
                                           act_bytes)
        layouts = [(r["data"], r["fsdp"], r["tp"])
                   for r in layout_rank]

    space = enumerate_space(batch, n_devices=n_devices,
                            layouts=layouts)
    ranked, audit = static_rank(
        sym, dict(data_shapes + label_shapes),
        [n for n, _ in data_shapes + label_shapes], space,
        budget_bytes=budget_bytes, layout_rank=layout_rank, device=device)
    n_pruned = len(space) - len(ranked)
    log("tune: %d candidates, %d survive the static model"
        % (len(space), len(ranked)))

    if not ranked:
        # nothing binds under the budget: surface the default with the
        # audit trail rather than failing — the caller sees why
        cfg = TunedConfig(candidate=DEFAULT, key=key, source="default",
                          searched_s=time.perf_counter() - t0,
                          n_pruned=n_pruned, audit=audit)
        if use_store:
            store_config(cfg)
        return cfg

    static_winner = ranked[0]

    # ---- empirical phase: probe the default + the ranked frontier ---
    to_probe: List[Candidate] = []
    if max_probes > 0:
        # the default is always probed IN ADDITION to the max_probes
        # budget (the MXNET_TPU_TUNE_MAX_PROBES contract: the winner is
        # >= default by construction, and even max_probes=1 gives one
        # ranked candidate an empirical shot), then the static frontier
        # in rank order
        to_probe = [DEFAULT] + [c for c in ranked
                                if c != DEFAULT][:int(max_probes)]

    scores: Dict[Candidate, Dict[str, Any]] = {}
    if to_probe:
        specs = [_probe.make_spec(symbol_json, data_shapes,
                                  label_shapes, data_dtypes or {},
                                  label_dtypes or {}, optimizer,
                                  optimizer_params, c, probe_steps,
                                  seed=seed,
                                  device="cuda" if device is None
                                  else str(device),
                                  precision=precision)
                 for c in to_probe]

        def _plog(spec, score):
            log("tune: probe %s -> %s"
                % (spec["candidate"],
                   {k: score.get(k) for k in
                    ("ok", "mfu", "steps_per_sec", "wall_s", "why")
                    if score.get(k) is not None}))

        results = _probe.probe_many(
            specs, probe_deadline_s,
            total_deadline_s=probe_deadline_s * len(specs), log=_plog)
        for cand, res in zip(to_probe, results):
            if res is not None:
                scores[cand] = res

    ok_scores = {c: s for c, s in scores.items() if s.get("ok")}
    audit.extend({**c.to_dict(), "fate": "probed", "score": s}
                 for c, s in scores.items())

    if ok_scores:
        # static rank is the deterministic tie-break: sort candidates
        # by rank first, then take the max by score (max keeps the
        # FIRST of equals)
        order = {c: i for i, c in enumerate(ranked)}
        order.setdefault(DEFAULT, len(ranked))
        winner = max(sorted(ok_scores, key=lambda c: order[c]),
                     key=lambda c: _score_key(ok_scores[c]))
        cfg = TunedConfig(candidate=winner, key=key, source="probe",
                          score=ok_scores[winner],
                          baseline=scores.get(DEFAULT),
                          searched_s=time.perf_counter() - t0,
                          n_probed=len(scores), n_pruned=n_pruned,
                          audit=audit)
    else:
        # every probe failed or probing was off: the static model's
        # pick stands (deterministic)
        cfg = TunedConfig(candidate=static_winner, key=key,
                          source="static",
                          searched_s=time.perf_counter() - t0,
                          n_probed=len(scores), n_pruned=n_pruned,
                          audit=audit)
    if use_store:
        store_config(cfg)
    _profiler.incr_counter("tune_search")
    return cfg
