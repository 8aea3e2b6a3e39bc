"""TunedConfig persistence.

The port of the reference package's ``tune/store.py``. A search result
is only worth its wall-clock if a RESTART gets it for free: the winning
:class:`TunedConfig` is written as JSON into ``aot.config_store_dir()``
(``MXNET_TPU_TUNE_STORE``), keyed by ``aot.digest`` over the symbol
JSON, shapes, optimizer statics, budget, device count and amp policy,
mixed with the torch/CUDA/device fingerprint. ``fit(tune="auto")`` in a
restarted process loads the record and trains under its knobs with no
search. (The reference's store sits beside its serialized executables,
so its restart compiles nothing either; the port's executable cache is
ROADMAP.md queue A4d.)
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import profiler as _profiler
from .space import Candidate

__all__ = ["TunedConfig", "program_key", "store_config", "load_config"]

STORE_VERSION = 1


@dataclass
class TunedConfig:
    """The search's winner plus its provenance."""
    candidate: Candidate
    key: str = ""
    source: str = "default"        # probe | static | default
    score: Optional[Dict[str, Any]] = None
    baseline: Optional[Dict[str, Any]] = None   # the default's probe
    searched_s: float = 0.0
    n_probed: int = 0
    n_pruned: int = 0
    audit: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"version": STORE_VERSION, "key": self.key,
                "source": self.source,
                "candidate": self.candidate.to_dict(),
                "score": self.score, "baseline": self.baseline,
                "searched_s": round(self.searched_s, 3),
                "n_probed": self.n_probed, "n_pruned": self.n_pruned,
                "audit": self.audit}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedConfig":
        return cls(candidate=Candidate.from_dict(d.get("candidate")
                                                 or {}),
                   key=str(d.get("key", "")),
                   source=str(d.get("source", "default")),
                   score=d.get("score"), baseline=d.get("baseline"),
                   searched_s=float(d.get("searched_s", 0.0)),
                   n_probed=int(d.get("n_probed", 0)),
                   n_pruned=int(d.get("n_pruned", 0)),
                   audit=list(d.get("audit") or []))


def program_key(symbol_json: str, data_shapes, label_shapes,
                optimizer: str, optimizer_params, budget,
                n_devices: int, amp: Optional[str] = None) -> str:
    """The store key: everything that makes a tuned record applicable,
    with the device fingerprint (``aot.digest``) mixed in — a record
    never outlives the programs it tuned. ``amp`` names the mixed
    precision policy (``"bfloat16"``), None when it is off."""
    from .. import aot
    parts = (
        "tune", symbol_json,
        sorted((str(n), tuple(s)) for n, s in data_shapes),
        sorted((str(n), tuple(s)) for n, s in (label_shapes or [])),
        str(optimizer), sorted(dict(optimizer_params or {}).items()),
        str(budget or ""), int(n_devices))
    if amp:
        parts += ("amp=%s" % amp,)
    return aot.digest(parts)


def _path(key: str) -> Optional[str]:
    from .. import aot
    d = aot.config_store_dir()
    if not d:
        return None
    return os.path.join(d, "tune-%s.json" % key)


def store_config(cfg: TunedConfig) -> Optional[str]:
    """Atomically persist ``cfg``; returns the path, or None when no
    store directory is configured."""
    path = _path(cfg.key)
    if path is None:
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    from ..checkpoint.atomic import atomic_open
    with atomic_open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=1, sort_keys=True)
    _profiler.incr_counter("tune_store_write")
    return path


def load_config(key: str) -> Optional[TunedConfig]:
    """The stored record for ``key``, or None (missing store dir,
    missing/corrupt record, or a version from the future)."""
    path = _path(key)
    if path is None or not os.path.exists(path):
        _profiler.incr_counter("tune_store_miss")
        return None
    try:
        with open(path) as f:
            d = json.load(f)
        if int(d.get("version", 0)) > STORE_VERSION:
            _profiler.incr_counter("tune_store_miss")
            return None
        cfg = TunedConfig.from_dict(d)
    except (OSError, ValueError, KeyError):
        _profiler.incr_counter("tune_store_miss")
        return None
    _profiler.incr_counter("tune_store_hit")
    return cfg
