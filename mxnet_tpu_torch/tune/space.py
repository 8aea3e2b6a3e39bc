"""The tuner's knob space: one frozen :class:`Candidate` per point.

The port's copy of the reference package's ``tune/space.py``. A
candidate is exactly the set of performance levers a restart can
re-apply from a stored record: remat policy x grad_accum x
scan-over-layers x grouped update x async window x ``SpecLayout``
factorization. :func:`enumerate_space` yields the cross product in a
deterministic order with the DEFAULT configuration first — the search
always probes the default, so the winner is >= default by construction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Candidate", "DEFAULT", "enumerate_space", "GRAD_ACCUMS"]

# the microbatching ladder
GRAD_ACCUMS = (1, 2, 4, 8)


@dataclass(frozen=True)
class Candidate:
    """One point of the knob space. :meth:`order_key` is the
    deterministic tie-break (field order, with ``layout=None`` mapped
    to the empty tuple); the dataclass itself is deliberately NOT
    ``order=True`` — comparing a ``layout`` of None against a tuple
    raises TypeError, exactly when candidates tie on a score prefix."""
    remat: str = "off"            # off | auto | a checkpoint-policy name
    grad_accum: int = 1
    scan_layers: str = "auto"     # off | auto
    group_update: bool = True
    async_window: int = 2
    layout: Optional[Tuple[int, int, int]] = None   # (data, fsdp, tp)

    def order_key(self) -> tuple:
        """Total-orderable deterministic sort tail: field order, the
        default arm of each knob first, ``layout=None`` below any
        factorization (None -> ``()``)."""
        return (self.remat, self.grad_accum, self.scan_layers,
                not self.group_update, self.async_window,
                self.layout or ())

    def knobs(self) -> Dict[str, Any]:
        """The config-knob dict this candidate applies (grad_accum and
        layout are applied through their dedicated Module setters, not
        the environment)."""
        return {
            "MXNET_TPU_REMAT": self.remat,
            "MXNET_TPU_SCAN_LAYERS": self.scan_layers,
            "MXNET_TPU_GROUP_UPDATE": self.group_update,
            "MXNET_TPU_ASYNC_WINDOW": self.async_window,
        }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "remat": self.remat, "grad_accum": self.grad_accum,
            "scan_layers": self.scan_layers,
            "group_update": self.group_update,
            "async_window": self.async_window,
            "layout": list(self.layout) if self.layout else None,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Candidate":
        lay = d.get("layout")
        return cls(remat=str(d.get("remat", "off")),
                   grad_accum=int(d.get("grad_accum", 1)),
                   scan_layers=str(d.get("scan_layers", "auto")),
                   group_update=bool(d.get("group_update", True)),
                   async_window=int(d.get("async_window", 2)),
                   layout=tuple(int(x) for x in lay) if lay else None)


DEFAULT = Candidate()


def enumerate_space(batch_size: int, n_devices: int = 1,
                    remat_policies: Tuple[str, ...] = ("off", "auto"),
                    layouts: Optional[List[Tuple[int, int, int]]] = None,
                    ) -> List[Candidate]:
    """The full candidate list, deterministically ordered with
    :data:`DEFAULT` first. ``grad_accum`` keeps only the ladder rungs
    dividing the batch (the fused step's own contract); ``layouts`` is
    the pre-ranked ``(data, fsdp, tp)`` list from
    ``analysis.tuning.rank_layouts`` (None on a single device)."""
    accums = [n for n in GRAD_ACCUMS if batch_size % n == 0]
    lays: List[Optional[Tuple[int, int, int]]] = [None]
    if n_devices > 1 and layouts:
        lays = [tuple(int(x) for x in la) for la in layouts]
    out: List[Candidate] = [DEFAULT]
    seen = {DEFAULT}
    for lay in lays:
        for remat in remat_policies:
            for accum in accums:
                for scan in ("auto", "off"):
                    for group in (True, False):
                        for window in (2, 0):
                            c = Candidate(
                                remat=remat, grad_accum=accum,
                                scan_layers=scan, group_update=group,
                                async_window=window, layout=lay)
                            if c not in seen:
                                seen.add(c)
                                out.append(c)
    return out
