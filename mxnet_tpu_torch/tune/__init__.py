"""mxnet_tpu_torch.tune — the configuration autotuner.

The port of the reference package's ``tune/``. Given a module, an
optimizer, a batch source and a memory budget, :func:`search` finds the
training configuration — remat policy x ``grad_accum`` x
scan-over-layers x grouped update x async window (x a parallel layout,
which needs ROADMAP.md queue A9: on one device the space holds only
``layout=None``) — in three phases:

1. **enumerate** the knob space (:mod:`.space`);
2. **prune statically** with the analysis cost and memory models
   (:mod:`.prune` over ``analysis.tuning``) — configurations that cannot
   bind under the budget are rejected without a training step;
3. **confirm empirically** with short obs-instrumented probe
   subprocesses under hard deadlines (:mod:`.probe`), scored by
   ``obs_mfu`` and steps per second.

The winner is stored (:mod:`.store`, keyed by ``aot.digest``), so
``fit(tune="auto")`` in a restarted process applies it with no search.

The package loads lazily and only when the tuner is armed: with
``MXNET_TPU_TUNE`` unset, a ``fit`` imports no ``mxnet_tpu_torch.tune``
module and bumps no ``tune*`` counter. CLI:
``python -m mxnet_tpu_torch.tune --net mlp --budget 16G``.
"""
from __future__ import annotations

from .probe import make_spec, run_probe
from .search import search
from .space import Candidate, DEFAULT, enumerate_space
from .store import TunedConfig, load_config, program_key, store_config

__all__ = [
    "search", "Candidate", "DEFAULT", "enumerate_space",
    "TunedConfig", "program_key", "load_config", "store_config",
    "make_spec", "run_probe", "tune_fit",
]


def _desc(d):
    """``(name, shape)`` of a ``DataDesc`` or of a pair."""
    if hasattr(d, "name"):
        return d.name, tuple(d.shape)
    return d[0], tuple(d[1])


def tune_fit(module, train_data, optimizer, optimizer_params,
             mode: str = "auto", budget=None, seed: int = 0):
    """``fit(tune=...)``'s backend: search (or load) the tuned config
    for this module's program and return the :class:`TunedConfig`.

    ``train_data`` must expose ``provide_data`` / ``provide_label``. The
    module is NOT changed here: ``fit`` applies the winner's knobs itself
    so explicit user arguments keep precedence. The probes train on the
    module's device."""
    import numpy as np

    data_shapes = [_desc(d) for d in train_data.provide_data]
    label_desc = getattr(train_data, "provide_label", None) or []
    label_shapes = [_desc(d) for d in label_desc]

    def _dtypes(descs):
        out = {}
        for d in descs:
            dt = getattr(d, "dtype", None)
            if dt is not None:
                out[_desc(d)[0]] = np.dtype(dt).name
        return out

    device = getattr(module, "_device", None)
    return search(
        module.symbol, data_shapes, label_shapes,
        optimizer=optimizer if isinstance(optimizer, str)
        else type(optimizer).__name__.lower(),
        optimizer_params=dict(optimizer_params or {}), budget=budget,
        n_devices=1, mode=mode, seed=seed,
        data_dtypes=_dtypes(train_data.provide_data),
        label_dtypes=_dtypes(label_desc),
        log=module.logger.info if hasattr(module, "logger") else None,
        device=device)
