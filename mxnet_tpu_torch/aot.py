"""Program fingerprints and the tuned-config store's directory.

The port's part of the reference package's ``aot.py``: the hashing
helpers the tuner's store keys its records with (:func:`fingerprint`,
:func:`digest`) and the store's directory (:func:`config_store_dir`).

The reference also serializes compiled fused-step executables into
``MXNET_TPU_COMPILE_CACHE`` so that a restarted process skips tracing
and compiling. The port has no such cache yet (ROADMAP.md queue A4d):
:func:`enabled` returns None, and a tuned record is stored only where
``MXNET_TPU_TUNE_STORE`` says.

:func:`fingerprint` hashes what makes a stored record stale wholesale:
the torch and CUDA versions, the device's name, the port's version and
the knobs ops read while they build a program. It is the same in every
process on the same card and tree: no process id, time or TF32 switch
goes into it.
"""
from __future__ import annotations

import hashlib
from typing import Any, Iterable, Optional

__all__ = ["enabled", "config_store_dir", "fingerprint", "digest",
           "TRACE_KNOBS"]

_FORMAT_VERSION = 1

# knobs ops read as they run: a record tuned under one value of them
# timed the other variant of the op
TRACE_KNOBS = ("MXNET_TPU_LAYERNORM_TWO_PASS",)


def enabled() -> Optional[str]:
    """The executable cache's directory: None, as the port has no
    executable cache yet (ROADMAP.md queue A4d)."""
    return None


def config_store_dir() -> Optional[str]:
    """Directory for persisted ``TunedConfig`` records
    (:mod:`mxnet_tpu_torch.tune`): ``MXNET_TPU_TUNE_STORE`` when set,
    else the executable cache's (:func:`enabled`). None = no
    persistence."""
    from . import config as _config
    d = _config.get("MXNET_TPU_TUNE_STORE")
    return d or enabled()


def _device_name() -> str:
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def fingerprint() -> str:
    """What invalidates a stored record wholesale: the format, the torch
    and CUDA versions, the device's name, the port's version and the
    trace-time knobs (:data:`TRACE_KNOBS`)."""
    import torch
    from . import __version__ as port_version
    from . import config as _config
    parts = (
        "v%d" % _FORMAT_VERSION, torch.__version__,
        str(torch.version.cuda), _device_name(), port_version,
    ) + tuple("%s=%r" % (k, _config.get(k)) for k in TRACE_KNOBS)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def digest(parts: Iterable[Any]) -> str:
    """Collision-resistant digest of a program's signature parts (the
    caller supplies the symbol JSON, shapes and dtypes, optimizer
    statics); the :func:`fingerprint` is always mixed in."""
    h = hashlib.sha256(fingerprint().encode())
    for p in parts:
        h.update(b"\x00")
        h.update(repr(p).encode())
    return h.hexdigest()
