"""Device contexts: ``cpu()`` and ``gpu(i)`` as ``torch.device``.

Entry points of the port run on the card unless the caller asks for the
CPU: :func:`resolve_device` maps ``None`` to ``cuda:0`` and raises when
no GPU is present — it never falls back to the CPU quietly, so a run
that meant to measure the card cannot end up measuring the host.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device", "DeviceLike"]

DeviceLike = Union[None, str, int, torch.device]


def cpu(device_id: int = 0) -> torch.device:
    """The host CPU (``device_id`` is accepted for MXNet API parity)."""
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    """CUDA device ``device_id``."""
    return torch.device("cuda", int(device_id))


def default_device() -> torch.device:
    """``cuda:0``; raises when no GPU is visible."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port on the host")
    return gpu(0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Normalize a device argument. ``None`` means :func:`default_device`;
    an explicit CUDA device must exist."""
    if device is None:
        return default_device()
    dev = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("device %s requested but no CUDA device is "
                             "available" % (dev,))
        if dev.index is None:
            dev = gpu(0)
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cpu or cuda)" % (dev,))
    return dev
