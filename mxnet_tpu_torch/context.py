"""Device contexts: ``cpu()`` and ``gpu(i)`` as ``torch.device``, and the
default-device scope.

Entry points of the port run on the card unless the caller asks for the
CPU: :func:`resolve_device` maps ``None`` to :func:`current_device` —
the innermost :func:`device_scope`, else ``cuda:0`` — and raises when
no GPU is present. It never falls back to the CPU quietly, so a run
that meant to measure the card cannot end up measuring the host.

:func:`device_scope` is the port's form of the reference's ``with
mx.cpu():`` (``Context.__enter__`` and ``current_context()``): a
``torch.device`` cannot be a context manager, so the scope is a
function. It is per thread, as the reference's is.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Union

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "current_device", "device_scope",
           "resolve_device", "DeviceLike"]

DeviceLike = Union[None, str, int, torch.device]

_scopes = threading.local()


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
            "no CUDA device is available; pass device='cpu' (ctx=mt.cpu()) "
            "or enter mt.device_scope('cpu') to run the port on the host")
    return gpu(0)


def _stack() -> List[torch.device]:
    stack = getattr(_scopes, "stack", None)
    if stack is None:
        stack = _scopes.stack = []
    return stack


def current_device() -> torch.device:
    """The innermost :func:`device_scope` of this thread, else
    :func:`default_device`."""
    stack = _stack()
    return stack[-1] if stack else default_device()


@contextlib.contextmanager
def device_scope(device: DeviceLike) -> Iterator[torch.device]:
    """Make ``device`` the default of every entry point called inside
    the ``with`` block on this thread: ``with mt.device_scope("cpu"):``
    (the reference's ``with mx.cpu():``)."""
    dev = resolve_device(device if device is not None else "cuda")
    stack = _stack()
    stack.append(dev)
    try:
        yield dev
    finally:
        stack.pop()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Normalize a device argument. ``None`` means :func:`current_device`;
    an explicit CUDA device must exist."""
    if device is None:
        return current_device()
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
