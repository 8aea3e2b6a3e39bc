"""Device contexts: :class:`Context` (``cpu(i)``, ``gpu(i)``, ``tpu(i)``)
and the default-device scope.

Entry points of the port run on the card unless the caller asks for the
CPU: :func:`resolve_device` maps ``None`` to :func:`current_device` —
the innermost scope, else ``cuda:0`` — and raises when no GPU is
present. It never falls back to the CPU quietly, so a run that meant to
measure the card cannot end up measuring the host.

A :class:`Context` is the reference's: ``cpu(0)``, ``gpu(0)``, usable
as a ``with`` block (``with mt.cpu():``), printed as ``cpu(0)``. It is
not a ``torch.device`` (which cannot be subclassed), so every entry
point turns it into one through :func:`resolve_device`
(:attr:`Context.device`). A Context equals, and hashes as, the
``torch.device`` it names, in both operand orders: ``gpu(0) ==
torch.device("cuda", 0)``.

``tpu(i)`` is the reference's name for its accelerator; here that is
the CUDA card, so ``tpu(i)`` is ``gpu(i)`` (the reference makes its
``gpu`` an alias of ``tpu`` the other way round). Unlike the
reference, whose :func:`current_context` falls back to ``cpu(0)``, the
port's is :func:`current_device` as a Context: the innermost scope,
else ``gpu(0)``, raising without a GPU.

``with ctx:`` and :func:`device_scope` push onto one stack, per
thread, as the reference's ``Context.__enter__`` is.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context",
           "num_devices", "default_device", "current_device",
           "device_scope", "resolve_device", "DeviceLike"]

_scopes = threading.local()


class Context:
    """A device context: ``Context("cpu", 0)``, ``Context("gpu", 1)``
    (``"tpu"`` and ``"cuda"`` name the card too), or a Context or
    ``torch.device`` to copy."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "tpu": 2, "cuda": 2}

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            device_type, device_id = device_type.type, \
                device_type.index or 0
        if device_type not in Context.devstr2type:
            raise MXNetError("unsupported device type %r (cpu, gpu or tpu)"
                             % (device_type,))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    @property
    def device(self) -> torch.device:
        """The ``torch.device`` this context names (every ``cpu(i)`` is
        the one host device torch has)."""
        if self.device_typeid == 1:
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_typeid, self.device_id) == \
                (other.device_typeid, other.device_id)
        if isinstance(other, torch.device):
            return self.device == Context(other).device
        return NotImplemented

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self) -> "Context":
        resolve_device(self)
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


DeviceLike = Union[None, str, int, torch.device, Context]


def cpu(device_id: int = 0) -> Context:
    """The host CPU (every ``device_id`` names the same host device)."""
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The accelerator ``device_id``: the reference's name for its
    device, which in the port is the CUDA card (``gpu(device_id)``)."""
    return Context("gpu", device_id)


def num_devices(device_type: str = "tpu") -> int:
    """Visible devices of a type: the CUDA cards for ``tpu`` / ``gpu``
    (0 without one), 1 for ``cpu``."""
    if Context.devstr2type.get(device_type) == 1:
        return 1
    if device_type not in Context.devstr2type:
        raise MXNetError("unsupported device type %r" % (device_type,))
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """``cuda:0``; raises when no GPU is visible."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' (ctx=mt.cpu()) "
            "or enter mt.device_scope('cpu') to run the port on the host")
    return torch.device("cuda", 0)


def _stack() -> List[Context]:
    stack = getattr(_scopes, "stack", None)
    if stack is None:
        stack = _scopes.stack = []
    return stack


def current_device() -> torch.device:
    """The innermost scope of this thread (``with ctx:`` or
    :func:`device_scope`), else :func:`default_device`."""
    stack = _stack()
    return stack[-1].device if stack else default_device()


def current_context() -> Context:
    """:func:`current_device` as a :class:`Context`: the innermost scope,
    else ``gpu(0)``; raises without a GPU (the reference falls back to
    ``cpu(0)``; the port runs on the card unless asked not to)."""
    stack = _stack()
    return stack[-1] if stack else Context(default_device())


@contextlib.contextmanager
def device_scope(device: DeviceLike) -> Iterator[torch.device]:
    """Make ``device`` the default of every entry point called inside
    the ``with`` block on this thread: ``with mt.device_scope("cpu"):``
    is ``with mt.cpu():``."""
    ctx = device if isinstance(device, Context) else Context(
        resolve_device(device if device is not None else "cuda"))
    with ctx:
        yield ctx.device


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Normalize a device argument to a ``torch.device``. ``None`` means
    :func:`current_device`; an explicit CUDA device must exist."""
    if device is None:
        return current_device()
    if isinstance(device, Context):
        dev = device.device
    elif isinstance(device, int):
        dev = torch.device("cuda", device)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("device %s requested but no CUDA device is "
                             "available" % (dev,))
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cpu or cuda)" % (dev,))
    return dev
