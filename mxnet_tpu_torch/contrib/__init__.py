"""``contrib`` — experimental-op namespaces.

The port's copy of the reference's ``contrib/__init__.py``: ``ndarray``
and ``symbol`` surface every registry op carrying the ``_contrib_``
prefix under its bare name (``contrib.nd.FlashAttention`` is registry
``_contrib_FlashAttention``). Resolution is lazy (PEP 562), so ops
registered after import, e.g. through ``rtc.UserKernel.register``,
appear too.
"""
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym

__all__ = ["ndarray", "nd", "symbol", "sym"]
