"""``mod`` — Module and its training loop."""
from __future__ import annotations

from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
