"""``mod`` — Module, BucketingModule and their training loop."""
from __future__ import annotations

from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]
