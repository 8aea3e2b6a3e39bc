"""Gluon's data API: datasets, samplers and the DataLoader."""
from .dataset import *
from .sampler import *
from .dataloader import *
from . import vision

from . import dataset
from . import sampler
from . import dataloader

__all__ = dataset.__all__ + sampler.__all__ + dataloader.__all__ + ["vision"]
