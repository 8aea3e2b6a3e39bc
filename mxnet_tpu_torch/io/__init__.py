"""``io`` — data iterators (the reference's ``io`` package)."""
from __future__ import annotations

from .io import (CSVIter, DataBatch, DataDesc, DataIter, MNISTIter,
                 NDArrayIter, PrefetchingIter, ResizeIter)
from .image_record import ImageRecordIter, ImageRecordUInt8Iter

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "ImageRecordUInt8Iter", "ImageDetRecordIter"]


def __getattr__(name):
    # lazy: image imports io, so the reverse edge must not be eager
    if name == "ImageDetRecordIter":
        from ..image.detection import ImageDetRecordIter
        return ImageDetRecordIter
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
