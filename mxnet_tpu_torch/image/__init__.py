"""``image`` — the host-side image pipeline (reference:
python/mxnet/image/__init__.py re-exports image + detection)."""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from . import detection  # noqa: F401
from .detection import (  # noqa: F401
    DetAugmenter, DetBorrowAug, DetRandomSelectAug, DetHorizontalFlipAug,
    DetRandomCropAug, DetRandomPadAug, CreateDetAugmenter, ImageDetIter,
    ImageDetRecordIter,
)
