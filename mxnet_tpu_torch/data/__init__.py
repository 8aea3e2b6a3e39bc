"""``data`` — the sharded multi-worker streaming data plane.

The port's copy of the reference package's ``data/``: worker processes
own disjoint RecordIO shard ranges partitioned deterministically from
``(seed, epoch, world_size, num_workers)``, decode in parallel, and hand
batches to ``fit``'s device-prefetch stage (the module's pinned-buffer
H2D copy) in a delivery order that is a pure function of ``(seed,
epoch, world)`` — so checkpoints resume the stream bit-exactly even
after a worker-count change. On one card ``part="auto"`` is ``(0, 1)``.

Import discipline: this package is LAZY (``mxnet_tpu_torch.data``
resolves through the package's ``__getattr__``) and nothing in the
training path imports it — a fit over any other iterator never loads it
and never moves a ``data_*`` counter. Design: the reference's
docs/architecture/data_plane.md.
"""
from .partition import PartitionPlan, epoch_order
from .loader import DataLoader
from .transforms import ImageTransform, RawTransform, StallTransform

__all__ = ["DataLoader", "PartitionPlan", "epoch_order", "RawTransform",
           "ImageTransform", "StallTransform"]
