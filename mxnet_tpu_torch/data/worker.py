"""The data-plane worker process body.

Each worker owns a DISJOINT list of batch ranges (``PartitionPlan.
owned_ranges``) of one epoch, opens its own ``MXIndexedRecordIO``
handle (file handles never cross the fork), decodes batch-at-a-time and
puts finished host batches on its bounded queue — backpressure is the
queue bound, so a stalled consumer parks the workers instead of
buffering the epoch in RAM.

Failure semantics (the reference's docs/architecture/data_plane.md):

* ``data.worker`` fault site — fires at each batch START, default kind
  ``sigkill``: the honest worker-death shape. Only generation 0 fires
  it: a respawned worker replaying the dead one's undelivered range
  must make progress, not re-die at the same arrival forever.
* ``data.decode`` fault site + any real decode error — poisons ONE
  batch: the error is carried to the facade as an ``("error", k, msg)``
  entry (never a worker exit), the facade counts
  ``data_batch_poisoned`` and the epoch continues with batch ``k+1``.
* Clean exhaustion of the owned ranges ends with a ``("done", wid)``
  entry so the facade can tell "finished" from "died".

The worker NEVER touches ``torch.cuda`` (which cannot be initialised
again in a forked child) — file IO, numpy and the native decode library
only — so a forked worker cannot deadlock on the parent's runtime
locks.
"""
from __future__ import annotations

import os
import numpy as np

__all__ = ["worker_main"]


def worker_main(wid: int, generation: int, rec_path: str, idx_path: str,
                owned, transform, out_queue) -> None:
    """Decode ``owned`` = [(batch_idx, [record keys]), ...] in order.

    Top-level (picklable) so both fork and spawn start methods work;
    fault specs arrive via fork inheritance or the ``MXNET_TPU_FAULTS``
    environment (spawned children re-parse it at import).
    """
    import signal

    from .. import faults as _faults
    from .. import recordio as _recordio

    # a forked worker inherits the parent's Python handlers: fit's
    # checkpoint SIGTERM handler would turn the loader's terminate() into
    # a flag nobody reads here, and teardown into a wait for its deadline
    signal.signal(signal.SIGTERM, signal.SIG_DFL)

    # tag the fault marker lines with the worker identity: a drill
    # asserting "worker 1 died at its 2nd batch" can read it back
    os.environ.setdefault("MXNET_TPU_DATA_WORKER_ID", str(wid))
    rec = _recordio.MXIndexedRecordIO(idx_path, rec_path, "r")
    try:
        for bidx, keys in owned:
            if _faults.ARMED and generation == 0:
                _faults.fire("data.worker", default_kind="sigkill")
            try:
                if _faults.ARMED:
                    _faults.fire("data.decode", default_kind="raise")
                datas, labels = [], []
                for key in keys:
                    d, lab = transform(rec.read_idx(key))
                    datas.append(d)
                    labels.append(lab)
                out_queue.put(("data", bidx,
                               np.stack(datas), np.stack(labels)))
            except Exception as exc:               # noqa: BLE001
                # ONE poisoned batch, not a dead worker: decode errors
                # (injected or real — a corrupt record, a failed jpeg)
                # ride the queue as data so the facade can skip exactly
                # this batch and keep the epoch alive
                out_queue.put(("error", bidx,
                               "%s: %s" % (type(exc).__name__, exc),
                               None))
        out_queue.put(("done", wid, None, None))
    finally:
        rec.close()
