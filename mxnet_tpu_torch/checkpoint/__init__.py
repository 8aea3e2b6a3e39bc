"""Crash-safe checkpointing with exact resume.

The port's counterpart of the reference's ``mx.checkpoint``, in its
format, so that a checkpoint written by either package resumes in the
other:

* crash-safe: each checkpoint is an atomic directory (temp, fsync,
  rename) with a crc32 per array; a ``kill -9`` at any byte of a save
  leaves the previous checkpoint loadable, and a torn or corrupt one is
  skipped at load (:mod:`.format`);
* asynchronous: the training thread only snapshots (device clones); a
  bounded background writer does the rest (:mod:`.manager`);
* complete: parameters, aux states, optimizer states and update counts,
  the loop position, the key chain of ``mt.random`` and torch's
  generators, and the metric totals, so that ``Module.fit(resume_from=
  dir)`` continues an interrupted run as the uninterrupted run would;
* bounded: keep-last-N and keep-every-K retention that never deletes
  the only valid checkpoint.

Typical use::

    import mxnet_tpu_torch as mt
    cfg = mt.checkpoint.CheckpointConfig("ckpts/", every_n_batches=100)
    mod.fit(train_iter, num_epoch=90, checkpoint=cfg)
    ...
    mod.fit(train_iter, num_epoch=90, resume_from="ckpts/")

One process only: multi-host saves and reshard-on-load raise, naming
ROADMAP A9.
"""
from .atomic import atomic_open, fsync_dir, replace_and_sync
from .format import (ARRAYS_NAME, MANIFEST_NAME, CheckpointCorrupt,
                     CheckpointError, CheckpointNotFound,
                     CheckpointPodError, collect_garbage,
                     finalize_staged_pod_saves, list_checkpoints,
                     load_latest, probe_valid, read_checkpoint,
                     reshard_tensors, write_checkpoint)
from .manager import (Checkpoint, CheckpointConfig, CheckpointManager,
                      restore_global_rng, restore_latest)

__all__ = [
    "CheckpointConfig", "CheckpointManager", "Checkpoint",
    "CheckpointError", "CheckpointCorrupt", "CheckpointNotFound",
    "CheckpointPodError",
    "restore_latest", "restore_global_rng",
    "write_checkpoint", "read_checkpoint", "load_latest",
    "reshard_tensors", "list_checkpoints", "probe_valid",
    "collect_garbage", "finalize_staged_pod_saves",
    "atomic_open", "fsync_dir", "replace_and_sync",
    "ARRAYS_NAME", "MANIFEST_NAME",
]
