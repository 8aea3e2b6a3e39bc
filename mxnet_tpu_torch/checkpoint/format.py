"""On-disk checkpoint format: atomic directories, verifiable arrays.

The port's copy of the reference's ``checkpoint/format.py``, in the same
format (``FORMAT_VERSION``), so that a checkpoint written by one package
loads in the other. A checkpoint is one directory ``ckpt-<step>`` under
a base directory::

    base/
      ckpt-0000000040/
        arrays.npz       every tensor, stored (uncompressed) npz
        manifest.json    per-array shape/dtype/crc32 + tensor table + meta
      .tmp-ckpt-0000000080.4711.0   <- a writer died here; never loadable

Everything is written into a ``.tmp-*`` sibling, each file fsynced, the
directory fsynced, then renamed onto its final name and the base
directory fsynced: a ``ckpt-*`` directory exists with all of its
contents or not at all. The manifest records a crc32 over every array's
bytes; :func:`read_checkpoint` recomputes them and raises
:class:`CheckpointCorrupt` on any mismatch, and :func:`load_latest`
falls back to the newest checkpoint that verifies. Nothing is ever
unpickled.

Tensors may be numpy arrays or torch tensors on any device (fetched to
the host here, so call this off the training thread). A bfloat16 tensor
is stored without ``ml_dtypes``: its npy header names the dtype
``bfloat16`` (a reader with ``ml_dtypes`` loaded, as the reference's is,
gets a bfloat16 array) over the raw 16-bit values, and the manifest's
dtype string is ``bfloat16``; this module reads it back as a torch
bfloat16 tensor on the host. (The reference's own reader can take it
with ``verify=False`` only: its crc32 cannot view a bfloat16 buffer.)
Every other tensor reads back as a numpy array.

Single process only. Sharded and multi-host manifests the reference
wrote are reassembled on the host (numpy only); writing them, finalizing
a pod's staged save and re-laying tensors out onto a mesh raise, naming
ROADMAP A9.
"""
from __future__ import annotations

import ast
import itertools
import json
import logging
import os
import re
import shutil
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..base import MXNetError
from .. import faults as _faults
from .. import profiler as _profiler
from . import atomic as _atomic

__all__ = [
    "CheckpointError", "CheckpointCorrupt", "CheckpointNotFound",
    "CheckpointPodError",
    "FORMAT_VERSION", "MANIFEST_NAME", "ARRAYS_NAME",
    "checkpoint_dir_name", "list_checkpoints", "probe_valid",
    "write_checkpoint", "read_manifest", "read_checkpoint", "load_latest",
    "collect_garbage", "reshard_tensors", "finalize_staged_pod_saves",
]

FORMAT_VERSION = "mxnet_tpu.checkpoint/1"
MANIFEST_NAME = "manifest.json"
ARRAYS_NAME = "arrays.npz"
BF16 = "bfloat16"
_DIR_RE = re.compile(r"^ckpt-(\d{10})$")
_TMP_PREFIX = ".tmp-"
# .tmp-ckpt-<step>.<pid>.<seq>: the pid drives dead-writer reaping; the
# sequence keeps two writers of one step (a queued async save racing a
# SIGTERM save) off one path
_TMP_RE = re.compile(r"^\.tmp-ckpt-\d{10}\.(\d+)\.\d+$")
_TMP_SEQ = itertools.count()
_A9 = "ROADMAP.md queue A9 (parallelism)"

log = logging.getLogger(__name__)


class CheckpointError(MXNetError):
    """Base error of the checkpoint subsystem."""


class CheckpointCorrupt(CheckpointError):
    """A checkpoint directory failed verification: checksum, shape or
    dtype mismatch, or an unreadable container."""


class CheckpointNotFound(CheckpointError):
    """No loadable checkpoint exists under the base directory."""


class CheckpointPodError(CheckpointError):
    """A multi-host save could not complete as a unit."""


def finalize_staged_pod_saves(base: str, by_rank: int = 0) -> List[str]:
    raise CheckpointPodError("multi-host checkpoints come with %s" % _A9)


def reshard_tensors(tensors, mesh, layout=None, manifest=None):
    raise CheckpointError("reshard-on-load comes with %s" % _A9)


def _maybe_crash(point: str) -> None:
    """A fault-injection point of the write protocol (a ``kill -9``
    mid-write, by default): ``MXNET_TPU_FAULTS=ckpt.<point>@<n>`` or
    the legacy ``MXNET_TPU_CKPT_TEST_CRASH=<point>@<n>``."""
    if _faults.armed_or_env():
        _faults.fire("ckpt." + point, default_kind="sigkill")


def _crc32(arr: np.ndarray) -> int:
    arr = np.ascontiguousarray(arr)
    return zlib.crc32(memoryview(arr).cast("B")) & 0xFFFFFFFF


def checkpoint_dir_name(step: int) -> str:
    return "ckpt-%010d" % int(step)


# ------------------------------------------------------------ npz codec

def _host(val) -> Tuple[np.ndarray, str]:
    """``(host array, manifest dtype)``: a bfloat16 tensor as its raw
    16-bit values under the dtype ``bfloat16``."""
    if hasattr(val, "detach"):                     # a torch tensor
        import torch
        t = val.detach()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.int16).cpu().numpy()
            return raw.view(np.uint16), BF16
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(val)
    return arr, str(arr.dtype)


def _write_npz(f, arrays: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """An uncompressed npz archive, as ``np.savez`` writes it, whose
    bfloat16 entries carry the descr ``bfloat16``."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype == BF16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": BF16, "fortran_order": False,
                              "shape": tuple(arr.shape)})
                    fid.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)


def _read_npy(fid, name: str):
    """``(array, manifest dtype)`` of one npy member: bfloat16 as raw
    uint16; object arrays refused."""
    version = np.lib.format.read_magic(fid)
    size = 2 if version == (1, 0) else 4
    hlen = int.from_bytes(fid.read(size), "little")
    header = ast.literal_eval(fid.read(hlen).decode("latin1"))
    descr, shape = header["descr"], tuple(header["shape"])
    if descr == BF16:
        dtype, tag = np.dtype(np.uint16), BF16
    else:
        dtype = np.lib.format.descr_to_dtype(descr)
        tag = None
    if dtype.hasobject:
        raise CheckpointCorrupt("%s holds an object array" % name)
    count = int(np.prod(shape, dtype=np.int64))
    buf = bytearray(count * dtype.itemsize)
    if fid.readinto(buf) != len(buf):
        raise CheckpointCorrupt("%s is truncated" % name)
    arr = np.frombuffer(buf, dtype=dtype)
    if header.get("fortran_order"):
        arr = arr.reshape(shape[::-1]).transpose()
    else:
        arr = arr.reshape(shape)
    return arr, tag or str(arr.dtype)


def _read_npz(path: str) -> Dict[str, Tuple[np.ndarray, str]]:
    out = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            if not info.filename.endswith(".npy"):
                continue
            key = info.filename[:-len(".npy")]
            with zf.open(info) as fid:
                out[key] = _read_npy(fid, key)
    return out


def _as_tensor_value(arr: np.ndarray, dtype: str):
    """What a reader gets: numpy, or a host bfloat16 torch tensor."""
    if dtype != BF16:
        return arr
    import torch
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def _compose(name: str, entry: Dict[str, Any],
             raw: Dict[str, np.ndarray]) -> np.ndarray:
    """A full host array from its tensor-table entry: ``full`` names one
    array; ``sharded`` (a mesh-bound reference save) lists index windows
    that must cover it exactly, overlaps allowed."""
    if entry["kind"] == "full":
        return raw[entry["key"]]
    shape = tuple(entry["shape"])
    out = np.empty(shape, dtype=np.dtype(entry["dtype"]))
    covered = np.zeros(shape, dtype=bool)
    for sh in entry["shards"]:
        window = tuple(slice(*w) if w else slice(None)
                       for w in sh["index"])
        piece = raw[sh["key"]]
        try:
            if out[window].shape != piece.shape:
                raise ValueError(
                    "shard shape %s does not exactly fill window shape %s"
                    % (piece.shape, out[window].shape))
            out[window] = piece
        except (ValueError, IndexError) as exc:
            raise CheckpointCorrupt(
                "sharded tensor %r: shard %r does not fit window %s: %s"
                % (name, sh["key"], sh["index"], exc)) from None
        covered[window] = True
    if not covered.all():
        missing = int(out.size - np.count_nonzero(covered))
        raise CheckpointCorrupt(
            "sharded tensor %r: shards cover %d of %d elements"
            % (name, out.size - missing, out.size))
    return out


# ------------------------------------------------------------- writing

def write_checkpoint(base: str, step: int, tensors: Dict[str, Any],
                     meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic checkpoint directory; returns its path.

    If a valid checkpoint already exists at that step the write is
    skipped (one state per step); one that fails the validity probe is
    replaced."""
    step = int(step)
    os.makedirs(base, exist_ok=True)
    final = os.path.join(base, checkpoint_dir_name(step))
    if os.path.isdir(final):
        if probe_valid(final):
            return final
        log.warning("replacing invalid existing checkpoint %s", final)
        shutil.rmtree(final, ignore_errors=True)
    tmp = os.path.join(base, "%sckpt-%010d.%d.%d"
                       % (_TMP_PREFIX, step, os.getpid(), next(_TMP_SEQ)))
    os.makedirs(tmp)
    try:
        arrays = {name: _host(val) for name, val in tensors.items()}
        arrays_path = os.path.join(tmp, ARRAYS_NAME)
        if _faults.armed_or_env():
            # transient IO drill (eio/enospc/eintr), before any byte
            _faults.fire("ckpt.arrays_write", default_kind="eio")
        with open(arrays_path, "wb") as f:
            _write_npz(f, arrays)
            f.flush()
            os.fsync(f.fileno())
        _maybe_crash("after_arrays")
        manifest = {
            "format": FORMAT_VERSION,
            "step": step,
            "arrays": {k: {"shape": [int(s) for s in v.shape],
                           "dtype": dtype,
                           "crc32": _crc32(v),
                           "nbytes": int(v.nbytes)}
                       for k, (v, dtype) in arrays.items()},
            "tensors": {name: {"kind": "full", "key": name}
                        for name in arrays},
            "files": {ARRAYS_NAME: os.path.getsize(arrays_path)},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        _maybe_crash("after_manifest")
        _atomic.fsync_dir(tmp)
        _maybe_crash("before_rename")
        try:
            os.rename(tmp, final)
        except OSError:
            if not os.path.isdir(final):   # a concurrent writer of the
                raise                      # same step won the rename
            shutil.rmtree(tmp, ignore_errors=True)
        _atomic.fsync_dir(base)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


# ------------------------------------------------------------- reading

def list_checkpoints(base: str) -> List[Tuple[int, str]]:
    """``[(step, path)]`` of finalized checkpoint directories, ascending
    by step. ``.tmp-*`` residues are never listed."""
    try:
        names = os.listdir(base)
    except OSError:
        return []
    out = []
    for n in names:
        m = _DIR_RE.match(n)
        if m and os.path.isdir(os.path.join(base, n)):
            out.append((int(m.group(1)), os.path.join(base, n)))
    out.sort()
    return out


def read_manifest(path: str) -> Dict[str, Any]:
    if _faults.armed_or_env():
        # bit-rot and truncation drills: the manifest is corrupted on
        # disk before the read, so detection and fallback meet a real
        # torn file
        _faults.fire("ckpt.read_manifest",
                     path=os.path.join(path, MANIFEST_NAME),
                     default_kind="bitflip")
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointCorrupt("unreadable manifest in %s: %s"
                                % (path, exc)) from None
    if not isinstance(manifest, dict) or \
            manifest.get("format") != FORMAT_VERSION:
        raise CheckpointCorrupt(
            "%s: unknown checkpoint format %r"
            % (path, manifest.get("format") if isinstance(manifest, dict)
               else type(manifest)))
    return manifest


def _validate_pod_tags(path: str, manifest: Dict[str, Any]) -> None:
    """Reject a multi-host manifest one of whose files or entries is
    tagged with a process beyond its committed ``world_size`` (a stale
    host wrote into it)."""
    world = int(manifest.get("world_size", 1) or 1)
    tags = [int(r) for r in (manifest.get("writers") or {})]
    tags += [int(rec["process_index"])
             for rec in (manifest.get("arrays") or {}).values()
             if rec.get("process_index") is not None]
    tags += [int(sh["process_index"])
             for entry in (manifest.get("tensors") or {}).values()
             for sh in entry.get("shards") or []
             if sh.get("process_index") is not None]
    stale = [p for p in tags if p >= world]
    if stale:
        raise CheckpointCorrupt(
            "%s: written by process %d, but the manifest commits "
            "world_size=%d: a stale host; rejecting the save as a unit"
            % (path, stale[0], world))


def probe_valid(path: str) -> bool:
    """Cheap validity probe (no checksums): the manifest parses and the
    container files have the recorded sizes."""
    try:
        manifest = read_manifest(path)
        for fname, size in manifest.get("files", {}).items():
            if os.path.getsize(os.path.join(path, fname)) != int(size):
                return False
        return True
    except (CheckpointError, OSError, ValueError, TypeError):
        return False


def read_checkpoint(path: str, verify: bool = True, mesh=None,
                    layout=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load one checkpoint directory -> ``(tensors, manifest)``, every
    array checked against its manifest record (the set of arrays, shape,
    dtype and, with ``verify``, crc32). Raises :class:`CheckpointCorrupt`
    on any mismatch."""
    if mesh is not None:
        reshard_tensors(None, mesh)
    manifest = read_manifest(path)
    _validate_pod_tags(path, manifest)
    by_file: Dict[str, Dict[str, Any]] = {}
    for key, rec in manifest["arrays"].items():
        by_file.setdefault(rec.get("file", ARRAYS_NAME), {})[key] = rec
    if _faults.armed_or_env():
        _faults.fire("ckpt.read_arrays", path=os.path.join(
            path, ARRAYS_NAME if ARRAYS_NAME in by_file or not by_file
            else sorted(by_file)[0]), default_kind="bitflip")
    raw: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    try:
        for fname in sorted(by_file):
            want_recs = by_file[fname]
            got = _read_npz(os.path.join(path, fname))
            if set(got) != set(want_recs):
                raise CheckpointCorrupt(
                    "%s: array set mismatch in %s (missing %s, unexpected "
                    "%s)" % (path, fname, sorted(set(want_recs) - set(got)),
                             sorted(set(got) - set(want_recs))))
            for key, rec in want_recs.items():
                arr, dtype = got[key]
                if list(arr.shape) != list(rec["shape"]) or \
                        dtype != rec["dtype"]:
                    raise CheckpointCorrupt(
                        "%s: %r is %s%s, manifest says %s%s"
                        % (path, key, dtype, arr.shape, rec["dtype"],
                           tuple(rec["shape"])))
                if verify and _crc32(arr) != rec["crc32"]:
                    raise CheckpointCorrupt(
                        "%s: checksum mismatch on %r" % (path, key))
                raw[key], dtypes[key] = arr, dtype
    except CheckpointError:
        raise
    except Exception as exc:                               # noqa: BLE001
        # zipfile.BadZipFile, zlib.error, OSError, ValueError: all mean
        # the container cannot be trusted
        raise CheckpointCorrupt("%s: unreadable array container: %s"
                                % (path, exc)) from None
    try:
        tensors = {}
        for name, entry in manifest.get("tensors", {}).items():
            arr = _compose(name, entry, raw)
            tensors[name] = _as_tensor_value(
                arr, dtypes[entry["key"]] if entry["kind"] == "full"
                else str(arr.dtype))
    except CheckpointError:
        raise
    except Exception as exc:                               # noqa: BLE001
        # a bit-rotted tensor table must stay inside the corrupt
        # taxonomy, or load_latest's fallback chain breaks
        raise CheckpointCorrupt("%s: corrupt tensor table: %r"
                                % (path, exc)) from None
    return tensors, manifest


def load_latest(base: str, verify: bool = True
                ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """Newest checkpoint that verifies -> ``(path, tensors, manifest)``.

    Corrupt candidates are skipped with a warning (counted
    ``ckpt_load_fallback``); raises :class:`CheckpointNotFound` when
    nothing under ``base`` loads."""
    entries = list_checkpoints(base)
    for _step, path in reversed(entries):
        try:
            tensors, manifest = read_checkpoint(path, verify=verify)
            _profiler.incr_counter("ckpt_load_ok")
            return path, tensors, manifest
        except CheckpointCorrupt as exc:
            _profiler.incr_counter("ckpt_load_fallback")
            log.warning("skipping corrupt checkpoint %s (%s); "
                        "falling back to the previous one", path, exc)
    raise CheckpointNotFound(
        "no loadable checkpoint under %r (%d candidate(s), all invalid)"
        % (base, len(entries)))


# ------------------------------------------------------------ retention

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True        # EPERM: exists but not ours


def collect_garbage(base: str, keep_last: int,
                    keep_every: Optional[int] = None) -> int:
    """Retention: keep the newest ``keep_last`` valid checkpoints (and
    every ``keep_every``-th step), delete the other valid ones, and clear
    the ``.tmp-*`` residues of dead writers. Returns the number of
    checkpoints removed.

    ``keep_last <= 0`` deletes nothing; the newest valid checkpoint is
    never deleted; checkpoints that fail the validity probe are never
    deleted and do not count toward the quota."""
    removed = 0
    try:
        for name in os.listdir(base):
            m = _TMP_RE.match(name)
            if m and not _pid_alive(int(m.group(1))):
                shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    except OSError:
        pass
    if keep_last is None or keep_last <= 0:
        return 0
    entries = list_checkpoints(base)
    valid = [(s, p) for s, p in entries if probe_valid(p)]
    for _s, p in entries:
        if (_s, p) not in valid:
            log.warning("retention GC: %s fails the validity probe; "
                        "leaving it for inspection (it does not count "
                        "toward keep-last)", p)
    keep = {p for _s, p in valid[-keep_last:]}
    if keep_every and keep_every > 0:
        keep |= {p for s, p in valid if s % keep_every == 0}
    if valid:
        keep.add(valid[-1][1])
    for _step, path in valid:
        if path in keep:
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed += 1
    if removed:
        _profiler.incr_counter("ckpt_gc_removed", removed)
    return removed
