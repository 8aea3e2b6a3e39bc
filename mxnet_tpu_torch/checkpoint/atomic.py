"""Atomic durable file writes: the floor every checkpoint sits on.

The port's own copy of the reference's ``checkpoint/atomic.py``
(stdlib only). Writing a file in place leaves a torn file at the final
name when the process dies mid-write, and the previous good copy is
already gone. The protocol here instead:

1. write the whole payload to a temp file in the same directory (one
   filesystem, so the rename cannot degrade to copy + delete);
2. ``fsync`` the temp file;
3. ``os.replace`` it onto the final name (readers see the old bytes or
   the new, never a mix);
4. ``fsync`` the directory, so the rename itself survives power loss.

``atomic_open`` is that protocol as a drop-in for ``open(path, mode)``:
on any exception the temp file is removed and the previous file is
untouched; temp files of writers that died (their pid is in the name)
are reaped by the next write of the same target.
"""
from __future__ import annotations

import contextlib
import os
import re
import tempfile

__all__ = ["atomic_open", "fsync_dir", "replace_and_sync"]

_UMASK: int = -1


def _process_umask() -> int:
    """The process umask, read once and cached: os.umask can only be read
    by writing, and flipping it per-save would race other threads
    creating files in that window."""
    global _UMASK
    if _UMASK < 0:
        current = os.umask(0)
        os.umask(current)
        _UMASK = current
    return _UMASK


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True        # EPERM: exists but not ours


def _reap_stale(directory: str, base: str) -> None:
    """Unlink temp files for this SAME target left by writers whose pid
    is gone (kill -9 mid-write): without this, periodic saves through
    atomic_open would accumulate unbounded hidden temp files — each the
    full size of the artifact — in the user's output directory."""
    pat = re.compile(r"^\.%s\.tmp-(\d+)-" % re.escape(base))
    try:
        for name in os.listdir(directory):
            m = pat.match(name)
            if m and not _pid_alive(int(m.group(1))):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass
    except OSError:
        pass


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename/creation inside it survives power
    loss (no-op on platforms that refuse O_DIRECTORY opens)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass           # some filesystems reject fsync on directories
    finally:
        os.close(fd)


def replace_and_sync(tmp: str, final: str) -> None:
    """Atomically move ``tmp`` onto ``final`` and make the rename durable."""
    os.replace(tmp, final)
    fsync_dir(os.path.dirname(os.path.abspath(final)))


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "wb"):
    """``open(path, mode)`` with all-or-nothing semantics.

    Yields a file object backed by a hidden temp file next to ``path``;
    on clean exit the data is fsynced and renamed over ``path``, on
    exception the temp file is deleted and ``path`` is untouched. Only
    write modes make sense here (``"wb"``/``"w"``).
    """
    if "r" in mode or "a" in mode or "+" in mode:
        raise ValueError("atomic_open is write-only, got mode %r" % mode)
    directory = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    _reap_stale(directory, base)
    # pid in the name drives _reap_stale's dead-writer detection
    fd, tmp = tempfile.mkstemp(prefix=".%s.tmp-%d-" % (base, os.getpid()),
                               dir=directory)
    f = None
    try:
        # mkstemp creates 0600 and os.replace preserves it; a plain
        # open() honors the umask (typically 0644) — match that so
        # artifacts don't silently become owner-only on this path
        try:
            os.chmod(tmp, 0o666 & ~_process_umask())
        except OSError:
            pass
        f = os.fdopen(fd, mode)
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        f = None
        replace_and_sync(tmp, path)
    except BaseException:
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
