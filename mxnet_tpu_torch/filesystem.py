"""``mx.filesystem`` — URI-scheme file IO (the dmlc-core Stream layer).

Reference: dmlc-core's ``dmlc::Stream::Create`` dispatches on URI scheme
(local path, ``s3://``, ``hdfs://``) so RecordIO datasets and checkpoints
work on any storage backend (SURVEY.md §2.11; e.g. model.py save/load via
dmlc Stream). Same design here: ``open_uri(uri, mode)`` returns a local
file path — remote objects are staged through a temp file on read and
uploaded on close for write — so every consumer (recordio, nd.save/load,
checkpoints) keeps using ordinary file APIs.

Backends:
* local paths / ``file://`` — direct.
* ``s3://bucket/key`` — via boto3 when installed; a clear error otherwise
  (this image has no egress, so the backend is gate-tested with a stub).
* ``hdfs://`` — via pyarrow.fs when installed.
* custom — ``register_scheme("myfs", open_fn)`` plugs in anything.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Callable, Dict

__all__ = ["open_uri", "register_scheme", "scheme_of", "exists"]

_SCHEMES: Dict[str, Callable] = {}


def register_scheme(scheme: str, opener: Callable) -> None:
    """Register ``opener(path, mode) -> context manager yielding a local
    file path`` for ``scheme://`` URIs (dmlc's Stream registry role)."""
    _SCHEMES[scheme] = opener


def scheme_of(uri: str) -> str:
    if "://" in uri:
        return uri.split("://", 1)[0]
    return ""


@contextlib.contextmanager
def _local(path: str, mode: str):
    yield path


def _require_boto3():
    try:
        import boto3
    except ImportError:
        raise IOError(
            "s3:// URIs need boto3 (not installed in this environment); "
            "stage the file locally or register_scheme('s3', ...) with a "
            "custom opener") from None
    return boto3


@contextlib.contextmanager
def _s3(path: str, mode: str):
    # path = bucket/key
    if "a" in mode:
        raise IOError("append mode is not supported for s3:// URIs "
                      "(objects are immutable; rewrite with 'w')")
    boto3 = _require_boto3()
    bucket, _, key = path.partition("/")
    s3 = boto3.client("s3")
    with tempfile.NamedTemporaryFile(delete=False) as tmp:
        tmp_path = tmp.name
    try:
        if "r" in mode:
            s3.download_file(bucket, key, tmp_path)
        yield tmp_path
        if "w" in mode or "a" in mode:
            s3.upload_file(tmp_path, bucket, key)
    finally:
        os.unlink(tmp_path)


@contextlib.contextmanager
def _hdfs(path: str, mode: str):
    if "a" in mode:
        raise IOError("append mode is not supported for hdfs:// URIs; "
                      "rewrite with 'w'")
    try:
        from pyarrow import fs as pafs
    except ImportError:
        raise IOError(
            "hdfs:// URIs need pyarrow (not installed in this "
            "environment); register_scheme('hdfs', ...) to override"
        ) from None
    host, _, rest = path.partition("/")
    hdfs = pafs.HadoopFileSystem(host or "default")
    with tempfile.NamedTemporaryFile(delete=False) as tmp:
        tmp_path = tmp.name
    try:
        if "r" in mode:
            with hdfs.open_input_stream("/" + rest) as src, \
                    open(tmp_path, "wb") as dst:
                shutil.copyfileobj(src, dst)
        yield tmp_path
        if "w" in mode or "a" in mode:
            with open(tmp_path, "rb") as src, \
                    hdfs.open_output_stream("/" + rest) as dst:
                shutil.copyfileobj(src, dst)
    finally:
        os.unlink(tmp_path)


register_scheme("", _local)
register_scheme("file", _local)
register_scheme("s3", _s3)
register_scheme("hdfs", _hdfs)


def open_uri(uri: str, mode: str = "r"):
    """Context manager yielding a LOCAL file path for ``uri``.

    Local paths pass through; remote schemes stage via a temp file
    (download before the body for 'r', upload after it for 'w')."""
    scheme = scheme_of(uri)
    if scheme not in _SCHEMES:
        raise IOError("no filesystem registered for scheme %r (have %s)"
                      % (scheme, sorted(s for s in _SCHEMES if s)))
    path = uri.split("://", 1)[1] if scheme else uri
    return _SCHEMES[scheme](path, mode)


def exists(uri: str) -> bool:
    """Existence probe. Local/file:// use os.path.exists; s3/hdfs use
    cheap metadata probes (no download). Missing-dependency errors
    propagate — a host without boto3 must not report checkpoints absent.
    Custom schemes fall back to attempting a read open."""
    scheme = scheme_of(uri)
    if scheme in ("", "file"):
        path = uri.split("://", 1)[1] if scheme else uri
        return os.path.exists(path)
    if scheme == "s3":
        boto3 = _require_boto3()
        bucket, _, key = uri.split("://", 1)[1].partition("/")
        s3 = boto3.client("s3")
        try:
            s3.head_object(Bucket=bucket, Key=key)
            return True
        except s3.exceptions.ClientError:
            return False
    if scheme == "hdfs":
        from pyarrow import fs as pafs   # ImportError propagates
        host, _, rest = uri.split("://", 1)[1].partition("/")
        info = pafs.HadoopFileSystem(host or "default").get_file_info(
            "/" + rest)
        return info.type != pafs.FileType.NotFound
    if scheme not in _SCHEMES:
        raise IOError("no filesystem registered for scheme %r" % scheme)
    try:
        with open_uri(uri, "r"):
            return True
    except FileNotFoundError:
        return False
    except OSError:
        return False
