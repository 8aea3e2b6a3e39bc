"""Shape bucketing for the serving path (a copy of the reference
package's ``serve/bucketing.py``; the port never imports that package).

Every request geometry is padded up to a small fixed ladder of
power-of-two *buckets*, so the set of per-bucket runners is finite: in
the reference each bucket is one compiled XLA program, in the port one
bound runner today and one captured CUDA graph later. The
``<name>_compile`` counter then counts buckets, and a steady state that
moves it is a bug a test can assert on.

Cost model: padding wastes at most 50% of rows at pow2 granularity
(usually far less under load, where batches fill).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = ["BucketSpec", "pow2_ladder", "decode_buckets"]


def pow2_ladder(bound: int) -> List[int]:
    """The canonical bucket ladder: powers of two below ``bound``, plus
    ``bound`` itself (so the largest bucket is exact, pow2 or not)."""
    if bound < 1:
        raise ValueError("bucket bound must be >= 1, got %d" % bound)
    ladder = []
    b = 1
    while b < bound:
        ladder.append(b)
        b <<= 1
    ladder.append(int(bound))
    return ladder


def decode_buckets(max_seq_len: int, page: int,
                   spec: Optional[str] = None) -> List[int]:
    """The decode sequence-length bucket ladder: every bucket is a page
    multiple (the int8 per-page scale grid requires it), capped at
    ``max_seq_len``. ``spec`` is the ``MXNET_TPU_SERVE_DECODE_BUCKETS``
    grammar (comma-separated ints); empty/None = the pow2 ladder from
    ``page`` up, with ``max_seq_len`` itself as the last rung."""
    if page < 1 or max_seq_len < page:
        raise ValueError("kv page %d must satisfy 1 <= page <= max_seq_len"
                         " %d" % (page, max_seq_len))
    if max_seq_len % page:
        raise ValueError("max_seq_len %d is not a multiple of the kv page "
                         "%d" % (max_seq_len, page))
    if spec:
        try:
            ladder = sorted(set(int(s) for s in spec.split(",") if s.strip()))
        except ValueError:
            raise ValueError("MXNET_TPU_SERVE_DECODE_BUCKETS must be a "
                             "comma-separated int list, got %r" % (spec,))
        if not ladder:
            raise ValueError("empty decode bucket spec %r" % (spec,))
    else:
        ladder = [b for b in pow2_ladder(max_seq_len) if b >= page]
    for b in ladder:
        if b % page:
            raise ValueError("decode bucket %d is not a multiple of the kv "
                             "page %d" % (b, page))
        if not 0 < b <= max_seq_len:
            raise ValueError("decode bucket %d outside (0, max_seq_len=%d]"
                             % (b, max_seq_len))
    if ladder[-1] != max_seq_len:
        ladder.append(int(max_seq_len))
    return ladder


class BucketSpec:
    """Maps request shapes onto the finite bucket grid.

    Parameters
    ----------
    max_batch_size : int
        Largest micro-batch bucket (the coalescing row bound).
    batch_buckets : sequence of int, optional
        Explicit batch-bucket ladder; default is the powers of two up to
        ``max_batch_size`` (``[1, 2, 4, ..., max_batch_size]``, with
        ``max_batch_size`` itself appended when it is not a power of
        two).
    seq_axis : int, optional
        Sample-shape axis (non-negative, 0-based, batch dim excluded)
        that may vary per request — sequence length for text, boxes for
        detection. ``None`` (default) means sample shapes must match a
        bucket head exactly to coalesce; every distinct sample shape is
        its own bucket, which is only bounded when client shapes are.

        Seq-padding contract: requests are padded with ``pad_value``
        along this axis up to the bucket length, the model runs on the
        PADDED input, and outputs come back at bucket geometry (callers
        slice to their real length). The model must therefore be
        padding-invariant along this axis at the real positions —
        masked attention, length-aware pooling, or pad-neutral
        reductions. A model where pad positions bleed into real ones
        (unmasked encoder attention, plain mean-pooling) will silently
        differ from unpadded serving; such models need the padding
        masked in-model or ``seq_axis=None``.
    max_seq_len : int, optional
        Required with ``seq_axis``: the admission bound on the dynamic
        axis; longer requests are rejected at submit.
    seq_buckets : sequence of int, optional
        Explicit ladder for the dynamic axis; default powers of two up
        to ``max_seq_len`` (plus ``max_seq_len`` itself).
    pad_value : float
        Fill for padded rows/positions.
    """

    def __init__(self, max_batch_size: int = 32,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_axis: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 pad_value: float = 0.0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_batch_size = int(max_batch_size)
        if batch_buckets is None:
            batch_buckets = pow2_ladder(self.max_batch_size)
        self.batch_buckets: List[int] = sorted(set(int(b)
                                                   for b in batch_buckets))
        if self.batch_buckets[-1] != self.max_batch_size:
            raise ValueError("largest batch bucket %d != max_batch_size %d"
                             % (self.batch_buckets[-1], self.max_batch_size))
        if seq_axis is not None and seq_axis < 0:
            # the sample rank is unknown here, so a numpy-style negative
            # axis cannot be normalized — and left as-is it would read
            # the right dim but never match the enumerate() rewrite in
            # sample_bucket, silently disabling padding (one executable
            # per novel length: the exact regime bucketing exists to
            # prevent)
            raise ValueError(
                "seq_axis must be a non-negative index into the sample "
                "shape (batch dim excluded); got %d" % seq_axis)
        self.seq_axis = seq_axis
        self.pad_value = pad_value
        if seq_axis is not None:
            if max_seq_len is None:
                raise ValueError("seq_axis needs max_seq_len (the "
                                 "admission bound on the dynamic axis)")
            self.max_seq_len = int(max_seq_len)
            if seq_buckets is None:
                seq_buckets = pow2_ladder(self.max_seq_len)
            self.seq_buckets: Optional[List[int]] = sorted(
                set(int(s) for s in seq_buckets))
            if self.seq_buckets[-1] != self.max_seq_len:
                raise ValueError("largest seq bucket %d != max_seq_len %d"
                                 % (self.seq_buckets[-1], self.max_seq_len))
        else:
            self.max_seq_len = None
            self.seq_buckets = None

    # ----------------------------------------------------------- lookup
    def batch_bucket(self, rows: int) -> int:
        """Smallest batch bucket holding ``rows`` rows."""
        for b in self.batch_buckets:
            if rows <= b:
                return b
        raise ValueError("batch of %d rows exceeds max_batch_size %d"
                         % (rows, self.max_batch_size))

    def sample_bucket(self, sample_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The padded sample geometry a request of ``sample_shape`` is
        served at (batch dim excluded). Identity without ``seq_axis``."""
        if self.seq_axis is None:
            return tuple(sample_shape)
        ax = self.seq_axis
        if ax >= len(sample_shape):
            raise ValueError("seq_axis %d out of range for sample shape %s"
                             % (ax, (sample_shape,)))
        n = sample_shape[ax]
        for s in self.seq_buckets:
            if n <= s:
                return tuple(s if i == ax else d
                             for i, d in enumerate(sample_shape))
        raise ValueError("dynamic axis %d of length %d exceeds max_seq_len "
                         "%d" % (ax, n, self.max_seq_len))

    def executable_bound(self) -> Optional[int]:
        """Upper bound on distinct padded geometries (None when the
        sample-shape set is client-controlled, i.e. no seq_axis)."""
        if self.seq_buckets is None:
            return None
        return len(self.batch_buckets) * len(self.seq_buckets)
