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

from typing import List, Optional

__all__ = ["pow2_ladder", "decode_buckets"]


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
