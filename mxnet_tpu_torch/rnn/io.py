"""Data iterators for recurrent models: ``encode_sentences`` and
``BucketSentenceIter``.

The port's own copy of the reference's ``rnn/io.py`` (numpy there too),
over the port's ``io.DataIter``. Each sentence is padded to the smallest
bucket that holds it, so every bucket is one shape, and every batch
names its bucket (``DataBatch.bucket_key``) for ``BucketingModule``.
With the same ``seed`` the batches are those of the reference, bit for
bit. Batches are NDArrays on the host, as the other iterators give.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to lists of integer ids, growing a new vocab
    unless one is given (then an unknown token raises)."""
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        frozen = False
    else:
        frozen = True
    next_id = start_label
    encoded = []
    for sentence in sentences:
        ids = []
        for token in sentence:
            if token not in vocab:
                if frozen:
                    raise AssertionError("Unknown token %s" % token)
                if next_id == invalid_label:
                    next_id += 1
                vocab[token] = next_id
                next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator over variable-length id sequences. Labels are the
    data shifted by one step (language-model targets), ``invalid_label``
    past the end; ``reset`` reshuffles the batches and each bucket's rows
    from ``seed``. ``layout`` ``NT`` gives (batch, time) batches, ``TN``
    (time, batch)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT", seed=None):
        super().__init__()
        lengths = np.array([len(s) for s in sentences])
        if not buckets:
            # every length that appears at least batch_size times
            counts = np.bincount(lengths)
            buckets = [int(n) for n in np.nonzero(counts >= batch_size)[0]]
        buckets = sorted(buckets)
        if not buckets:
            raise ValueError("no buckets: pass buckets= explicitly or use a "
                             "smaller batch_size")

        # the smallest bucket that fits, else discarded
        slot = np.searchsorted(buckets, lengths)
        n_discard = int(np.sum(slot == len(buckets)))
        if n_discard:
            logging.warning(
                "BucketSentenceIter: %d sentences longer than the largest "
                "bucket (%d) were discarded", n_discard, buckets[-1])

        # one padded (rows, bucket_len) matrix per bucket, labels shifted
        self.data = []
        self._labels = []
        for b, blen in enumerate(buckets):
            rows = [sentences[i] for i in np.nonzero(slot == b)[0]]
            mat = np.full((len(rows), blen), invalid_label, dtype=dtype)
            for r, sent in enumerate(rows):
                mat[r, :len(sent)] = sent
            lab = np.full_like(mat, invalid_label)
            lab[:, :-1] = mat[:, 1:]
            self.data.append(mat)
            self._labels.append(lab)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("layout must be 'NT' (batch-major) or 'TN' "
                             "(time-major), got %r" % layout)
        self.default_bucket_key = max(buckets)
        self._rng = np.random.RandomState(seed)

        shape = (batch_size, self.default_bucket_key)
        if self.major_axis == 1:
            shape = shape[::-1]
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        # (bucket, row offset) of every full batch; partial tails dropped
        self.idx = [(b, start)
                    for b, mat in enumerate(self.data)
                    for start in range(0, len(mat) - batch_size + 1,
                                       batch_size)]
        self.nddata = []
        self.ndlabel = []
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        self._rng.shuffle(self.idx)
        self.nddata = []
        self.ndlabel = []
        for mat, lab in zip(self.data, self._labels):
            perm = self._rng.permutation(len(mat))
            mat[:] = mat[perm]
            lab[:] = lab[perm]
            self.nddata.append(nd.array(mat, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(lab, ctx=cpu(), dtype=self.dtype))

    def next(self):
        if self.curr_idx >= len(self.idx):
            raise StopIteration
        b, start = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[b][start:start + self.batch_size]
        label = self.ndlabel[b][start:start + self.batch_size]
        if self.major_axis == 1:       # time-major: (T, N)
            data = nd.transpose(data)
            label = nd.transpose(label)
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[b],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
