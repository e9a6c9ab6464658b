"""The bucketed sentence iterator of the language models.

The counterpart of ``mxnet_tpu/rnn/io.py``: sentences go to the smallest
bucket that holds them, padded with ``invalid_label``, and each batch is
one bucket's, so every batch of a bucket has one shape and one executor.
The label is the sentence shifted by one token.  ``reset`` shuffles the
batch order with the process-global ``random`` and each bucket's rows with
numpy's global generator, in the JAX package's order of draws, so that the
same global seeds give the same batches in the same order in both
packages.  Batches are NDArrays on the host (``cpu()``).
"""
from __future__ import annotations

import bisect
import random

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import NDArray, array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Token lists -> lists of ids, and the vocabulary (built here from
    ``start_label`` when ``vocab`` is None, skipping ``invalid_label``)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    raise ValueError("Unknown token %s" % word)
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Batches of ``batch_size`` sentences of one bucket each, in layout
    ``NT`` (batch-major) or ``TN``; ``bucket_key`` is the bucket's length
    and ``default_bucket_key`` the largest.  Buckets default to every
    length that has at least ``batch_size`` sentences."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences])) if j >= batch_size]
        buckets.sort()

        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                continue        # longer than the largest bucket: dropped
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # an empty bucket keeps its width (no batch comes from it)
        self.data = [np.asarray(rows, dtype=dtype).reshape(-1, width)
                     for rows, width in zip(self.data, buckets)]

        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)
        if self.major_axis == 0:
            shape = (batch_size, self.default_bucket_key)
        elif self.major_axis == 1:
            shape = (self.default_bucket_key, batch_size)
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) "
                             "or TN (time major)" % layout)
        self.provide_data = [DataDesc(self.data_name, shape,
                                      layout=self.layout)]
        self.provide_label = [DataDesc(self.label_name, shape,
                                       layout=self.layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in range(
                0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(array(buck, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(array(label, ctx=cpu(), dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = NDArray(data.data.t()), NDArray(label.data.t())
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape,
                                                 layout=self.layout)])
