"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``ResizeIter``, ``PrefetchingIter``, ``NDArrayIter``, ``MNISTIter`` and
``CSVIter``.

The counterpart of ``mxnet_tpu/io.py``.  Batches are NDArrays on the host
(``cpu()``) until the Module copies them into its executor's input arrays
on the device.  ``NDArrayIter`` shuffles with numpy's global generator, as
the JAX code does, so with the same ``np.random`` state both packages give
the same batches.  The iterators' durable state (``state``/``restore``) and
position telemetry belong to resilience and telemetry (ROADMAP Queue A
items 7 and 8); ``DevicePrefetchIter`` and ``ImageRecordIter`` come with
the next slice.
"""
from __future__ import annotations

import gzip
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "MNISTIter", "CSVIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name and shape (and dtype and layout) of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One mini-batch: lists of data and label NDArrays, the padding of a
    last partial batch, and optional index and bucket key."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ResizeIter(DataIter):
    """Another iterator cut or extended to ``size`` batches an epoch (it
    starts the inner one over when that ends)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """One thread per wrapped iterator fetches its next batch while the
    consumer works on the current one; the batches of several iterators
    are joined into one (``rename_data``/``rename_label`` map names).  An
    error in a fetch is raised on the consumer's next call."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise MXNetError("PrefetchingIter needs at least one iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self.errors = [None] * self.n_iter

        def fetch(i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                except BaseException as e:   # raised on the consumer
                    self.next_batch[i] = None
                    self.errors[i] = e
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.threads = [threading.Thread(target=fetch, args=(i,),
                                         daemon=True)
                        for i in range(self.n_iter)]
        for t in self.threads:
            t.start()

    def __del__(self):
        self.started = False
        for e in getattr(self, "data_taken", ()):
            e.set()

    def _provide(self, attr, renames):
        if renames is None:
            return sum([getattr(i, attr) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in getattr(i, attr)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._provide("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._provide("provide_label", self.rename_label)

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        errs = [e for e in self.errors if e is not None]
        if errs:
            # the whole joined batch is dropped and every slot re-armed, so
            # the iterators stay in step
            for i in range(self.n_iter):
                self.errors[i] = None
                self.data_ready[i].clear()
                self.data_taken[i].set()
            raise errs[0]
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("PrefetchingIter: the iterators ended at "
                                 "different batches")
            return False
        if any(b.pad != self.next_batch[0].pad for b in self.next_batch):
            raise MXNetError("PrefetchingIter: the iterators' batches pad "
                             "differently")
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize input data to a sorted list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("the iterator needs data")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("the iterator needs data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {default_name + "_%d" % i: d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {k: v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
           for k, v in data.items()}
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Batches of in-memory arrays.  ``shuffle`` permutes the samples once,
    at construction, with ``np.random.shuffle``; ``last_batch_handle``:
    ``pad`` fills the last batch from the start and reports the padding,
    ``discard`` drops it, ``roll_over`` carries the rest into the next
    epoch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise MXNetError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            return [array(x[1][self.cursor:self.cursor + self.batch_size],
                          ctx=cpu()) for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(np.concatenate((x[1][self.cursor:], x[1][:pad]),
                                     axis=0), ctx=cpu())
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _read_idx_file(path):
    """An MNIST idx-ubyte file, optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    magic, = struct.unpack(">i", buf[:4])
    ndim = magic % 256
    dims = struct.unpack(">" + "i" * ndim, buf[4:4 + 4 * ndim])
    return np.frombuffer(buf, dtype=np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


class _Wrapped(DataIter):
    """An iterator that hands every call to an inner ``NDArrayIter``."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class MNISTIter(_Wrapped):
    """The MNIST idx-ubyte files: images scaled to [0, 1], ``flat`` or (1,
    28, 28), shuffled from ``RandomState(seed)``, the last partial batch
    dropped; ``num_parts``/``part_index`` read one shard."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        img = _read_idx_file(image).astype(np.float32) / 255.0
        lab = _read_idx_file(label).astype(np.float32)
        if num_parts > 1:
            n = img.shape[0] // num_parts
            img = img[part_index * n:(part_index + 1) * n]
            lab = lab[part_index * n:(part_index + 1) * n]
        if shuffle:
            order = np.random.RandomState(seed).permutation(img.shape[0])
            img, lab = img[order], lab[order]
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        self._inner = NDArrayIter(img, lab, batch_size=batch_size,
                                  last_batch_handle="discard")


class CSVIter(_Wrapped):
    """Rows of a CSV file reshaped to ``data_shape`` (labels from
    ``label_csv`` or zeros); ``round_batch`` pads the last batch, else it is
    dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")
