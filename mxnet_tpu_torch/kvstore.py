"""KVStore: the in-process parameter store of the Module path.

The counterpart of ``mxnet_tpu/kvstore.py``'s ``local`` and ``device``
types: ``init``, ``push`` (values of a key summed, then handed to the
updater or stored), ``pull``, ``set_updater``/``set_optimizer`` and the
optimizer states' files.  The sums run on the values' device.  The
``dist_*`` types dispatch as in JAX (:func:`create`): ``dist_sync`` and
``dist_device_sync`` to ``parallel.dist_kvstore`` (one all-reduce a push
across the job's processes), ``dist_async`` inside a job of several
processes to ``parallel.async_kvstore`` (a host parameter server).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray
from . import optimizer as opt
from . import telemetry

__all__ = ["KVStore", "create"]

_PUSH_BYTES = telemetry.counter("mxtpu_kvstore_push_bytes_total")
_PULL_BYTES = telemetry.counter("mxtpu_kvstore_pull_bytes_total")


def _nbytes(arr):
    """Bytes of one pushed or pulled array (traffic accounting)."""
    t = arr.data if isinstance(arr, NDArray) else arr
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


def _key_value(keys, vals):
    """Normalize (key(s), value(s)) into parallel flat lists."""
    if isinstance(keys, (int, str)):
        if isinstance(vals, NDArray):
            return [keys], [vals]
        return [keys] * len(vals), list(vals)
    if len(keys) != len(vals):
        raise MXNetError("kvstore: %d keys for %d values"
                         % (len(keys), len(vals)))
    keys_flat, vals_flat = [], []
    for k, v in zip(keys, vals):
        kf, vf = _key_value(k, v)
        keys_flat.extend(kf)
        vals_flat.extend(vf)
    return keys_flat, vals_flat


def _group(keys, vals):
    """Values grouped by key, keys in first-appearance order."""
    uniq, grouped = [], {}
    for k, v in zip(keys, vals):
        if k not in grouped:
            uniq.append(k)
            grouped[k] = []
        grouped[k].append(v)
    return uniq, [grouped[k] for k in uniq]


class KVStore:
    """A single-process store (types ``local`` and ``device``)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._updater_obj = None
        self._push_bytes = _PUSH_BYTES.labels(store=kv_type)
        self._pull_bytes = _PULL_BYTES.labels(store=kv_type)

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def get_rank(self):
        return self.rank

    def get_group_size(self):
        return self.num_workers

    def barrier(self):
        pass

    def init(self, key, value):
        for k, v in zip(*_key_value(key, value)):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Sum the values of each key (on the first value's device); with
        an updater, update the stored weight from the sum, else store it.
        Where the sum and the stored weight lie on different devices, the
        weight moves to the sum's device, once: ``local`` and ``device``
        coincide, as in the reference, and the update runs where the
        gradients are."""
        keys, vals = _key_value(key, value)
        self._push_bytes.inc(sum(_nbytes(v) for v in vals))
        for k, group in zip(*_group(keys, vals)):
            with torch.no_grad():
                first = group[0].data
                merged = first.detach().clone()
                for other in group[1:]:
                    merged += other.data.to(first.device)
            merged = NDArray(merged)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("key %s has not been inited" % str(k))
                stored = self._store[k]
                if stored.data.device != merged.data.device:
                    stored = NDArray(stored.data.to(merged.data.device))
                    self._store[k] = stored
                self._updater(k, merged, stored)
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull needs out arrays")
        keys, outs = _key_value(key, out)
        self._pull_bytes.inc(sum(_nbytes(o) for o in outs))
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s has not been inited" % str(k))
            o[:] = self._store[k]

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Update with ``optimizer`` in the store (in one process, the same
        as a local updater)."""
        self._updater_obj = opt.get_updater(optimizer)
        self.set_updater(self._updater_obj)

    def save_optimizer_states(self, fname):
        if self._updater_obj is None:
            raise MXNetError("save_optimizer_states: the store has no "
                             "optimizer (set_optimizer first)")
        with open(fname, "wb") as fout:
            fout.write(self._updater_obj.get_states())

    def load_optimizer_states(self, fname):
        if self._updater_obj is None:
            raise MXNetError("load_optimizer_states: the store has no "
                             "optimizer (set_optimizer first)")
        with open(fname, "rb") as fin:
            self._updater_obj.set_states(fin.read())


def create(name="local"):
    """A KVStore by type name, dispatched as the JAX package's ``create``:
    ``dist_async`` inside a job of more than one process is the host
    parameter server (``parallel.async_kvstore``, every push applied at
    once on the server); any other ``dist`` type is the synchronous store
    (``parallel.dist_kvstore``, one all-reduce a push; a one-process
    ``dist_async`` takes its sync semantics with a warning, as in JAX);
    ``local`` and ``device`` are this module's store."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "async" in name:
        from . import config
        if (config.get_int("MXNET_TPU_NUM_PROCESSES") or 1) > 1:
            from .parallel.async_kvstore import AsyncKVStore
            return AsyncKVStore(name)
    if "dist" in name:
        from .parallel.dist_kvstore import DistKVStore
        return DistKVStore(name)
    if name not in ("local", "device"):
        raise MXNetError("unknown kvstore type %r" % name)
    return KVStore(name)
