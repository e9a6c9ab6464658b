"""KVStore: the in-process parameter store of the Module path.

The counterpart of ``mxnet_tpu/kvstore.py``'s ``local`` and ``device``
types: ``init``, ``push`` (values of a key summed, then handed to the
updater or stored), ``pull``, ``set_updater``/``set_optimizer`` and the
optimizer states' files.  The sums run on the values' device.  The
``dist_*`` types (NCCL across processes) are ROADMAP Queue A item 6 and
raise.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray import NDArray
from . import optimizer as opt

__all__ = ["KVStore", "create"]


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

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        for k, v in zip(*_key_value(key, value)):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Sum the values of each key (on the first value's device); with
        an updater, update the stored weight from the sum, else store it."""
        for k, group in zip(*_group(*_key_value(key, value))):
            with torch.no_grad():
                first = group[0].data
                merged = first.detach().clone()
                for other in group[1:]:
                    merged += other.data.to(first.device)
            merged = NDArray(merged)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("key %s has not been inited" % str(k))
                self._updater(k, merged, self._store[k])
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull needs out arrays")
        for k, o in zip(*_key_value(key, out)):
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
    """A KVStore by type name: ``local`` or ``device``.  The ``dist_*``
    types raise: distributed stores are ROADMAP Queue A item 6."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if "dist" in name:
        raise MXNetError("kvstore %r: distributed stores are not yet ported "
                         "to mxnet_tpu_torch (ROADMAP Queue A item 6, "
                         "multi-GPU and distribution)" % name)
    if name not in ("local", "device"):
        raise MXNetError("unknown kvstore type %r" % name)
    return KVStore(name)
