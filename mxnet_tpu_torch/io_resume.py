"""The exactly-once data plane: durable iterator state and the elastic
cursor remap.

The counterpart of ``mxnet_tpu/io_resume.py``:

* **durable iterator state**: every iterator of ``io``, ``io_native``,
  ``recordio`` and ``image`` has ``state()``, a JSON-able versioned dict
  naming the next sample it has not delivered (a wrapper holding batches
  fetched but not delivered reports the state from before them), and
  ``restore(state)``, which puts a like iterator where the state says, so
  the rest of the stream is the same.  The dicts are the JAX package's,
  so a state taken in either package restores in the other.
  :func:`restore_iterator` fires the ``io.resume`` seam before it changes
  anything.  A checkpoint's manifest carries the state in
  ``meta["data_state"]`` (:func:`data_state_entry`, written by
  ``model.save_checkpoint`` and ``ShardedTrainer.save_checkpoint``); the
  loaders stash it with :func:`note_loaded_state`, and ``BaseModule.fit``
  and ``ShardedTrainer.restore_data_iter`` apply it with
  :func:`apply_pending`, so a run stopped mid-epoch resumes at the next
  sample.
* **the run's tracked iterator**: :func:`track` registers the training
  iterator (``fit`` and ``restore_data_iter`` do), whose state and
  position the checkpoints then record (:func:`current_state`,
  :func:`current_position`).  The JAX package keeps this in
  ``telemetry.ioview``, which the port has not ported.
* **elastic cursor remap**: :class:`SampleLedger` derives every rank's
  samples from one permutation an epoch (:func:`epoch_permutation`),
  rank ``r`` of ``W`` taking positions ``r, r+W, ...``, so ranks in
  lockstep have consumed a prefix of it and :func:`remap_state` re-cuts a
  cursor for another world size with no sample dropped or seen twice
  (:class:`SampleAccountant` checks that).  :class:`ShardedLedgerIter` is
  the iterator over it.

The JAX package's backpressure controller reads the input pipeline's
bottleneck verdict from ``telemetry.ioview``, which is not ported, nor
are its counters of restores and remapped samples.
``MXNET_TPU_DATA_RESUME`` (default on) gates writing and restoring the
data state.
"""
from __future__ import annotations

import logging
import threading
import weakref

import numpy as np

from .base import MXNetError
from . import resilience

__all__ = [
    "STATE_VERSION", "enabled", "check_state", "iter_state",
    "iter_position", "restore_iterator", "track", "tracked_iterator",
    "current_state", "current_position",
    "epoch_permutation", "rank_stream", "remap_cursor", "remap_state",
    "SampleLedger", "ShardedLedgerIter", "SampleAccountant",
    "data_state_entry", "note_loaded_state", "pending_state",
    "clear_pending", "apply_pending",
]

STATE_VERSION = 1

_log = logging.getLogger(__name__)


def enabled():
    """``MXNET_TPU_DATA_RESUME`` (default on): write ``data_state`` into
    checkpoint manifests and restore it on resume."""
    from . import config
    return str(config.get("MXNET_TPU_DATA_RESUME", "1")) not in (
        "0", "false", "False")


# ------------------------------------------------------- state contract

def check_state(state, kind, version=STATE_VERSION):
    """``state`` when it is a ``state()`` dict of ``kind`` at a version this
    build reads, else MXNetError.  Every ``restore`` calls it first, so a
    rejected state leaves the iterator as it was."""
    if not isinstance(state, dict):
        raise MXNetError(
            "data state must be a dict from state(), got %r"
            % type(state).__name__)
    v = state.get("v")
    if not isinstance(v, int) or v < 1 or v > version:
        raise MXNetError(
            "data state version %r not supported (this build reads "
            "v<=%d)" % (v, version))
    if state.get("kind") != kind:
        raise MXNetError(
            "data state kind mismatch: state is %r, iterator expects "
            "%r; restore into the iterator class that produced the "
            "state" % (state.get("kind"), kind))
    return state


def iter_state(it):
    """``it.state()``, or None when it has none or raises: a checkpoint
    never fails because its iterator cannot describe itself."""
    fn = getattr(it, "state", None)
    if not callable(fn):
        return None
    try:
        st = fn()
    except Exception:   # an arbitrary user iterator; the save goes on
        return None
    return st if isinstance(st, dict) else None


def iter_position(it):
    """``it.position()``, or None when it has none or raises (advisory)."""
    fn = getattr(it, "position", None)
    if not callable(fn):
        return None
    try:
        pos = fn()
    except Exception:   # advisory, as iter_state
        return None
    return pos if isinstance(pos, dict) else None


def restore_iterator(it, state):
    """Fire the ``io.resume`` seam, then ``it.restore(state)``.  The seam
    fires before anything changes and every ``restore`` validates before
    it commits, so a fault leaves the iterator restorable from the same
    state.  ``state=None`` does nothing."""
    if state is None:
        return
    try:
        resilience.fault_point("io.resume")
    except resilience.FaultInjected as e:
        raise MXNetError(
            "data-state restore aborted by the io.resume seam before "
            "any iterator mutation; the iterator is unchanged and the "
            "same state can be restored again: %s" % e) from e
    fn = getattr(it, "restore", None)
    if not callable(fn):
        raise MXNetError(
            "%s has no restore(): the checkpoint carries a data_state "
            "entry but this iterator cannot consume it (resume with "
            "the iterator class that produced it, or set "
            "MXNET_TPU_DATA_RESUME=0)" % type(it).__name__)
    fn(state)


# ---------------------------------------------------- the tracked iterator

_tracked = [None]


def track(it):
    """Register ``it`` as the run's training iterator, whose state and
    position the next checkpoints record; held by a weak reference.
    Returns ``it``."""
    try:
        _tracked[0] = weakref.ref(it)
    except TypeError:
        _tracked[0] = None
    return it


def tracked_iterator():
    """The tracked iterator, or None."""
    ref = _tracked[0]
    return ref() if ref is not None else None


def current_state():
    """The tracked iterator's ``state()``, or None."""
    it = tracked_iterator()
    return None if it is None else iter_state(it)


def current_position():
    """The tracked iterator's ``position()``, or None (advisory)."""
    it = tracked_iterator()
    return None if it is None else iter_position(it)


# -------------------------------------------------- global sample ledger

def epoch_permutation(seed, epoch, n):
    """The epoch's global sample order: a permutation of ``range(n)`` from
    (seed, epoch) alone, the same in every process at any world size."""
    key = (int(seed) * 1000003 + int(epoch) * 9973 + 0x9e3779b9) \
        % (1 << 32)
    return np.random.RandomState(key).permutation(int(n))


def rank_stream(perm, rank, world):
    """Rank ``rank`` of ``world``'s sample ids: positions ``rank, rank +
    world, ...`` of the permutation, so ranks in lockstep have consumed a
    prefix of it."""
    if not 0 <= int(rank) < int(world):
        raise MXNetError("rank %r out of range for world %r"
                         % (rank, world))
    return perm[int(rank)::int(world)]


def remap_cursor(global_consumed, new_rank, new_world):
    """The new rank's cursor: how many of its positions lie in the consumed
    prefix ``perm[:global_consumed]``, the least ``k`` with ``new_rank +
    k * new_world >= global_consumed``."""
    g, r, w = int(global_consumed), int(new_rank), int(new_world)
    if g <= r:
        return 0
    return (g - r + w - 1) // w


class SampleLedger:
    """One dataset's sample ledger: an epoch's permutation, cut into the
    ranks' strided streams."""

    def __init__(self, num_samples, seed=0):
        self.num_samples = int(num_samples)
        self.seed = int(seed)
        self._cache = (None, None)   # (epoch, perm)

    def permutation(self, epoch):
        ep = int(epoch)
        if self._cache[0] != ep:
            self._cache = (ep, epoch_permutation(self.seed, ep,
                                                 self.num_samples))
        return self._cache[1]

    def rank_ids(self, epoch, rank, world):
        """This rank's sample ids for the epoch."""
        return rank_stream(self.permutation(epoch), rank, world)

    def global_consumed(self, cursor, world):
        """The consumed prefix's length when every rank's cursor is
        ``cursor`` (clamped at the tail)."""
        return min(int(cursor) * int(world), self.num_samples)

    def consumed_ids(self, epoch, cursor, world):
        """The ids consumed by all ranks at lockstep cursor ``cursor``."""
        return self.permutation(epoch)[:self.global_consumed(cursor, world)]


def remap_state(state, new_rank, new_world):
    """A :class:`ShardedLedgerIter` state re-cut for rank ``new_rank`` of
    ``new_world``, as a new dict.  The ``io.remap`` seam fires before
    anything is computed."""
    check_state(state, "ledger")
    try:
        resilience.fault_point("io.remap")
    except resilience.FaultInjected as e:
        raise MXNetError(
            "elastic cursor remap aborted by the io.remap seam; no "
            "state was derived and the same remap can be retried: %s"
            % e) from e
    n = int(state["num_samples"])
    g = min(int(state["cursor"]) * int(state["world"]), n)
    new_cursor = remap_cursor(g, new_rank, new_world)
    _log.info("elastic data remap: %d/%d samples consumed at world %d "
              "-> rank %d/%d resumes at local cursor %d",
              g, n, int(state["world"]), int(new_rank), int(new_world),
              new_cursor)
    out = dict(state)
    out.update(rank=int(new_rank), world=int(new_world),
               cursor=new_cursor)
    return out


class ShardedLedgerIter:
    """In-memory arrays sharded through a :class:`SampleLedger`.  Each
    batch carries its global sample ids in ``DataBatch.index`` (the real
    samples only: a padded tail repeats data, not ids); a state from
    another world size is re-cut by :func:`remap_state` on restore."""

    def __init__(self, data, label=None, batch_size=32, seed=0,
                 rank=0, world=1, data_name="data",
                 label_name="softmax_label"):
        from .io import DataDesc, _init_data
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.batch_size = int(batch_size)
        n = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != n:
                raise MXNetError("array %r has %d samples, expected %d"
                                 % (k, v.shape[0], n))
        self.ledger = SampleLedger(n, seed=seed)
        self._rank = int(rank)
        self._world = int(world)
        self._epoch = 0
        self._cursor = 0             # samples this rank delivered
        self._ids = self.ledger.rank_ids(0, self._rank, self._world)
        self.provide_data = [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype) for k, v in self.data]
        self.provide_label = [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype) for k, v in self.label]

    def __iter__(self):
        return self

    def reset(self):
        self._epoch += 1
        self._cursor = 0
        self._ids = self.ledger.rank_ids(self._epoch, self._rank,
                                         self._world)

    def position(self):
        return {"epoch": self._epoch, "shard": self._rank,
                "num_shards": self._world, "offset": int(self._cursor)}

    def state(self):
        return {"v": STATE_VERSION, "kind": "ledger",
                "epoch": self._epoch, "cursor": int(self._cursor),
                "seed": self.ledger.seed, "rank": self._rank,
                "world": self._world,
                "num_samples": self.ledger.num_samples}

    def restore(self, state):
        check_state(state, "ledger")
        if int(state["num_samples"]) != self.ledger.num_samples or \
                int(state["seed"]) != self.ledger.seed:
            raise MXNetError(
                "ledger state mismatch: state has %s samples / seed "
                "%s, iterator has %d / %d; the ledger identity "
                "(dataset size + seed) must match for an exact resume"
                % (state["num_samples"], state["seed"],
                   self.ledger.num_samples, self.ledger.seed))
        if int(state["world"]) != self._world or \
                int(state["rank"]) != self._rank:
            state = remap_state(state, self._rank, self._world)
        epoch, cursor = int(state["epoch"]), int(state["cursor"])
        ids = self.ledger.rank_ids(epoch, self._rank, self._world)
        if cursor > len(ids):
            raise MXNetError(
                "ledger cursor %d beyond this rank's %d-sample epoch "
                "stream" % (cursor, len(ids)))
        self._epoch, self._cursor, self._ids = epoch, cursor, ids

    def next(self):
        from .context import cpu
        from .io import DataBatch
        from .ndarray import array as nd_array
        ids = self._ids[self._cursor:self._cursor + self.batch_size]
        if len(ids) == 0:
            raise StopIteration
        pad = self.batch_size - len(ids)
        take = np.asarray(ids, dtype=np.int64)
        if pad:
            # the tail padded with the epoch's first samples, whose ids
            # batch.index does not repeat
            take = np.concatenate(
                [take, np.asarray(self._ids[:pad], dtype=np.int64)])
        batch = DataBatch(
            data=[nd_array(v[take], ctx=cpu()) for _, v in self.data],
            label=[nd_array(v[take], ctx=cpu()) for _, v in self.label],
            pad=pad, index=np.asarray(ids, dtype=np.int64),
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        self._cursor += len(ids)
        return batch

    __next__ = next


class SampleAccountant:
    """Counts every consumed sample id (across legs, ranks and restarts of
    an epoch); :meth:`verdict` names the ids dropped or seen twice."""

    def __init__(self, num_samples):
        self.num_samples = int(num_samples)
        self._counts = {}

    def record(self, ids):
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            self._counts[i] = self._counts.get(i, 0) + 1

    def verdict(self):
        dropped = [i for i in range(self.num_samples)
                   if i not in self._counts]
        double = sorted(i for i, c in self._counts.items() if c > 1)
        alien = sorted(i for i in self._counts
                       if not 0 <= i < self.num_samples)
        return {"ok": not dropped and not double and not alien,
                "consumed": len(self._counts), "dropped": dropped,
                "double": double, "alien": alien}


# ------------------------------------------- manifest <-> fit plumbing

_pending_lock = threading.Lock()
_pending = [None]


def data_state_entry(it=None):
    """The manifest's ``data_state``: the tracked (or given) iterator's
    state and position under a version; None when resume is off or the
    iterator reports neither."""
    if not enabled():
        return None
    st = current_state() if it is None else iter_state(it)
    pos = current_position() if it is None else None
    if st is None and pos is None:
        return None
    return {"v": STATE_VERSION, "state": st, "position": pos}


def note_loaded_state(entry, source=None):
    """Stash the ``data_state`` a loader found for the next
    :func:`apply_pending`.  An entry this build cannot read is logged and
    dropped: the run then starts its epoch from the beginning."""
    if entry is None or not enabled():
        return
    if not isinstance(entry, dict) or \
            not isinstance(entry.get("v"), int) or \
            entry["v"] > STATE_VERSION:
        _log.warning(
            "checkpoint %s carries a data_state entry this build "
            "cannot read (%r); resuming from the start of the epoch",
            source or "", entry if not isinstance(entry, dict)
            else entry.get("v"))
        return
    with _pending_lock:
        _pending[0] = dict(entry, source=source)


def pending_state():
    """The stashed entry not yet applied, or None."""
    with _pending_lock:
        return dict(_pending[0]) if _pending[0] is not None else None


def clear_pending():
    with _pending_lock:
        _pending[0] = None


def apply_pending(it):
    """Restore the stashed ``data_state`` into ``it`` through
    :func:`restore_iterator`.  Returns the entry, or None when nothing was
    stashed or it held no state.  A failing restore leaves the entry
    stashed, so the same state can be applied again."""
    entry = pending_state()
    if entry is None:
        return None
    st = entry.get("state")
    if st is None:
        clear_pending()
        return None
    restore_iterator(it, st)
    clear_pending()
    _log.info("resumed data iterator from checkpoint %s: %s",
              entry.get("source") or "", st)
    return entry
