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
  :func:`current_position`).  The one copy lives in
  ``telemetry.ioview``, as in the JAX package; the names here are its.
* **elastic cursor remap**: :class:`SampleLedger` derives every rank's
  samples from one permutation an epoch (:func:`epoch_permutation`),
  rank ``r`` of ``W`` taking positions ``r, r+W, ...``, so ranks in
  lockstep have consumed a prefix of it and :func:`remap_state` re-cuts a
  cursor for another world size with no sample dropped or seen twice
  (:class:`SampleAccountant` checks that).  :class:`ShardedLedgerIter` is
  the iterator over it.

* **backpressure**: :class:`BackpressureController` reads the
  ``telemetry.ioview`` bottleneck verdict and moves the registered
  pipeline knobs (``DevicePrefetchIter``'s depth) with hysteresis;
  :func:`maybe_controller` installs it when ``MXNET_TPU_BACKPRESSURE`` is
  on (default off), and ``Module.fit`` ticks it once a batch.

Restores count ``mxtpu_data_resume_total`` and remaps set
``mxtpu_data_remap_samples``, each with a flight event and a JSONL
record.  ``MXNET_TPU_DATA_RESUME`` (default on) gates writing and
restoring the data state.
"""
from __future__ import annotations

import logging
import threading

import numpy as np

from .base import MXNetError
from . import resilience
from . import telemetry
from .telemetry import ioview as _ioview

__all__ = [
    "STATE_VERSION", "enabled", "check_state", "iter_state",
    "iter_position", "restore_iterator", "track", "tracked_iterator",
    "current_state", "current_position",
    "epoch_permutation", "rank_stream", "remap_cursor", "remap_state",
    "SampleLedger", "ShardedLedgerIter", "SampleAccountant",
    "data_state_entry", "note_loaded_state", "pending_state",
    "clear_pending", "apply_pending", "backpressure_enabled",
    "BackpressureController", "maybe_controller",
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
    telemetry.counter("mxtpu_data_resume_total").inc()
    telemetry.flight.record("data_resume", state_kind=state.get("kind"),
                            epoch=state.get("epoch"))
    telemetry.jsonl_event("data_resume", kind=state.get("kind"),
                          epoch=state.get("epoch"))


# ---------------------------------------------------- the tracked iterator

#: the run's training iterator: ``telemetry.ioview`` holds it
track = _ioview.track
tracked_iterator = _ioview.tracked_iterator
current_state = _ioview.current_state
current_position = _ioview.current_position


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
    telemetry.gauge("mxtpu_data_remap_samples").set(g)
    telemetry.flight.record("data_remap", old_world=int(state["world"]),
                            new_world=int(new_world),
                            new_rank=int(new_rank), global_consumed=g,
                            epoch=int(state["epoch"]))
    telemetry.jsonl_event("data_remap", old_world=int(state["world"]),
                          new_world=int(new_world), global_consumed=g)
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


# ------------------------------------------------ backpressure control

def backpressure_enabled():
    """``MXNET_TPU_BACKPRESSURE`` (default off): install the controller
    over the training iterator in ``fit``."""
    from . import config
    return str(config.get("MXNET_TPU_BACKPRESSURE", "0")) in (
        "1", "true", "True")


class BackpressureController:
    """Close the bottleneck-verdict loop: producer-bound windows raise
    pipeline capacity knobs, consumer-bound windows lower them back.

    Hysteresis: a knob moves only after ``confirm`` consecutive windows
    with the same non-balanced verdict, and then rests ``cooldown``
    ticks.  Every move counts
    ``mxtpu_backpressure_adjust_total{knob,direction}``, leaves a
    ``backpressure_adjust`` flight event and JSONL record, and is kept on
    ``self.adjustments``."""

    def __init__(self, confirm=2, cooldown=2):
        self._knobs = []             # (name, get, set, lo, hi)
        self._streak = {"producer-bound": 0, "consumer-bound": 0}
        self._cool = 0
        self._seen = None
        self.confirm = int(confirm)
        self.cooldown = int(cooldown)
        self.adjustments = []

    def register(self, name, getter, setter, lo, hi):
        """Register a tunable int knob with its clamp range."""
        self._knobs.append((name, getter, setter, int(lo), int(hi)))
        return self

    def attach(self, it):
        """Walk the iterator wrapper chain and register every knob it
        exposes (``DevicePrefetchIter``'s depth).  Returns the number of
        knobs registered."""
        n = 0
        seen = set()
        stack = [it]
        while stack:
            obj = stack.pop()
            if obj is None or id(obj) in seen:
                continue
            seen.add(id(obj))
            if callable(getattr(obj, "set_depth", None)) and \
                    callable(getattr(obj, "depth", None)):
                self.register("device_prefetch_depth", obj.depth,
                              obj.set_depth, 1, max(8, 4 * obj.depth()))
                n += 1
            for attr in ("_it", "data_iter", "_inner"):
                stack.append(getattr(obj, attr, None))
            stack.extend(getattr(obj, "iters", None) or [])
        return n

    def _move(self, direction, stage):
        delta = 1 if direction == "raise" else -1
        for name, get, set_, lo, hi in self._knobs:
            cur = int(get())
            new = min(hi, max(lo, cur + delta))
            if new == cur:
                continue
            set_(new)
            telemetry.counter("mxtpu_backpressure_adjust_total").labels(
                knob=name, direction=direction).inc()
            telemetry.flight.record("backpressure_adjust", knob=name,
                                    direction=direction, value=new,
                                    stage=stage or "")
            telemetry.jsonl_event("backpressure_adjust", knob=name,
                                  direction=direction, value=new,
                                  stage=stage or "")
            _log.info("backpressure: %s %s %d -> %d (verdict stage %s)",
                      direction, name, cur, new, stage)
            self.adjustments.append(
                {"knob": name, "direction": direction, "from": cur,
                 "to": new, "stage": stage})
            return True
        return False

    def tick(self, verdict=None, force=False):
        """One control step on the live classifier's verdict (only a new
        window's verdict feeds the streaks), or on ``verdict`` when
        given.  Returns the adjustment made, or None."""
        if verdict is None:
            last = _ioview.classify(force=force)
            # classify() returns the same dict until a window commits
            if last is self._seen:
                return None
            self._seen = verdict = last
        if self._cool > 0:
            self._cool -= 1
            return None
        kind = (verdict or {}).get("verdict")
        if kind not in self._streak:
            for k in self._streak:
                self._streak[k] = 0
            return None
        self._streak[kind] += 1
        for k in self._streak:
            if k != kind:
                self._streak[k] = 0
        if self._streak[kind] < self.confirm:
            return None
        if self._move("raise" if kind == "producer-bound" else "lower",
                      (verdict or {}).get("stage")):
            self._streak[kind] = 0
            self._cool = self.cooldown
            return self.adjustments[-1]
        return None


def maybe_controller(it):
    """A :class:`BackpressureController` over ``it`` when
    ``MXNET_TPU_BACKPRESSURE`` is on and the chain exposes a knob; None
    otherwise.  The caller ticks it (``fit``: once a batch)."""
    if not backpressure_enabled():
        return None
    ctl = BackpressureController()
    if ctl.attach(it) == 0:
        _log.info("MXNET_TPU_BACKPRESSURE set but the iterator chain "
                  "exposes no tunable knob (no DevicePrefetchIter); "
                  "controller not installed")
        return None
    return ctl
