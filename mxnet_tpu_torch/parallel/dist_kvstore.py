"""The synchronous distributed KVStore: ``dist_sync``, ``dist_device_sync``.

The counterpart of ``mxnet_tpu/parallel/dist_kvstore.py``.  There are no
servers: a push sums every key's gradients across the job's processes in
one all-reduce of one flat buffer (one per dtype), the values flattened
in key order, and then applies the updater on every rank, so every rank
holds the same weights (the reference's sync aggregation: the update
runs once on exactly ``num_workers`` pushes).  The JAX store pushes all
keys as one program; the port makes one collective a push, never one a
key, whatever a key's size.

The store joins the launcher's job at creation
(``multihost.ensure_initialized``).  Outside a job it is a one-process
store of world 1.  Inside a launched job of one process the all-reduce
still runs (an identity), so the NCCL route runs on one card.  A
one-process ``dist_async`` takes these sync semantics with a warning, as
in JAX; in a job of several processes ``kvstore.create`` gives the host
parameter server instead (``parallel.async_kvstore``).

``push_bucketed``/``drain`` are the overlap path (``parallel/overlap.py``,
``MXNET_TPU_OVERLAP``): each full bucket's all-reduce is launched
asynchronously as its last gradient lands, and the updates are applied
only at the drain.  ``save_state``/``load_state`` checkpoint the store
(rank 0 writes behind a barrier; the values are replicated, so the file
loads at any world size).
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..context import cpu
from ..kvstore import KVStore, _group, _key_value, _nbytes
from ..ndarray import NDArray
from . import multihost

__all__ = ["DistKVStore"]


class DistKVStore(KVStore):
    """The synchronous store across the job's processes."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        if "async" in kv_type:
            logging.warning(
                "dist_async in one process: using dist_sync semantics "
                "(a job of several processes gets the parameter server)")
        multihost.ensure_initialized()
        self._joined = multihost.backend() is not None
        self._num_workers = multihost.world_size()
        self._rank = multihost.rank()
        self._bucket_queue = None
        #: all-reduce launches, for the one-collective-a-push contract
        self.collectives = 0

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    # ------------------------------------------------------------ collective
    def _launch(self, values):
        """Start the all-reduce of ``{key: tensor}`` (one buffer a dtype);
        returns a callable that waits and gives ``{key: summed}``."""
        wait, n = multihost.launch_all_reduce(values)
        self.collectives += n
        return wait

    def allreduce(self, values):
        """Sum ``{key: tensor}`` across the job's processes in one
        collective a dtype; every rank gets the sums.  Outside a job the
        values come back as they are."""
        if not self._joined:
            return dict(values)
        return self._launch(values)()

    # ----------------------------------------------------- local merge
    def _merge_local(self, key, value):
        """``({key: tensor}, bytes)``: each key's local values summed on
        the first value's device, keys in first-appearance order."""
        keys, vals = _key_value(key, value)
        merged, nbytes = {}, 0
        with torch.no_grad():
            for k, group in zip(*_group(keys, vals)):
                first = group[0].data
                m = first.detach().clone()
                for other in group[1:]:
                    m += other.data.to(first.device)
                merged[k] = m
                nbytes += _nbytes(group[0])
        return merged, nbytes

    # ------------------------------------------------------------------ api
    def push(self, key, value, priority=0):
        """Sum every key across the job in one all-reduce, then apply the
        updater (or store the sums) on every rank.  The distview
        timestamp barrier before the collective measures this rank's wait
        for its slowest peer."""
        merged, nbytes = self._merge_local(key, value)
        self._push_bytes.inc(nbytes)
        if self._joined:
            from ..telemetry import distview as _dv
            from ..telemetry import flight as _flight
            skew = _dv.pre_collective_barrier("kvstore.push")
            ev = {"op": "allreduce", "store": self.type,
                  "keys": len(merged), "bytes": nbytes}
            if skew is not None:
                ev["wait_s"] = round(skew["wait_s"], 6)
                ev["skew_s"] = round(skew["skew_s"], 6)
                ev["slowest_rank"] = skew["slowest_rank"]
            _flight.record("kvstore", **ev)
            merged = self.allreduce(merged)
        self._apply(merged)

    def _apply(self, merged):
        """Apply summed values through the updater, else store them; every
        key is checked before any update, so a missing key leaves nothing
        half applied."""
        if self._updater is not None:
            for k in merged:
                if k not in self._store:
                    raise MXNetError("key %s has not been inited" % str(k))
        for k, m in merged.items():
            m = NDArray(m)
            if self._updater is not None:
                stored = self._store[k]
                if stored.data.device != m.data.device:
                    stored = NDArray(stored.data.to(m.data.device))
                    self._store[k] = stored
                self._updater(k, m, stored)
            else:
                self._store[k] = m

    # ------------------------------------------- bucketed overlap path
    @property
    def overlap_active(self):
        """Whether gradient sync routes through :meth:`push_bucketed` and
        :meth:`drain` (``MXNET_TPU_OVERLAP``, more than one process)."""
        from . import overlap as _overlap
        return self._num_workers > 1 and _overlap.overlap_enabled()

    def push_bucketed(self, key, value, priority=0):
        """Merge local values and append them to the filling bucket
        (``MXNET_TPU_BUCKET_BYTES``); a full bucket's all-reduce starts at
        once.  Nothing is applied until :meth:`drain`."""
        from . import overlap as _overlap
        if self._num_workers <= 1:
            return self.push(key, value, priority=priority)
        if self._bucket_queue is None:
            self._bucket_queue = _overlap.BucketQueue(
                self._launch, site="kvstore.push")
        merged, nbytes = self._merge_local(key, value)
        self._push_bytes.inc(nbytes)
        for k, m in merged.items():
            self._bucket_queue.push(k, m, m.numel() * m.element_size())

    def drain(self):
        """Launch the remaining buckets, wait for every one in flight,
        then apply the updater for all keys (all or nothing: a failed
        collective raises before any update).  A no-op when nothing was
        pushed."""
        if self._bucket_queue is None or not self._bucket_queue.pending:
            return
        reduced = self._bucket_queue.drain(mesh={"hosts":
                                                 self._num_workers})
        self._apply(reduced)

    def pull(self, key, out=None, priority=0):
        """Drain the buckets in flight first, so a pull after a bucketed
        push reads the updated weights."""
        self.drain()
        return super().pull(key, out=out, priority=priority)

    def barrier(self):
        if self._joined:
            multihost.process_barrier("mxnet_tpu_kvstore_barrier")

    # --------------------------------------------------- checkpoints
    def save_state(self, prefix, epoch):
        """Write every key (``kv:i:<int>``/``kv:s:<name>``) to
        ``prefix-%04d.params`` with its CRC32 manifest (``meta.mesh.world``
        the saving world): rank 0 writes, a barrier orders the write
        before any rank reads.  Returns the params path."""
        from .. import ndarray as _nd
        from .. import resilience

        path = "%s-%04d.params" % (prefix, int(epoch))
        for _k in sorted(self._store, key=str):
            resilience.fault_point("reshard.gather")
        if self._rank == 0:
            arrays = {}
            for k in sorted(self._store, key=str):
                tag = "i" if isinstance(k, int) else "s"
                arrays["kv:%s:%s" % (tag, k)] = multihost.gather_to_host(
                    self._store[k].data)
            resilience.atomic_write(
                path,
                lambda tmp: _nd.save(
                    tmp, {k: _nd.array(v, ctx=cpu())
                          for k, v in arrays.items()}),
                fault_site="checkpoint.save")
            resilience.write_manifest(
                prefix, int(epoch), [path], arrays=arrays,
                meta={"mesh": {"format": 2, "axes": {},
                               "world": self._num_workers},
                      "kvstore": self.type})
        multihost.process_barrier("dist_kvstore_state_save")
        return path

    def load_state(self, prefix, epoch):
        """Restore the store :meth:`save_state` wrote, at any world size
        (every rank reads the file; a world change fires the
        ``elastic.rejoin`` seam).  Returns the saving world size."""
        from .. import ndarray as _nd
        from .. import resilience

        resilience.fault_point("checkpoint.load")
        manifest = resilience.verify_manifest(prefix, int(epoch))
        mesh = ((manifest or {}).get("meta") or {}).get("mesh") or {}
        saved_world = int(mesh.get("world") or 1)
        if saved_world != self._num_workers:
            resilience.fault_point("elastic.rejoin")
        path = "%s-%04d.params" % (prefix, int(epoch))
        try:
            loaded = _nd.load(path, ctx=cpu())
        except FileNotFoundError as e:
            raise MXNetError("kvstore state file %r is missing for "
                             "epoch %d" % (path, int(epoch))) from e
        store = {}
        for k, v in loaded.items():
            parts = k.split(":", 2)
            if len(parts) != 3 or parts[0] != "kv" or \
                    parts[1] not in ("i", "s"):
                raise MXNetError(
                    "%r is not a kvstore state file: unexpected key %r "
                    "(expected kv:i:<int>/kv:s:<name> entries)"
                    % (path, k))
            store[int(parts[2]) if parts[1] == "i" else parts[2]] = v
        self._store = store
        return saved_world
