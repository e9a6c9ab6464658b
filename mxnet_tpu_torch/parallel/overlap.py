"""Communication overlap: bucketed gradient all-reduce.

The counterpart of ``mxnet_tpu/parallel/overlap.py``, DDP-style:

* :func:`plan_buckets` groups gradients into size-targeted buckets
  (``MXNET_TPU_BUCKET_BYTES``, default 4 MiB) in push order, the order
  the backward produces them;
* :class:`BucketQueue` launches a full bucket's all-reduce the moment its
  last gradient lands (``torch.distributed.all_reduce(async_op=True)``
  over the bucket flattened into one buffer: the call returns while the
  collective runs behind the rest of the backward) and waits for every
  bucket in flight only at the optimizer boundary (:meth:`drain`);
* :class:`OverlapScheduler` orders the buckets still pending at drain
  time slowest-to-produce first, from the measured skew history.

Every rank must launch the same bucket sequence in the same order: the
plan derives only from the push order and the sizes, and the scheduler
consumes only fleet-agreed skews (the all-gathered timestamps of
``distview.pre_collective_barrier``), never a rank's own clock.

A collective fault mid-drain (the ``kvstore.collective`` seam, a
transport error, a dead peer) raises an ``MXNetError`` before any result
reaches the caller, so optimizer state stays untouched.  Metrics:
``mxtpu_overlap_buckets_total{phase}``, ``mxtpu_overlap_bucket_bytes``,
``mxtpu_overlap_drain_seconds``, ``mxtpu_overlap_inflight_buckets``; each
launch leaves an ``overlap`` flight event and each drained bucket a
cost-database ``collective`` record (the wall the drain sat blocked on it).
``MXNET_TPU_OVERLAP`` (default on) gates the bucketed path.
"""
from __future__ import annotations

import time

from ..base import MXNetError

__all__ = [
    "overlap_enabled", "bucket_bytes", "max_inflight", "plan_buckets",
    "OverlapScheduler", "BucketQueue",
]

DEFAULT_BUCKET_BYTES = 4 << 20

#: byte-scale histogram buckets for the bucket-payload distribution
BYTE_BUCKETS = (1 << 10, 16 << 10, 256 << 10, 1 << 20, 4 << 20,
                16 << 20, 64 << 20, 256 << 20, 1 << 30)


def overlap_enabled():
    """Whether the bucketed-overlap path is on (``MXNET_TPU_OVERLAP``,
    default enabled — bit-parity with the per-push path is tested, so
    overlap is not an accuracy trade)."""
    import os
    return os.environ.get("MXNET_TPU_OVERLAP", "1") not in \
        ("0", "false", "False")


def bucket_bytes():
    """Bucket size target in bytes (``MXNET_TPU_BUCKET_BYTES``,
    default 4 MiB — the DDP default neighborhood; smaller buckets
    start communication earlier, larger ones amortize per-collective
    overhead)."""
    import os
    try:
        n = int(os.environ.get("MXNET_TPU_BUCKET_BYTES",
                               str(DEFAULT_BUCKET_BYTES)))
    except ValueError:
        n = DEFAULT_BUCKET_BYTES
    return max(1, n)


def max_inflight():
    """Launch-window cap (``MXNET_TPU_OVERLAP_INFLIGHT``, default 0 =
    unlimited): with a positive cap, a bucket that fills while the cap
    is reached is deferred instead of launched — the deferred buckets
    launch at the optimizer boundary in the scheduler's
    slowest-to-produce-first order.  Bounding in-flight collectives
    trades some backward overlap for less network contention; the
    default keeps every launch eager."""
    from .. import config
    try:
        n = int(config.uncatalogued("MXNET_TPU_OVERLAP_INFLIGHT"))
    except ValueError:
        n = 0
    return max(0, n)


def plan_buckets(sizes, target_bytes=None):
    """Greedy size-targeted bucket plan over ``sizes`` (an ordered
    ``[(key, nbytes)]`` in gradient-production order).  Returns a list
    of buckets, each a list of keys; a bucket closes once its payload
    reaches ``target_bytes`` (single oversized keys get their own
    bucket).  Deterministic: the plan is a pure function of the input
    order and sizes, so every rank computes the same plan — the first
    half of the cross-rank determinism invariant."""
    target = bucket_bytes() if target_bytes is None else \
        max(1, int(target_bytes))
    buckets, cur, cur_bytes = [], [], 0
    for key, nbytes in sizes:
        cur.append(key)
        cur_bytes += max(0, int(nbytes))
        if cur_bytes >= target:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


class OverlapScheduler:
    """Slowest-to-produce-first drain ordering from the skew history.

    Each measured bucket boundary (the sampled
    ``pre_collective_barrier``) yields a fleet-agreed skew value — the
    straggler's lead at that bucket.  The scheduler keeps a per-bucket
    EWMA of those values and orders the buckets pending at drain time
    by descending EWMA (ties by bucket id): the bucket that
    historically arrives last starts first, so its transfer gets the
    longest window to hide under the others' completion.

    DETERMINISM: feed :meth:`observe_skew` only fleet-identical values
    (allgathered skews).  Rank-local wall times must not enter — a
    rank-divergent order deadlocks the fleet (see the module
    docstring and MXG011).
    """

    def __init__(self, alpha=0.3):
        self._alpha = float(alpha)
        self._ewma = {}

    def observe_skew(self, bucket_id, skew_s):
        """Fold one fleet-agreed skew measurement into the EWMA of
        ``bucket_id``."""
        if skew_s is None:
            return
        prev = self._ewma.get(bucket_id)
        v = float(skew_s)
        self._ewma[bucket_id] = v if prev is None else \
            (1 - self._alpha) * prev + self._alpha * v

    def cost(self, bucket_id):
        return self._ewma.get(bucket_id, 0.0)

    def order(self, bucket_ids):
        """Drain order for the pending buckets: slowest (highest skew
        EWMA) first, bucket id breaking ties — identical on every rank
        because the EWMAs are."""
        return sorted(bucket_ids,
                      key=lambda b: (-self._ewma.get(b, 0.0), b))


class _Bucket:
    __slots__ = ("bucket_id", "keys", "values", "nbytes", "handle",
                 "phase")

    def __init__(self, bucket_id):
        self.bucket_id = bucket_id
        self.keys = []
        self.values = {}
        self.nbytes = 0
        self.handle = None
        self.phase = None


class BucketQueue:
    """Size-targeted gradient buckets with async launch + ordered drain.

    ``reduce_fn(bucket_dict)`` launches one bucket's cross-process
    all-reduce and returns a zero-argument callable that materializes
    ``{key: reduced}``: for ``DistKVStore`` the launch is one
    ``all_reduce(async_op=True)`` of the bucket's values flattened into
    one buffer, and the handle waits on its work and splits the buffer.
    Other transports plug in the same way.

    :meth:`push` appends one (key, value) in production order and
    launches the bucket once it reaches the byte target.  :meth:`drain`
    launches the remainder in scheduler order, materializes EVERY
    in-flight handle, and only then returns the merged results — the
    all-or-nothing contract the chaos test pins: a collective fault
    mid-drain (the ``kvstore.collective`` seam, or any transport error)
    raises a descriptive MXNetError with nothing handed to the caller,
    so optimizer state is untouched.
    """

    def __init__(self, reduce_fn, target_bytes=None, site="kvstore.push",
                 scheduler=None, skew_probe=None, inflight_cap=None):
        from ..telemetry.registry import counter, gauge, histogram
        self._reduce = reduce_fn
        self._target = bucket_bytes() if target_bytes is None else \
            max(1, int(target_bytes))
        self._site = site
        self.scheduler = scheduler or OverlapScheduler()
        # the sampled bucket-boundary skew measurement; overridable so
        # transports without a process group (tests) can supply their
        # own
        self._skew_probe = skew_probe or self._default_skew_probe
        # launch window (0 = unlimited): buckets that fill while the
        # window is closed defer to the drain, where the scheduler
        # orders them — the reachable half of slowest-first draining
        self._cap = max_inflight() if inflight_cap is None else \
            max(0, int(inflight_cap))
        self._next_id = 0
        self._open = None            # the bucket currently filling
        self._ready = []             # full, deferred by the launch cap
        self._inflight = []          # launched, not yet materialized
        self._step_keys = set()      # keys pushed since the last drain
        self._launched = counter("mxtpu_overlap_buckets_total")
        self._bytes_h = histogram("mxtpu_overlap_bucket_bytes",
                                  buckets=BYTE_BUCKETS)
        self._drain_h = histogram("mxtpu_overlap_drain_seconds")
        self._inflight_g = gauge("mxtpu_overlap_inflight_buckets")
        self.last_skew = None

    def _default_skew_probe(self):
        from ..telemetry import distview
        return distview.pre_collective_barrier(self._site)

    def _reset_step(self):
        """Discard every bucket of the current step — open, deferred,
        and in-flight — so the queue is reusable after a failure.
        In-flight handles are dropped unmaterialized: a step that
        errored must never have its partial buckets applied later."""
        self._open = None
        self._ready = []
        self._inflight = []
        self._inflight_g.set(0)
        self._next_id = 0
        self._step_keys = set()

    # ------------------------------------------------------------ filling
    def push(self, key, value, nbytes):
        """Append one gradient in production order; a bucket reaching
        the byte target launches immediately (``phase="backward"`` —
        the transfer overlaps the rest of gradient production) unless
        the launch window (``MXNET_TPU_OVERLAP_INFLIGHT``) is closed,
        in which case it defers to the drain's scheduler ordering.

        A launch failure here resets the whole step (same contract as
        a failed drain): the error propagates before the optimizer
        boundary, nothing was applied, and the queue is reusable."""
        if key in self._step_keys:
            # checked against EVERY bucket this step, not just the open
            # one — a duplicate straddling a bucket boundary would
            # otherwise allreduce twice and silently keep one result
            raise MXNetError(
                "a bucket already holds key %r this step — push each "
                "gradient key once per step, then drain()" % (key,))
        self._step_keys.add(key)
        if self._open is None:
            self._open = _Bucket(self._next_id)
            self._next_id += 1
        b = self._open
        b.keys.append(key)
        b.values[key] = value
        b.nbytes += max(0, int(nbytes))
        if b.nbytes >= self._target:
            self._open = None
            if self._cap and len(self._inflight) >= self._cap:
                self._ready.append(b)
            else:
                try:
                    self._launch(b, phase="backward")
                except BaseException:  # mxlint: allow-broad-except(reset-then-reraise — nothing is swallowed)
                    # a poisoned step must not leak its keys (the next
                    # attempt would see false duplicates) or its
                    # in-flight buckets (a later drain would apply a
                    # dead step's partial gradients)
                    self._reset_step()
                    raise

    @property
    def pending(self):
        """Buckets launched, deferred, or filling — not yet drained."""
        return len(self._inflight) + len(self._ready) + \
            (1 if self._open else 0)

    # ----------------------------------------------------------- launching
    def _launch(self, bucket, phase):
        """Dispatch one bucket's allreduce.  The sampled skew probe runs
        FIRST (the bucket boundary is the measurement point the
        per-push path used to have at every key) and its fleet-agreed
        skew feeds the scheduler; the ``kvstore.collective`` seam fires
        here so chaos specs can fault any launch, including mid-drain."""
        from .. import resilience
        from ..telemetry import flight as _flight
        bucket.phase = phase
        info = None
        try:
            info = self._skew_probe()
        except Exception:  # mxlint: allow-broad-except(the skew probe is optional instrumentation; a failed barrier degrades to unmeasured skew, never a dead drain)
            info = None
        if info is not None:
            self.last_skew = info
            self.scheduler.observe_skew(bucket.bucket_id,
                                        info.get("skew_s"))
        ev = {"op": "bucket_launch", "site": self._site,
              "bucket": bucket.bucket_id, "keys": len(bucket.keys),
              "bytes": bucket.nbytes, "phase": phase}
        if info is not None:
            ev["skew_s"] = round(info["skew_s"], 6)
            ev["wait_s"] = round(info["wait_s"], 6)
        _flight.record("overlap", **ev)
        try:
            resilience.fault_point("kvstore.collective")
            bucket.handle = self._reduce(dict(bucket.values))
        except MXNetError:
            raise
        except Exception as e:  # mxlint: allow-broad-except(re-raised as a descriptive MXNetError naming the bucket — any transport/backend failure must carry the drain contract, not a raw traceback)
            raise MXNetError(
                "bucketed allreduce launch failed for bucket %d "
                "(%d key(s), %d bytes) at %s: %s"
                % (bucket.bucket_id, len(bucket.keys), bucket.nbytes,
                   self._site, e)) from e
        self._launched.labels(phase=phase).inc()
        self._bytes_h.observe(float(bucket.nbytes))
        self._inflight.append(bucket)
        self._inflight_g.set(len(self._inflight))

    # ------------------------------------------------------------ draining
    def drain(self, mesh=None):
        """Launch every still-pending bucket (scheduler order,
        slowest-to-produce first), materialize ALL in-flight handles,
        and return the merged ``{key: reduced}``.

        All-or-nothing: any failure — an armed ``kvstore.collective``
        fault, a transport error, a dead peer — discards every bucket
        and raises a descriptive MXNetError naming the bucket; nothing
        is returned, so a caller that applies optimizer updates only
        from the return value leaves its state untouched.  The queue
        itself is reset and reusable after a failed drain (the next
        step pushes into fresh buckets)."""
        from ..telemetry import costdb as _costdb
        from ..telemetry import flight as _flight
        t0 = time.perf_counter()
        # the drain tail: buckets the launch window deferred, plus the
        # partial open bucket — the set the scheduler actually orders
        tail = list(self._ready)
        self._ready = []
        if self._open is not None and self._open.keys:
            tail.append(self._open)
        self._open = None
        order = {b.bucket_id: b for b in tail}
        try:
            for bid in self.scheduler.order(sorted(order)):
                self._launch(order[bid], phase="drain")
            results = {}
            for b in self._inflight:
                t_wait = time.perf_counter()
                try:
                    reduced = b.handle()
                except MXNetError:
                    raise
                except Exception as e:  # mxlint: allow-broad-except(re-raised as a descriptive MXNetError carrying the all-or-nothing drain contract; the raw transport error is chained)
                    raise MXNetError(
                        "bucketed allreduce failed for bucket %d "
                        "(%d key(s), %d bytes) at %s: %s — no buckets "
                        "were applied; optimizer state is untouched"
                        % (b.bucket_id, len(b.keys), b.nbytes,
                           self._site, e)) from e
                # the record's wall is the time the drain sat BLOCKED
                # on this bucket — the network cost overlap failed to
                # hide (a bucket that finished behind backward reads
                # ~0).  launch-to-materialize would span the whole
                # overlapped backward for phase="backward" buckets, so
                # the better the overlap worked the more
                # bandwidth-bound the roofline would wrongly read the
                # collectives.  block_kind keys backward-launched and
                # drain-launched buckets to separate records: a hidden
                # bucket's ~0 wall must not become the min-wall of the
                # unhidden drain tail's roofline estimate.
                wall = time.perf_counter() - t_wait
                _costdb.record(
                    "collective", "%s.bucket" % self._site,
                    wall_s=wall, bytes_accessed=float(b.nbytes),
                    shapes=[[len(b.keys)]], mesh=mesh,
                    block_kind=b.phase,
                    source="overlap-drain")
                results.update(reduced)
            dt = time.perf_counter() - t0
            self._drain_h.observe(dt)
            _flight.record("overlap", op="drain", site=self._site,
                           buckets=len(self._inflight),
                           seconds=round(dt, 6))
            return results
        except MXNetError as e:
            # a mid-drain fault must be explicit about the state
            # contract even when it fired at a launch seam
            if "optimizer state" not in str(e):
                e = MXNetError(
                    "%s — drain aborted before any result was handed "
                    "to the caller; no buckets were applied and "
                    "optimizer state is untouched" % e)
            raise e
        finally:
            # per-STEP bucket ids: the plan is deterministic, so bucket
            # N holds the same key set every step — resetting them here
            # is what lets the scheduler's EWMA accumulate a history
            # per bucket (monotonic ids would key every skew
            # observation to a fresh id, leaving every EWMA a single
            # sample)
            self._reset_step()
