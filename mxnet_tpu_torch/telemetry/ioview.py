"""Input-pipeline observability: per-stage accounting, time-weighted
queue occupancy, bottleneck attribution, and iterator position.

The counterpart of ``mxnet_tpu/telemetry/ioview.py``, the same code.
The step segments (:mod:`.distview`) say *when* the data plane is the
straggler (``input_wait`` dominates the step); this module says *why*.  The input
pipeline is modeled as a staged dataflow::

    read -> decode -> augment -> batch -> host_prefetch -> device_stage

and every stage accounts wall time, item count, and bytes at its emit
site (``recordio.py`` / ``io_native.py`` readers, ``image.py`` decode +
augmenters, ``io.py`` prefetchers, the trainer's host->device staging)
into the ``mxtpu_io_stage_*`` catalog metrics.  Three more pieces:

* **time-weighted queue occupancy** (:func:`queue_tracker`) — the
  prefetch queues used to export ``set(qsize())`` from BOTH the
  producer and the consumer thread, so the depth gauge flapped with
  scheduling; the tracker owns an internal depth counter, accumulates
  *seconds spent at each depth* into the weighted
  ``mxtpu_io_queue_occupancy`` histogram, and sets the legacy
  ``mxtpu_io_prefetch_depth`` gauge as a consistent last-observed value
  under its own lock;
* **bottleneck classification** (:func:`classify`) — per window
  (``MXNET_TPU_IOVIEW_WINDOW`` seconds), consumer-stall time (the
  training loop blocked on the pipeline) is weighed against
  producer-starved time (prefetch threads idle waiting for the
  consumer): stall-dominant windows are *producer-bound* and name the
  slowest work stage, starved-dominant windows are *consumer-bound*
  (the device binds, the pipeline is healthy), the rest are *balanced*.
  Each verdict bumps ``mxtpu_io_bottleneck_total{stage}`` and leaves an
  ``io_bottleneck`` flight event;
* **iterator position** (:func:`track` / :func:`current_position`) — a
  ``position()`` API threaded through the DataIter chain (epoch, shard
  id, record offset, resync count); the tracked iterator's position
  rides each sampled step's JSONL record and is written into
  checkpoint-manifest meta as advisory ``data_position`` (the
  observability half of mid-epoch resume; restore comes later).

Per-step surface: :func:`step_record` (called by
``telemetry.exporters.step_end`` every ``MXNET_TPU_IOVIEW_EVERY``
steps) returns the ``io`` block of the JSONL step record — per-stage
deltas, stall/starved deltas, occupancy snapshot, the latest verdict,
and the iterator position.  The JAX ``tools/io_top.py`` renders the
port's stream unchanged.

The port's emit sites are the counterparts of the JAX ones:
``recordio.MXRecordIO.read`` and the native reader (``read``), the
native pipeline (``decode`` for the read and decode behind one call,
``batch`` for the batch's assembly, raw uint8 batches included),
``image.imdecode`` (``decode``) and ``ImageIter``'s augmenters and batch,
``io.PrefetchingIter`` (``host_prefetch``, the ``host`` queue) and
``io.DevicePrefetchIter`` (``device_stage``, the ``device`` queue).
Nothing here touches a tensor: the accounts are host wall times and
counts, so no sync with the card is added.
"""
from __future__ import annotations

import os
import threading
import time
import weakref

__all__ = [
    "STAGES", "IOTOP_SCHEMA", "DEPTH_BUCKETS",
    "ioview_every", "window_seconds",
    "account", "note_stall", "note_starved", "queue_tracker",
    "OccupancyTracker", "track", "current_position",
    "classify", "step_record", "snapshot", "summary", "reset",
    "summarize_io",
]

#: pipeline stages, in dataflow order (work stages the classifier ranks)
STAGES = ("read", "decode", "augment", "batch", "host_prefetch",
          "device_stage")

#: io_top --json schema tag
IOTOP_SCHEMA = "mxtpu-iotop/1"

#: queue-depth upper bounds for the time-weighted occupancy histogram
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

# indirection so tests can drive the clock deterministically
_now = time.perf_counter

# per-thread accumulated stage seconds: lets a wrapper stage (the
# host_prefetch producer) account its wall EXCLUSIVE of the inner
# stages that ran on the same thread — otherwise the wrapper is >= the
# sum of its children by construction and always "wins" the slowest-
# stage verdict
_tls = threading.local()


def thread_accounted():
    """Stage seconds accounted on THIS thread so far (monotonic;
    subtract two readings to get the inner-stage time of a region)."""
    return getattr(_tls, "accounted", 0.0)


def ioview_every():
    """Attach the ``io`` block to every Nth step's JSONL record
    (``MXNET_TPU_IOVIEW_EVERY``, default 1 = every step; 0 disables the
    per-step block — stage metrics and the classifier keep running)."""
    try:
        return max(0, int(os.environ.get("MXNET_TPU_IOVIEW_EVERY", "1")))
    except ValueError:
        return 1


def window_seconds():
    """Bottleneck-classifier window length in seconds
    (``MXNET_TPU_IOVIEW_WINDOW``, default 5)."""
    try:
        return max(0.05, float(os.environ.get("MXNET_TPU_IOVIEW_WINDOW",
                                              "5")))
    except ValueError:
        return 5.0


# ------------------------------------------------------- stage accounting

_lock = threading.Lock()
# stage -> [seconds, items, bytes] (process totals)
_stages = {}
# iter name -> seconds (process totals)
_stall = {}
_starved = {}
# snapshots consumed by step_record / classify deltas
_step_state = {"calls": 0, "t0": None, "stages": {}, "stall": {},
               "starved": {}}
_win_state = {"t0": None, "stages": {}, "stall": {}, "starved": {},
              "last": None}
# first-activity timestamp: the whole-run "window" the read-only
# classification (summary) and ingest rates are computed over
_activity = [None]
# cached bound metric children (hot path: one lock + dict math)
_metric_cache = {}


def _stage_metrics(stage):
    m = _metric_cache.get(("stage", stage))
    if m is None:
        from .registry import counter, histogram
        m = (histogram("mxtpu_io_stage_seconds").labels(stage=stage),
             counter("mxtpu_io_stage_items_total").labels(stage=stage),
             counter("mxtpu_io_bytes_total").labels(stage=stage))
        _metric_cache[("stage", stage)] = m
    return m


def account(stage, seconds, items=0, nbytes=0):
    """Charge one unit of work (a record, an image, a batch) to a
    pipeline stage: ``seconds`` wall time, ``items`` processed,
    ``nbytes`` moved.  Hot path — called per record by the readers —
    so the cost is one lock plus three metric updates."""
    seconds = max(0.0, float(seconds))
    with _lock:
        acc = _stages.get(stage)
        if acc is None:
            acc = _stages[stage] = [0.0, 0.0, 0.0]
        acc[0] += seconds
        acc[1] += items
        acc[2] += nbytes
        if _activity[0] is None:
            _activity[0] = _now()
    _tls.accounted = thread_accounted() + seconds
    sec_h, items_c, bytes_c = _stage_metrics(stage)
    sec_h.observe(seconds)
    if items:
        items_c.inc(items)
    if nbytes:
        bytes_c.inc(nbytes)


def note_stall(iter_, seconds):
    """The consumer blocked ``seconds`` waiting on the ``iter_``
    (``host``/``device``) prefetcher — the producer-bound signal."""
    seconds = max(0.0, float(seconds))
    with _lock:
        _stall[iter_] = _stall.get(iter_, 0.0) + seconds
        if _activity[0] is None:
            _activity[0] = _now()
    c = _metric_cache.get(("stall", iter_))
    if c is None:
        from .registry import counter
        c = counter("mxtpu_io_prefetch_stall_seconds_total").labels(
            iter=iter_)
        _metric_cache[("stall", iter_)] = c
    c.inc(seconds)


def note_starved(iter_, seconds):
    """A producer thread idled ``seconds`` waiting for the consumer to
    drain the ``iter_`` queue — the consumer-bound signal (a slow
    consumer must not be misread as a healthy pipeline).

    Intervals far beyond the classifier window (10x) are dropped: a
    producer parked across a validation pass or an inter-epoch pause is
    not pipeline backpressure, and one such gap would otherwise flip a
    whole postmortem to consumer-bound.  Genuine backpressure shows as
    a steady stream of sub-step-length intervals, which all count."""
    seconds = max(0.0, float(seconds))
    if seconds > 10.0 * window_seconds():
        return
    with _lock:
        _starved[iter_] = _starved.get(iter_, 0.0) + seconds
        if _activity[0] is None:
            _activity[0] = _now()
    c = _metric_cache.get(("starved", iter_))
    if c is None:
        from .registry import counter
        c = counter("mxtpu_io_prefetch_starved_seconds_total").labels(
            iter=iter_)
        _metric_cache[("starved", iter_)] = c
    c.inc(seconds)


# --------------------------------------------- time-weighted occupancy

class OccupancyTracker:
    """Time-weighted queue-depth accounting for one prefetch queue.

    The producer calls :meth:`adjust(+1)` after a put, the consumer
    :meth:`adjust(-1)` after a take; the tracker owns the depth counter
    (never ``qsize()`` read from two threads), accumulates the seconds
    spent at each depth into its waterline dict AND the weighted
    ``mxtpu_io_queue_occupancy{iter}`` histogram, and sets the
    ``mxtpu_io_prefetch_depth{iter}`` gauge under its own lock — a
    consistent last-observed value instead of the old producer/consumer
    ``set(qsize())`` race."""

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._depth = 0
        self._since = None
        self._levels = {}        # depth -> seconds
        self._hist = None
        self._gauge = None

    def _metrics(self):
        if self._hist is None:
            from .registry import gauge, histogram
            self._hist = histogram(
                "mxtpu_io_queue_occupancy",
                buckets=DEPTH_BUCKETS).labels(iter=self.name)
            self._gauge = gauge("mxtpu_io_prefetch_depth").labels(
                iter=self.name)
        return self._hist, self._gauge

    def _settle(self, now):
        # under self._lock: credit the elapsed interval to the depth
        # the queue actually held over it
        if self._since is not None:
            dt = max(0.0, now - self._since)
            if dt:
                self._levels[self._depth] = \
                    self._levels.get(self._depth, 0.0) + dt
                hist, _gauge = self._metrics()
                hist.observe(self._depth, weight=dt)
        self._since = now

    def adjust(self, delta):
        """Transition the depth by ``delta`` (+1 put, -1 take)."""
        now = _now()
        with self._lock:
            self._settle(now)
            self._depth = max(0, self._depth + int(delta))
            _hist, gauge = self._metrics()
            gauge.set(self._depth)

    def set_depth(self, depth):
        """Force the depth (reset / composite-ready transitions)."""
        now = _now()
        with self._lock:
            self._settle(now)
            self._depth = max(0, int(depth))
            _hist, gauge = self._metrics()
            gauge.set(self._depth)

    def depth(self):
        with self._lock:
            return self._depth

    def snapshot(self):
        """{"depth", "mean", "levels"} — mean is time-weighted."""
        now = _now()
        with self._lock:
            self._settle(now)
            total = sum(self._levels.values())
            mean = (sum(d * s for d, s in self._levels.items()) / total
                    if total else float(self._depth))
            return {"depth": self._depth,
                    "mean": round(mean, 3),
                    "levels": {str(d): round(s, 6)
                               for d, s in sorted(self._levels.items())}}


_trackers = {}


def queue_tracker(name):
    """Get-or-create the process tracker for the named queue
    (``host`` = PrefetchingIter, ``device`` = DevicePrefetchIter)."""
    with _lock:
        t = _trackers.get(name)
        if t is None:
            t = _trackers[name] = OccupancyTracker(name)
        return t


# ------------------------------------------------------ iterator position

_pos_ref = [None]


def track(it):
    """Register ``it`` as the run's active data iterator: its
    ``position()`` rides every sampled step record and checkpoint
    manifest.  Held by weakref — tracking never extends the iterator's
    lifetime.  Returns ``it`` so call sites can wrap in place."""
    try:
        _pos_ref[0] = weakref.ref(it)
    except TypeError:
        _pos_ref[0] = None
    return it


def current_position():
    """The tracked iterator's ``position()`` dict (epoch, shard, record
    offset, resync count — whatever the chain reports), or None when no
    iterator is tracked or it reports nothing.  Never raises: position
    is advisory observability, not control flow."""
    ref = _pos_ref[0]
    it = ref() if ref is not None else None
    if it is None:
        return None
    fn = getattr(it, "position", None)
    if not callable(fn):
        return None
    try:
        pos = fn()
    except Exception:  # mxlint: allow-broad-except(advisory position from arbitrary user iterators must never kill the step/checkpoint that asked for it)
        return None
    return pos if isinstance(pos, dict) else None


def current_state():
    """The tracked iterator's durable ``state()`` dict
    (``mxnet_tpu.io_resume`` contract), or None when no iterator is
    tracked or it declares no durable state.  Never raises: like
    position, capture at checkpoint time is best-effort — restore-side
    validation is where strictness lives."""
    ref = _pos_ref[0]
    it = ref() if ref is not None else None
    if it is None:
        return None
    fn = getattr(it, "state", None)
    if not callable(fn):
        return None
    try:
        st = fn()
    except Exception:  # mxlint: allow-broad-except(advisory state capture from arbitrary user iterators must never kill the checkpoint save that asked for it)
        return None
    return st if isinstance(st, dict) else None


def tracked_iterator():
    """The live tracked iterator object, or None — the restore side of
    the loop (``io_resume.apply_pending``) needs the object itself, not
    just its state."""
    ref = _pos_ref[0]
    return ref() if ref is not None else None


# --------------------------------------------------- bottleneck classifier

def _totals_locked():
    return ({k: tuple(v) for k, v in _stages.items()},
            dict(_stall), dict(_starved))


def _verdict(stage_delta, stall_s, starved_s, window_s=None):
    """The classification rule, shared by the live classifier and the
    io_top aggregation: stall-dominant -> producer-bound naming the
    slowest work stage; starved-dominant -> consumer-bound; else
    balanced.  A pipeline with NO prefetcher emits neither stall nor
    starved time (the stages run inline on the consumer thread) — there
    the work-to-wall ratio decides: stages eating most of the window
    ARE the bottleneck.  Returns None when there was no pipeline
    activity at all."""
    work = sum(s for s, _i, _b in stage_delta.values())
    if work <= 0.0 and stall_s <= 0.0 and starved_s <= 0.0:
        return None
    floor = 1e-4

    def _slowest():
        return max(stage_delta.items(),
                   key=lambda kv: kv[1][0])[0] if stage_delta else "read"

    if stall_s > max(2.0 * starved_s, floor):
        return {"verdict": "producer-bound", "stage": _slowest()}
    if starved_s > max(2.0 * stall_s, floor):
        return {"verdict": "consumer-bound", "stage": "consumer"}
    if stall_s <= floor and starved_s <= floor and window_s:
        if work > 0.5 * window_s:
            return {"verdict": "producer-bound", "stage": _slowest()}
        if work < 0.25 * window_s:
            return {"verdict": "consumer-bound", "stage": "consumer"}
    return {"verdict": "balanced", "stage": "balanced"}


def classify(force=False, commit=True):
    """Run the per-window bottleneck classifier.  No-op (returning the
    last verdict) until ``MXNET_TPU_IOVIEW_WINDOW`` seconds of window
    have elapsed, unless ``force``.  A verdict bumps
    ``mxtpu_io_bottleneck_total{stage}`` and records an
    ``io_bottleneck`` flight event.

    ``commit=False`` is the READ-ONLY form (:func:`summary` uses it):
    the verdict is computed over the whole run's totals without
    rotating the live window, bumping the counter, or touching the
    flight ring — a periodic snapshot caller must not perturb the
    production classifier cadence (``force`` is implied)."""
    now = _now()
    if not commit:
        with _lock:
            stages, stall, starved = _totals_locked()
            t0 = _activity[0]
        return _verdict(stages, sum(stall.values()),
                        sum(starved.values()),
                        window_s=(now - t0) if t0 else None)
    with _lock:
        if _win_state["t0"] is None:
            # arm with an EMPTY baseline: activity accumulated before
            # the first classify belongs to the first window (a forced
            # classify on a short run must still see it)
            _win_state["t0"] = now
            _win_state["stages"], _win_state["stall"], \
                _win_state["starved"] = {}, {}, {}
            if not force:
                return _win_state["last"]
        elapsed = now - _win_state["t0"]
        if not force and elapsed < window_seconds():
            return _win_state["last"]
        prev_stages = _win_state["stages"]
        prev_stall = _win_state["stall"]
        prev_starved = _win_state["starved"]
        cur_stages, cur_stall, cur_starved = _totals_locked()
        delta = {}
        for st, (s, i, b) in cur_stages.items():
            p = prev_stages.get(st, (0.0, 0.0, 0.0))
            ds = (s - p[0], i - p[1], b - p[2])
            if any(x > 0 for x in ds):
                delta[st] = ds
        stall_d = sum(cur_stall.values()) - sum(prev_stall.values())
        starved_d = sum(cur_starved.values()) - sum(prev_starved.values())
        _win_state["t0"] = now
        _win_state["stages"], _win_state["stall"], \
            _win_state["starved"] = cur_stages, cur_stall, cur_starved
        verdict = _verdict(delta, stall_d, starved_d,
                           window_s=elapsed or None)
        if verdict is None:
            return _win_state["last"]
        verdict = dict(verdict, window_s=round(elapsed, 3),
                       stall_s=round(max(0.0, stall_d), 6),
                       starved_s=round(max(0.0, starved_d), 6))
        _win_state["last"] = verdict
    from .registry import counter
    counter("mxtpu_io_bottleneck_total").labels(
        stage=verdict["stage"]).inc()
    from . import flight
    flight.record("io_bottleneck", **verdict)
    return verdict


# ------------------------------------------------------ per-step surface

def step_record():
    """The ``io`` block for this step's JSONL record, or None when the
    cadence (``MXNET_TPU_IOVIEW_EVERY``) skips this step or the
    pipeline saw no activity since the last emitted block.  Emitted
    fields are DELTAS since the previous block (so an aggregator can
    sum them); ``queues`` and ``position`` are absolute.  Also ticks
    the window classifier."""
    verdict = classify()
    every = ioview_every()
    if every == 0:
        return None
    with _lock:
        _step_state["calls"] += 1
        if (_step_state["calls"] - 1) % every:
            return None
        now = _now()
        t0 = _step_state["t0"]
        prev_stages = _step_state["stages"]
        prev_stall = _step_state["stall"]
        prev_starved = _step_state["starved"]
        cur_stages, cur_stall, cur_starved = _totals_locked()
        _step_state["t0"] = now
        _step_state["stages"], _step_state["stall"], \
            _step_state["starved"] = cur_stages, cur_stall, cur_starved
        stages = {}
        for st, (s, i, b) in cur_stages.items():
            p = prev_stages.get(st, (0.0, 0.0, 0.0))
            ds, di, db = s - p[0], i - p[1], b - p[2]
            if ds > 0 or di > 0 or db > 0:
                stages[st] = {"s": round(ds, 6), "items": round(di, 3),
                              "bytes": round(db, 3)}
        stall = {k: round(v - prev_stall.get(k, 0.0), 6)
                 for k, v in cur_stall.items()
                 if v - prev_stall.get(k, 0.0) > 0}
        starved = {k: round(v - prev_starved.get(k, 0.0), 6)
                   for k, v in cur_starved.items()
                   if v - prev_starved.get(k, 0.0) > 0}
        trackers = dict(_trackers)
    if not stages and not stall and not starved:
        return None
    rec = {"stages": stages}
    if stall:
        rec["stall_s"] = stall
    if starved:
        rec["starved_s"] = starved
    if trackers:
        rec["queues"] = {n: t.snapshot() for n, t in trackers.items()}
    if t0 is not None:
        rec["window_s"] = round(now - t0, 6)
    if verdict is not None:
        rec["bottleneck"] = {"verdict": verdict["verdict"],
                             "stage": verdict["stage"]}
    pos = current_position()
    if pos is not None:
        rec["position"] = pos
    return rec


def snapshot():
    """Process-lifetime totals: per-stage seconds/items/bytes,
    stall/starved seconds per prefetcher, queue occupancy."""
    with _lock:
        stages, stall, starved = _totals_locked()
        trackers = dict(_trackers)
    return {
        "stages": {st: {"s": round(s, 6), "items": i, "bytes": b}
                   for st, (s, i, b) in sorted(stages.items())},
        "stall_s": {k: round(v, 6) for k, v in sorted(stall.items())},
        "starved_s": {k: round(v, 6) for k, v in sorted(starved.items())},
        "queues": {n: t.snapshot() for n, t in sorted(trackers.items())},
    }


def summary():
    """The BENCH JSON ``io`` block: the snapshot totals plus a
    whole-run bottleneck verdict (read-only — repeated calls never
    rotate the live classifier window or emit verdict metrics/events)
    and the iterator position.  Cheap and exception-free when the run
    did no pipeline IO."""
    out = snapshot()
    out["bottleneck"] = classify(commit=False)
    pos = current_position()
    if pos is not None:
        out["position"] = pos
    return out


def reset():
    """Clear every accumulator, tracker, window, and the tracked
    iterator (``telemetry.reset`` calls this).  Cached metric children
    stay valid — the registry keeps metric objects across resets."""
    with _lock:
        _stages.clear()
        _stall.clear()
        _starved.clear()
        _trackers.clear()
        _step_state.update(calls=0, t0=None, stages={}, stall={},
                           starved={})
        _win_state.update(t0=None, stages={}, stall={}, starved={},
                          last=None)
        _activity[0] = None
    _pos_ref[0] = None


# ------------------------------------------------- aggregation (stdlib)
# Everything below is stdlib-only, as the JAX module's reader half.

def _io_blocks(records):
    """Yield ``(rank, io_block)`` from either a per-rank JSONL step-log
    (records with "io") or an ``mxtpu-run/1`` timeline (step records
    whose per-rank payloads carry "io")."""
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if rec.get("kind") == "step" and isinstance(rec.get("ranks"),
                                                    dict):
            for r, v in rec["ranks"].items():
                if isinstance(v, dict) and isinstance(v.get("io"), dict):
                    yield int(r), v["io"]
        elif isinstance(rec.get("io"), dict):
            try:
                r = int(rec.get("rank", 0) or 0)
            except (TypeError, ValueError):
                r = 0
            yield r, rec["io"]


def summarize_io(records, source=None):
    """Roll a record stream up into the ``mxtpu-iotop/1`` report:
    per-rank per-stage totals (seconds/items/bytes + throughput),
    stall/starved totals, the last queue occupancy waterlines, the last
    position, a per-rank verdict recomputed from the totals, the
    overall named bottleneck, and per-shard ingest skew.  Input records
    come from ``json.loads`` over a step-log or run timeline; raises
    ValueError when no ``io`` blocks are present."""
    ranks = {}
    for r, io in _io_blocks(records):
        agg = ranks.setdefault(r, {
            "stages": {}, "stall_s": {}, "starved_s": {},
            "queues": None, "position": None, "window_s": 0.0})
        for st, v in (io.get("stages") or {}).items():
            acc = agg["stages"].setdefault(st, [0.0, 0.0, 0.0])
            acc[0] += float(v.get("s") or 0.0)
            acc[1] += float(v.get("items") or 0.0)
            acc[2] += float(v.get("bytes") or 0.0)
        for key in ("stall_s", "starved_s"):
            for k, v in (io.get(key) or {}).items():
                agg[key][k] = agg[key].get(k, 0.0) + float(v or 0.0)
        if io.get("queues"):
            agg["queues"] = io["queues"]
        if io.get("position"):
            agg["position"] = io["position"]
        agg["window_s"] += float(io.get("window_s") or 0.0)
    if not ranks:
        raise ValueError(
            "no io blocks found — was the run recorded with "
            "MXNET_TPU_TELEMETRY_JSONL set and MXNET_TPU_IOVIEW_EVERY "
            "> 0?")
    out_ranks = {}
    overall = None
    overall_key = -1.0
    ingest = {}
    for r, agg in sorted(ranks.items()):
        stage_delta = {st: tuple(v) for st, v in agg["stages"].items()}
        stall_s = sum(agg["stall_s"].values())
        starved_s = sum(agg["starved_s"].values())
        window = agg["window_s"]
        verdict = _verdict(stage_delta, stall_s, starved_s,
                           window_s=window or None)
        items = max([v[1] for v in stage_delta.values()] or [0.0])
        rate = round(items / window, 3) if window > 0 else None
        ingest[r] = rate
        rd = {
            "stages": {st: {"s": round(s, 6), "items": i, "bytes": b,
                            "items_per_s": round(i / s, 3) if s else None}
                       for st, (s, i, b) in sorted(stage_delta.items())},
            "stall_s": {k: round(v, 6)
                        for k, v in sorted(agg["stall_s"].items())},
            "starved_s": {k: round(v, 6)
                          for k, v in sorted(agg["starved_s"].items())},
            "ingest_items_per_s": rate,
            "bottleneck": verdict,
        }
        if agg["queues"]:
            rd["queues"] = agg["queues"]
        if agg["position"]:
            rd["position"] = agg["position"]
        out_ranks[str(r)] = rd
        # the overall bottleneck: the producer-bound rank whose slow
        # stage burned the most wall; consumer-bound only when no rank
        # is pipeline-limited
        if verdict and verdict["verdict"] == "producer-bound":
            slow_s = stage_delta.get(verdict["stage"], (0.0,))[0]
            if slow_s > overall_key:
                overall_key = slow_s
                overall = dict(verdict, rank=r)
        elif overall is None and verdict is not None:
            overall = dict(verdict, rank=r)
    # skew only over ranks whose rate was actually measured — a rank
    # with no window data must not be "slowest at 0 items/s"
    measured = {r: v for r, v in ingest.items() if v}
    shard_skew = None
    if len(measured) >= 2:
        rates = list(measured.values())
        shard_skew = {
            "min_items_per_s": min(rates), "max_items_per_s": max(rates),
            "ratio": round(max(rates) / min(rates), 3) if min(rates)
            else None,
            "slowest_rank": min(measured, key=measured.get),
        }
    totals = {}
    for rd in out_ranks.values():
        for st, v in rd["stages"].items():
            acc = totals.setdefault(st, [0.0, 0.0, 0.0])
            acc[0] += v["s"]
            acc[1] += v["items"]
            acc[2] += v["bytes"]
    return {
        "schema": IOTOP_SCHEMA,
        "source": source,
        "num_ranks": len(out_ranks),
        "stages": {st: {"s": round(s, 6), "items": i, "bytes": b}
                   for st, (s, i, b) in sorted(totals.items())},
        "ranks": out_ranks,
        "bottleneck": overall,
        "shard_skew": shard_skew,
    }
