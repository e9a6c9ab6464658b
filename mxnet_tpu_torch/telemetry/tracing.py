"""Distributed tracing: trace context, span records, tail-sampled export.

The counterpart of ``mxnet_tpu/telemetry/tracing.py``, pure Python and
the same code, so the two packages make the same decisions from the same
trace ids and durations and write the same ``mxtpu-trace/1`` JSONL:

* **trace context** — W3C-traceparent-style identity
  (``trace_id``/``span_id``/``parent_id``), thread-local
  (:func:`current`/:func:`attach`/:func:`detach`) and explicitly
  attachable (:func:`record_span`);
* **span upgrade** — every :class:`~mxnet_tpu_torch.telemetry.spans.span`
  entered while a trace is active records its interval into that trace;
* **tail-sampled retention** — error/shed traces always kept, the slowest
  ``1 - MXNET_TPU_TRACE_SLOW_PCT`` of recent roots always kept, the rest
  sampled at ``MXNET_TPU_TRACE_SAMPLE`` (deterministic on the trace id);
  ``MXNET_TPU_TRACE_SAMPLE=0`` turns tracing off (:data:`NULL_TRACE`);
* **export** — kept traces append one line to
  ``MXNET_TPU_TRACE_DIR/trace.rank<N>.jsonl`` (ring size
  ``MXNET_TPU_TRACE_RING``); the JAX ``tools/trace_top.py`` reads them;
* **exemplars** — :func:`exemplar_for` resolves a histogram's
  slowest-bucket trace id.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

__all__ = [
    "TRACE_SCHEMA", "TraceContext", "Trace", "NULL_TRACE",
    "sample_rate", "enabled", "ring_capacity", "trace_dir", "slow_pct",
    "new_trace_id", "new_span_id", "parse_traceparent",
    "current", "attach", "detach",
    "start_trace", "record_span", "set_trace_status",
    "annotate", "take_annotations",
    "traces", "get_trace", "reset", "exemplar_for",
    "read_traces", "merge_traces", "merge_trace_dir",
    "critical_path", "dominant_segment",
]

log = logging.getLogger(__name__)

#: the per-trace JSONL export schema tag (one line per kept trace)
TRACE_SCHEMA = "mxtpu-trace/1"

_tls = threading.local()
_lock = threading.Lock()
_active = {}                # trace_id -> in-flight trace doc
_ring = deque()             # kept finished traces (bounded in _finish)
_durs = deque(maxlen=512)   # recent root durations (slow-tail threshold)
_counters = {}              # (metric, label value) -> bound child cache
_warned_write = [False]


# ------------------------------------------------------------- env knobs

def sample_rate():
    """Head/tail sample rate for ordinary (ok, not-slow) traces
    (``MXNET_TPU_TRACE_SAMPLE``, default 1.0, clamped to [0, 1]).
    0 disables tracing entirely."""
    try:
        v = float(os.environ.get("MXNET_TPU_TRACE_SAMPLE", "1"))
    except ValueError:
        return 1.0
    return min(1.0, max(0.0, v))


def enabled():
    """Tracing master switch — ``sample_rate() > 0``."""
    return sample_rate() > 0.0


def ring_capacity():
    """Kept-trace ring capacity (``MXNET_TPU_TRACE_RING``, default
    256, floor 8)."""
    try:
        n = int(os.environ.get("MXNET_TPU_TRACE_RING", "256"))
    except ValueError:
        n = 256
    return max(8, n)


def trace_dir():
    """JSONL export directory (``MXNET_TPU_TRACE_DIR``), or None when
    export is off (the in-process ring still fills)."""
    return os.environ.get("MXNET_TPU_TRACE_DIR") or None


def slow_pct():
    """Slow-tail retention percentile (``MXNET_TPU_TRACE_SLOW_PCT``,
    default 0.95): root durations at or above this percentile of the
    recent window are always kept."""
    try:
        v = float(os.environ.get("MXNET_TPU_TRACE_SLOW_PCT", "0.95"))
    except ValueError:
        return 0.95
    return min(0.999, max(0.5, v))


def _rank():
    try:
        return int(os.environ.get("MXNET_TPU_PROCESS_ID", "0") or 0)
    except ValueError:
        return 0


# ------------------------------------------------------------ identities

def new_trace_id():
    """A fresh 32-hex-char (128-bit) trace id."""
    return os.urandom(16).hex()


def new_span_id():
    """A fresh 16-hex-char (64-bit) span id."""
    return os.urandom(8).hex()


def parse_traceparent(header):
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header
    (``00-<32hex>-<16hex>-<flags>``), or None when malformed — a bad
    inbound header starts a fresh trace instead of poisoning the
    export."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, tid, sid = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(tid) != 32 or len(sid) != 16:
        return None
    try:
        int(version, 16), int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid, sid


class TraceContext:
    """One span's identity inside a trace.  Immutable; ``child()``
    derives the context a nested span runs under."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self):
        return TraceContext(self.trace_id, new_span_id(), self.span_id)

    def to_traceparent(self):
        return "00-%s-%s-01" % (self.trace_id, self.span_id)

    def __repr__(self):
        return "TraceContext(%s/%s<-%s)" % (self.trace_id, self.span_id,
                                            self.parent_id)


# ------------------------------------------------------ thread-local ctx

def current():
    """The calling thread's active :class:`TraceContext`, or None."""
    return getattr(_tls, "ctx", None)


def attach(ctx):
    """Make ``ctx`` the calling thread's active context; returns the
    previous one (pass it back to :func:`detach`)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def detach(prev):
    """Restore the context :func:`attach` displaced."""
    _tls.ctx = prev


# ------------------------------------------------------- span annotations

def annotate(**attrs):
    """Attach attributes to the span the CURRENT dispatch is being
    timed under (the ladder's rung/pad/slice detail).  The attrs park
    on a thread-local slot; the owner of the span collects them with
    :func:`take_annotations` when it records the span.  No-op without
    an active context."""
    if getattr(_tls, "ctx", None) is None:
        return
    d = getattr(_tls, "pending", None)
    if d is None:
        d = _tls.pending = {}
    d.update(attrs)


def take_annotations():
    """Drain and return the calling thread's pending span attributes."""
    d = getattr(_tls, "pending", None)
    if not d:
        return {}
    _tls.pending = {}
    return d


# ------------------------------------------------------------ the handle

class _NullTrace:
    """The shared disabled-trace handle: every method is a no-op and
    ``trace_id``/``ctx`` are None.  Returned by :func:`start_trace`
    when tracing is off so the request path allocates nothing."""

    __slots__ = ()
    ctx = None
    trace_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        pass

    def set_status(self, status, **attrs):
        pass


NULL_TRACE = _NullTrace()


class Trace:
    """A root span + trace lifetime, used as a context manager.  On
    exit the trace is finalized: tail-sampling decides retention, kept
    traces land in the ring and (``MXNET_TPU_TRACE_DIR``) the per-rank
    JSONL export."""

    __slots__ = ("ctx", "name", "_attrs", "_prev", "_t0", "_p0")

    def __init__(self, name, ctx, attrs=None):
        self.name = name
        self.ctx = ctx
        self._attrs = dict(attrs) if attrs else {}
        self._prev = None
        self._t0 = 0.0
        self._p0 = 0.0

    @property
    def trace_id(self):
        return self.ctx.trace_id

    def __enter__(self):
        self._prev = attach(self.ctx)
        self._t0 = time.time()
        self._p0 = time.perf_counter()
        doc = {"trace_id": self.ctx.trace_id, "root": self.name,
               "rank": _rank(), "ts": round(self._t0, 6),
               "status": "ok", "attrs": self._attrs, "spans": []}
        with _lock:
            _active[self.ctx.trace_id] = doc
        return self

    def annotate(self, **attrs):
        """Merge attributes onto the trace document."""
        with _lock:
            doc = _active.get(self.ctx.trace_id)
            if doc is not None:
                doc["attrs"].update(attrs)

    def set_status(self, status, **attrs):
        """Mark the trace's final status (``shed`` / ``error``); later
        exception-driven marking never downgrades it."""
        set_trace_status(self.ctx, status, **attrs)

    def __exit__(self, etype, exc, tb):
        dur = time.perf_counter() - self._p0
        detach(self._prev)
        with _lock:
            doc = _active.pop(self.ctx.trace_id, None)
        if doc is None:
            return False
        if etype is not None and doc["status"] == "ok":
            doc["status"] = "error"
            doc["attrs"].setdefault("error", str(exc)[:200])
        doc["dur_s"] = round(dur, 6)
        doc["spans"].insert(0, {
            "span_id": self.ctx.span_id,
            "parent_id": self.ctx.parent_id,
            "name": self.name, "ts": doc["ts"],
            "dur_s": doc["dur_s"]})
        _finish(doc)
        return False


def start_trace(name, traceparent=None, attrs=None):
    """Begin a trace rooted at ``name``; use as a context manager.
    ``traceparent`` (a W3C header value) continues an inbound trace —
    the root span becomes a child of the remote parent under the SAME
    trace id.  Returns :data:`NULL_TRACE` when tracing is disabled."""
    if sample_rate() <= 0.0:
        return NULL_TRACE
    parent = parse_traceparent(traceparent) if traceparent else None
    if parent is not None:
        ctx = TraceContext(parent[0], new_span_id(), parent[1])
    else:
        ctx = TraceContext(new_trace_id(), new_span_id(), None)
    return Trace(name, ctx, attrs=attrs)


def record_span(ctx, name, ts, dur_s, attrs=None, links=None,
                status=None, span_id=None):
    """Record one finished span as a child of ``ctx`` (any thread may
    call — this is the explicit-attach path the batch scheduler uses).
    ``ts`` is epoch seconds, ``dur_s`` wall seconds.  ``links`` is a
    list of ``{"trace_id", "span_id"}`` references (batch fan-in: one
    dispatch, many parents).  Pass ``span_id`` to pin the id (the same
    dispatch span recorded into N member traces keeps ONE id).
    Returns the span id, or None when the trace is not active."""
    if ctx is None:
        return None
    rec = {"span_id": span_id or new_span_id(),
           "parent_id": ctx.span_id, "name": name,
           "ts": round(ts, 6), "dur_s": round(dur_s, 6)}
    if attrs:
        rec["attrs"] = dict(attrs)
    if links:
        rec["links"] = list(links)
    if status:
        rec["status"] = status
    with _lock:
        doc = _active.get(ctx.trace_id)
        if doc is None:
            return None
        doc["spans"].append(rec)
    return rec["span_id"]


def set_trace_status(ctx, status, **attrs):
    """Mark an in-flight trace's final status by context (``shed``
    with its reason, ``error``); merges ``attrs`` into the trace."""
    if ctx is None:
        return
    with _lock:
        doc = _active.get(ctx.trace_id)
        if doc is not None:
            doc["status"] = str(status)
            doc["attrs"].update(attrs)


# ------------------------------------------------- finalize / tail-sample

def _hash_unit(trace_id):
    """Deterministic [0, 1) from the trace id — every rank samples the
    same traces."""
    try:
        return int(trace_id[:13], 16) / float(16 ** 13)
    except (ValueError, TypeError):
        return 0.0


def _slow_threshold():
    """Duration at the slow percentile of the recent-roots window, or
    None until 20 roots have finished (early traces fall through to
    the sample gate)."""
    with _lock:
        durs = sorted(_durs)
    if len(durs) < 20:
        return None
    i = min(len(durs) - 1, int(slow_pct() * len(durs)))
    return durs[i]


def _count(name, label, value):
    from .registry import counter
    key = (name, value)
    c = _counters.get(key)
    if c is None:
        c = _counters[key] = counter(name).labels(**{label: value})
    c.inc()


def _finish(doc):
    status = doc["status"]
    dur = doc["dur_s"]
    thresh = _slow_threshold()
    with _lock:
        _durs.append(dur)
    if status != "ok":
        keep, why = True, status          # error / shed: always kept
    elif thresh is not None and dur >= thresh:
        keep, why = True, "slow"          # the slow tail: always kept
    else:
        keep, why = _hash_unit(doc["trace_id"]) < sample_rate(), \
            "sampled"
    _count("mxtpu_traces_total", "status", status)
    if not keep:
        return
    doc["keep"] = why
    _count("mxtpu_traces_kept_total", "reason", why)
    cap = ring_capacity()
    with _lock:
        _ring.append(doc)
        while len(_ring) > cap:
            _ring.popleft()
    d = trace_dir()
    if d:
        _export(doc, d)


def _export(doc, directory):
    path = os.path.join(directory, "trace.rank%d.jsonl" % _rank())
    line = json.dumps(dict(doc, schema=TRACE_SCHEMA), sort_keys=True,
                      default=repr)
    try:
        os.makedirs(directory, exist_ok=True)
        with _lock:
            with open(path, "a") as f:
                f.write(line + "\n")
    except OSError as e:
        if not _warned_write[0]:
            _warned_write[0] = True
            log.warning("tracing: cannot append trace to %s: %s",
                        path, e)


# --------------------------------------------------------- ring access

def traces():
    """Kept traces, oldest first (copies of the ring)."""
    with _lock:
        return [dict(t) for t in _ring]


def get_trace(trace_id):
    """One kept trace by id, or None."""
    with _lock:
        for t in reversed(_ring):
            if t["trace_id"] == trace_id:
                return dict(t)
    return None


def reset():
    """Drop in-flight and kept traces, the duration window, and the
    calling thread's context (``telemetry.reset()`` calls this)."""
    with _lock:
        _active.clear()
        _ring.clear()
        _durs.clear()
    _tls.ctx = None
    _tls.pending = {}


# ----------------------------------------------------------- exemplars

def exemplar_for(metric, labels=None):
    """The trace id remembered by the highest (slowest) populated
    bucket of a histogram whose labels contain ``labels`` — the
    exemplar healthd alerts and serve_top name next to p99.  None when
    the metric has no exemplars (or the registry is unavailable —
    by-path loads)."""
    try:
        from .registry import REGISTRY
    except ImportError:
        return None
    m = REGISTRY.get(metric)
    if m is None or getattr(m, "kind", None) != "histogram":
        return None
    want = {k: str(v) for k, v in (labels or {}).items()}
    best = None
    for key, s in m.samples().items():
        kv = dict(key)
        if any(kv.get(k) != v for k, v in want.items()):
            continue
        for i, rec in (s.get("exemplars") or {}).items():
            if best is None or i > best[0] or \
                    (i == best[0] and rec[2] > best[2]):
                best = (i, rec[0], rec[2])
    return best[1] if best else None


# ======================================================================
# Reader / merge half — stdlib only, as the JAX module's, whose
# tools/trace_top.py reads the files this module writes.
# ======================================================================

def read_trace_lines(path):
    """Parse one ``mxtpu-trace/1`` JSONL file -> list of trace docs.
    Raises ValueError on a wrong-schema line (trace files are
    machine-written; silent tolerance would hide producer bugs)."""
    out = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if doc.get("schema") != TRACE_SCHEMA:
                raise ValueError(
                    "%s:%d: schema %r != %s"
                    % (path, ln, doc.get("schema"), TRACE_SCHEMA))
            out.append(doc)
    return out


def read_traces(path):
    """Traces from a file, or from every ``trace*.jsonl`` of a
    directory MERGED by trace id (a fleet-wide trace becomes one
    doc)."""
    if os.path.isdir(path):
        docs = []
        for name in sorted(os.listdir(path)):
            if name.startswith("trace") and name.endswith(".jsonl") \
                    and name != "trace.merged.jsonl":
                docs.extend(read_trace_lines(os.path.join(path, name)))
        return merge_traces(docs)
    return merge_traces(read_trace_lines(path))


_STATUS_RANK = {"ok": 0, "shed": 1, "error": 2}


def merge_traces(docs):
    """Group per-rank trace docs by trace id: spans concatenate, the
    root comes from the doc that owns the root span (no parent), the
    status escalates (error > shed > ok), and ``ranks`` lists every
    contributor.  Order: first appearance."""
    merged, order = {}, []
    for doc in docs:
        tid = doc.get("trace_id")
        cur = merged.get(tid)
        if cur is None:
            cur = dict(doc)
            cur["ranks"] = [doc.get("rank", 0)]
            merged[tid] = cur
            order.append(tid)
            continue
        had_root = any(s.get("parent_id") is None
                       for s in cur.get("spans", ()))
        seen = {s.get("span_id") for s in cur.get("spans", ())}
        cur["spans"] = list(cur.get("spans", ())) + [
            s for s in doc.get("spans", ())
            if s.get("span_id") not in seen]
        if doc.get("rank", 0) not in cur["ranks"]:
            cur["ranks"].append(doc.get("rank", 0))
        if _STATUS_RANK.get(doc.get("status"), 0) > \
                _STATUS_RANK.get(cur.get("status"), 0):
            cur["status"] = doc.get("status")
        cur["dur_s"] = max(cur.get("dur_s", 0.0),
                           doc.get("dur_s", 0.0))
        # the doc holding the parentless root span names the trace
        if not had_root and any(s.get("parent_id") is None
                                for s in doc.get("spans", ())):
            cur["root"] = doc.get("root")
            cur["rank"] = doc.get("rank", 0)
            cur["ts"] = doc.get("ts")
    return [merged[t] for t in order]


def merge_trace_dir(directory, out_path=None):
    """Merge every per-rank trace file of ``directory`` into
    ``trace.merged.jsonl`` (one line per fleet-wide trace); returns
    the written path, or None when there was nothing to merge."""
    docs = read_traces(directory)
    if not docs:
        return None
    out_path = out_path or os.path.join(directory,
                                        "trace.merged.jsonl")
    tmp = "%s.tmp.%d" % (out_path, os.getpid())
    with open(tmp, "w") as f:
        for doc in docs:
            f.write(json.dumps(dict(doc, schema=TRACE_SCHEMA),
                               sort_keys=True, default=repr) + "\n")
    os.replace(tmp, out_path)
    return out_path


# ------------------------------------------------------- critical path

def critical_path(doc):
    """Per-span-name EXCLUSIVE seconds for one trace: each span's wall
    minus its direct children's wall (clamped at 0), so concurrent
    instrumentation depth never double-counts.  The aggregate
    ``trace_top`` ranks."""
    spans = doc.get("spans") or []
    child_wall = {}
    for s in spans:
        p = s.get("parent_id")
        if p is not None:
            child_wall[p] = child_wall.get(p, 0.0) \
                + float(s.get("dur_s") or 0.0)
    out = {}
    for s in spans:
        excl = max(0.0, float(s.get("dur_s") or 0.0)
                   - child_wall.get(s.get("span_id"), 0.0))
        out[s.get("name") or "?"] = out.get(s.get("name") or "?", 0.0) \
            + excl
    return out


def dominant_segment(doc):
    """``(name, exclusive_s)`` of the segment the trace's wall lives
    in, or (None, 0.0) for an empty trace."""
    cp = critical_path(doc)
    if not cp:
        return None, 0.0
    name = max(cp, key=cp.get)
    return name, cp[name]
