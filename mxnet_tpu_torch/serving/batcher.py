"""Continuous batcher: coalescing, EDF deadlines, load shedding, fail fast.

The counterpart of ``mxnet_tpu/serving/batcher.py``, the request path
between the HTTP front door and the batch ladder:

* **coalescing**: requests wait in a bounded queue; the one scheduler
  thread waits at most one batching window (anchored at the oldest queued
  request) for the largest rung to fill, then dispatches the rows it has;
* **deadline scheduling**: earliest deadline first; just before dispatch
  each request's remaining deadline is checked against the ladder's
  estimated rung wall, and a hopeless request is shed then, before the
  device spends time on it;
* **load shedding**: a submit over the queue depth is refused at once with
  :class:`RequestShed` (``reason="queue_full"``); the deadline check sheds
  with ``reason="deadline"``;
* **fail fast**: a dispatch error (the ``serve.dispatch`` fault seam
  included) fails every request of that batch and the scheduler moves on;
  one bad batch never wedges the queue.

The window, depth and deadline default to ``MXNET_TPU_SERVE_WINDOW_MS``,
``_QUEUE_DEPTH`` and ``_DEADLINE_MS``.  As in the JAX batcher, requests,
sheds, rung dispatches, latency segments, occupancy and queue depth land
on the ``mxtpu_serve_*`` instruments; sheds and dispatches leave
``request_shed`` and ``rung_dispatch`` flight events; and a request
submitted under a trace gets its queue/coalesce/pad/dispatch/slice spans,
with one dispatch span shared by, and linked from, every coalesced
request's trace.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

import numpy as np

from ..base import MXNetError
from ..predictor import pad_batch, slice_rows
from ..telemetry import tracing

__all__ = ["Batcher", "RequestShed"]


class RequestShed(MXNetError):
    """A request refused by the load shedder (never dispatched).
    ``reason``: ``"queue_full"`` or ``"deadline"``; ``rid``: the batcher's
    request id.  The front door maps this to HTTP 503."""

    def __init__(self, reason, detail, rid=None):
        super().__init__("request%s shed (%s): %s"
                         % ("" if rid is None else " %d" % rid, reason,
                            detail))
        self.reason = reason
        self.rid = rid


def _env_float(name, default):
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return v if v > 0 else default


class _Request:
    __slots__ = ("rid", "feed", "rows", "deadline", "enqueue_t",
                 "dequeue_t", "done", "outputs", "error", "trace")

    def __init__(self, rid, feed, rows, deadline, now, trace=None):
        self.rid = rid
        self.feed = feed
        self.rows = rows
        self.deadline = deadline
        self.enqueue_t = now
        self.dequeue_t = None
        self.done = threading.Event()
        self.outputs = None
        self.error = None
        self.trace = trace      # the submitter's TraceContext (or None)


class Batcher:
    """Thread-safe request queue + one scheduler thread over a
    :class:`~mxnet_tpu_torch.serving.ladder.BatchLadder`, or any object
    with ``max_rung``, ``input_names``, ``input_tail``, ``input_dtype``,
    ``pick_rung``, ``estimate_wall``, ``observe_wall`` and ``dispatch``
    (the tests drive the scheduler with a fake ladder).

    ``window_ms``/``queue_depth``/``default_deadline_ms`` default to
    the ``MXNET_TPU_SERVE_*`` knobs."""

    def __init__(self, ladder, window_ms=None, queue_depth=None,
                 default_deadline_ms=None, start=True):
        from .. import telemetry
        from ..telemetry.catalog import OCCUPANCY_BUCKETS
        self._ladder = ladder
        self._window = (window_ms if window_ms is not None else
                        _env_float("MXNET_TPU_SERVE_WINDOW_MS", 5.0)) \
            / 1e3
        self._depth = int(queue_depth if queue_depth is not None else
                          _env_float("MXNET_TPU_SERVE_QUEUE_DEPTH", 64))
        self._deadline = (default_deadline_ms if default_deadline_ms
                          is not None else
                          _env_float("MXNET_TPU_SERVE_DEADLINE_MS",
                                     1000.0)) / 1e3
        self._cv = threading.Condition()
        self._pending = []
        self._stopped = False
        self._ids = itertools.count(1)
        self._dispatches = {}      # rung -> dispatches that ran
        # instruments (created once; .labels children cached per use
        # site below)
        self._m_requests = telemetry.counter("mxtpu_serve_requests_total")
        self._m_shed = telemetry.counter("mxtpu_serve_shed_total")
        self._m_rung = telemetry.counter(
            "mxtpu_serve_rung_dispatch_total")
        self._m_latency = telemetry.histogram(
            "mxtpu_serve_request_seconds")
        self._m_occupancy = telemetry.histogram(
            "mxtpu_serve_rung_occupancy", buckets=OCCUPANCY_BUCKETS)
        self._m_depth = telemetry.gauge("mxtpu_serve_queue_depth")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtt-serve-batcher")
        if start:
            self._thread.start()

    def close(self, timeout=5.0):
        """Stop the scheduler; queued requests fail with a stopped error."""
        with self._cv:
            self._stopped = True
            pending, self._pending = self._pending, []
            self._cv.notify_all()
        for req in pending:
            req.error = MXNetError("batcher stopped")
            req.done.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def alive(self):
        return self._thread.is_alive() and not self._stopped

    def queue_depth(self):
        with self._cv:
            return len(self._pending)

    def dispatch_counts(self):
        """{rung: number of dispatches run so far}."""
        with self._cv:
            return dict(self._dispatches)

    def submit(self, inputs, deadline_ms=None, timeout=None):
        """Block until the request is served; returns the list of output
        arrays sliced to this request's rows.  ``deadline_ms``: remaining
        deadline from now (default: the batcher's).  Raises
        :class:`RequestShed` when shed, or the dispatch error."""
        feed, rows = self._validate(inputs)
        now = time.monotonic()
        ddl = now + (deadline_ms / 1e3 if deadline_ms is not None
                     else self._deadline)
        req = _Request(next(self._ids), feed, rows, ddl, now,
                       trace=tracing.current())
        with self._cv:
            if self._stopped:
                raise MXNetError("batcher stopped")
            if deadline_ms is not None and deadline_ms <= 0:
                self._count_shed("deadline", req,
                                 "explicit deadline_ms=%r expired on "
                                 "arrival" % (deadline_ms,))
                raise RequestShed("deadline", "explicit deadline_ms=%r is "
                                  "already expired on arrival"
                                  % (deadline_ms,), rid=req.rid)
            if len(self._pending) >= self._depth:
                self._count_shed("queue_full", req,
                                 "queue depth %d" % self._depth)
                raise RequestShed("queue_full", "queue at bounded depth %d"
                                  % self._depth, rid=req.rid)
            # shed early: even alone in its smallest rung this request
            # cannot finish inside its deadline
            min_wall = self._ladder.estimate_wall(
                self._ladder.pick_rung(rows) or self._ladder.max_rung)
            if ddl - now < min_wall:
                self._count_shed("deadline", req,
                                 "deadline %.1fms < estimated wall "
                                 "%.1fms" % ((ddl - now) * 1e3,
                                             min_wall * 1e3))
                raise RequestShed(
                    "deadline", "remaining deadline %.1fms cannot cover "
                    "the estimated rung wall %.1fms"
                    % ((ddl - now) * 1e3, min_wall * 1e3), rid=req.rid)
            self._pending.append(req)
            self._m_depth.set(len(self._pending))
            self._cv.notify_all()
        wait = timeout if timeout is not None else \
            max(0.05, ddl - now) + 4.0 * max(
                0.025, self._ladder.estimate_wall(self._ladder.max_rung))
        if not req.done.wait(wait):
            raise MXNetError("request %d timed out after %.1fs in the "
                             "batcher" % (req.rid, wait))
        if req.error is not None:
            raise req.error
        return req.outputs

    def _validate(self, inputs):
        names = list(self._ladder.input_names)
        feed, rows = {}, None
        for n in names:
            if n not in inputs:
                raise MXNetError("missing input %r (serving inputs: %s)"
                                 % (n, names))
            arr = np.asarray(inputs[n], dtype=self._ladder.input_dtype(n))
            tail = tuple(self._ladder.input_tail(n))
            if arr.shape == tail:
                arr = arr[None]          # one unbatched row
            if arr.ndim != len(tail) + 1 or tuple(arr.shape[1:]) != tail:
                raise MXNetError("input %r: expected rows of shape %r, got "
                                 "%r" % (n, tail, tuple(arr.shape)))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise MXNetError("inputs disagree on batch rows (%d vs %d)"
                                 % (rows, arr.shape[0]))
            feed[n] = arr
        if rows < 1:
            raise MXNetError("empty request (0 rows)")
        if rows > self._ladder.max_rung:
            raise MXNetError(
                "request rows %d exceed the largest ladder rung %d; "
                "split the request or extend MXNET_TPU_SERVE_LADDER"
                % (rows, self._ladder.max_rung))
        return feed, rows

    def _count_shed(self, reason, req, detail):
        from ..telemetry import flight
        self._m_shed.labels(reason=reason).inc()
        self._m_requests.labels(outcome="shed").inc()
        if req.trace is not None:
            # the trace outlives the refusal: mark it shed so tail-
            # sampling ALWAYS keeps it and trace_top can explain it
            tracing.set_trace_status(req.trace, "shed",
                                     shed_reason=reason, rid=req.rid)
        extra = {} if req.trace is None else \
            {"trace_id": req.trace.trace_id}
        flight.record("request_shed", reason=reason, rid=req.rid,
                      rows=req.rows,
                      waited_ms=round(
                          (time.monotonic() - req.enqueue_t) * 1e3, 3),
                      detail="rid %d: %s" % (req.rid, detail), **extra)

    def _shed_queued(self, req, reason, detail):
        self._count_shed(reason, req, detail)
        req.error = RequestShed(reason, detail, rid=req.rid)
        req.done.set()

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            if batch:
                self._dispatch(batch)

    def _collect(self):
        """Wait out the batching window and select the EDF batch.  Returns
        None on stop, else a possibly empty list."""
        with self._cv:
            while not self._pending and not self._stopped:
                self._cv.wait()
            if self._stopped:
                return None
            window_end = min(r.enqueue_t for r in self._pending) \
                + self._window
            while (not self._stopped and sum(r.rows for r in self._pending)
                   < self._ladder.max_rung):
                left = window_end - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            if self._stopped:
                return None
            # earliest deadline first, into the largest rung the queue
            # reaches; what does not fit waits for the next round
            self._pending.sort(key=lambda r: r.deadline)
            batch, rows = [], 0
            for req in list(self._pending):
                if rows + req.rows > self._ladder.max_rung:
                    break
                batch.append(req)
                rows += req.rows
            for req in batch:
                self._pending.remove(req)
                req.dequeue_t = time.monotonic()
            self._m_depth.set(len(self._pending))
            return batch

    def _dispatch(self, batch):
        from ..telemetry import flight
        from .. import resilience
        # deadline feasibility at the last moment; shedding shrinks the
        # batch, which can shrink the rung and its estimate, so iterate
        while batch:
            rows = sum(r.rows for r in batch)
            rung = self._ladder.pick_rung(rows)
            est = self._ladder.estimate_wall(rung)
            now = time.monotonic()
            hopeless = [r for r in batch if r.deadline - now < est]
            if not hopeless:
                break
            for req in hopeless:
                batch.remove(req)
                self._shed_queued(
                    req, "deadline",
                    "%.1fms left < estimated rung-%d wall %.1fms"
                    % ((req.deadline - now) * 1e3, rung, est * 1e3))
        if not batch:
            return
        # batch fan-in: ONE dispatch span id is recorded into EVERY
        # member trace (each parented under that trace's root) with
        # span links naming all member roots, so trace_top can walk
        # from any member to its batchmates
        traced = [r for r in batch if r.trace is not None]
        links = [{"trace_id": r.trace.trace_id,
                  "span_id": r.trace.span_id} for r in traced]
        disp_sid = tracing.new_span_id() if traced else None
        t_pad = time.monotonic()
        feed = {n: pad_batch(np.concatenate([r.feed[n] for r in batch]),
                             rung)
                for n in self._ladder.input_names}
        t_disp = time.monotonic()
        # attach the first member's context (scheduler thread has none
        # of its own) so the ladder's tracing.annotate() calls and any
        # fault delay land on THIS dispatch
        dctx = prev_ctx = None
        if traced:
            home = traced[0].trace
            dctx = tracing.TraceContext(home.trace_id, disp_sid,
                                        home.span_id)
            prev_ctx = tracing.attach(dctx)
        try:
            resilience.fault_point("serve.dispatch")
            outs = self._ladder.dispatch(rung, feed)
        except BaseException as e:  # fail fast; the queue keeps draining
            t_err = time.monotonic()
            notes = tracing.take_annotations()
            if dctx is not None:
                tracing.detach(prev_ctx)
            epoch_off = time.time() - time.monotonic()
            for req in batch:
                if req.trace is not None:
                    attrs = dict(notes, rung=rung, rows=rows,
                                 requests=len(batch),
                                 error=str(e)[:200])
                    tracing.record_span(
                        req.trace, "serve.dispatch",
                        t_disp + epoch_off, t_err - t_disp,
                        attrs=attrs, links=links, status="error",
                        span_id=disp_sid)
                req.error = e if isinstance(e, Exception) else \
                    MXNetError("dispatch aborted: %r" % (e,))
                req.done.set()
            self._m_requests.labels(outcome="error").inc(len(batch))
            flight.record("rung_dispatch", rung=rung, rows=rows,
                          requests=len(batch), error=str(e)[:200])
            if not isinstance(e, Exception):
                raise
            return
        t_done = time.monotonic()
        notes = tracing.take_annotations()
        if dctx is not None:
            tracing.detach(prev_ctx)
        wall = t_done - t_disp
        self._ladder.observe_wall(rung, wall)
        with self._cv:
            self._dispatches[rung] = self._dispatches.get(rung, 0) + 1
        self._m_rung.labels(rung=str(rung)).inc()
        self._m_occupancy.labels(rung=str(rung)).observe(
            rows / float(rung))
        flight.record("rung_dispatch", rung=rung, rows=rows,
                      requests=len(batch),
                      wall_ms=round(wall * 1e3, 3),
                      **({"trace_id": traced[0].trace.trace_id}
                         if traced else {}))
        epoch_off = time.time() - time.monotonic()
        disp_attrs = dict(notes, rung=rung, rows=rows,
                          requests=len(batch), pad_rows=rung - rows)
        lat = self._m_latency
        off = 0
        for req in batch:
            req.outputs = [slice_rows(o, off, req.rows, rung) for o in outs]
            off += req.rows
            # spans are recorded BEFORE done.set(): once the submitter
            # wakes, its root trace may exit and stop accepting spans
            if req.trace is not None:
                ctx = req.trace
                tracing.record_span(
                    ctx, "serve.queue", req.enqueue_t + epoch_off,
                    req.dequeue_t - req.enqueue_t,
                    attrs={"rid": req.rid})
                tracing.record_span(
                    ctx, "serve.coalesce", req.dequeue_t + epoch_off,
                    t_pad - req.dequeue_t,
                    attrs={"requests": len(batch)})
                tracing.record_span(
                    ctx, "serve.pad", t_pad + epoch_off, t_disp - t_pad,
                    attrs={"rows": rows, "pad_rows": rung - rows})
                tracing.record_span(
                    ctx, "serve.dispatch", t_disp + epoch_off, wall,
                    attrs=disp_attrs, links=links, span_id=disp_sid)
                t_slice = time.monotonic()
                tracing.record_span(
                    ctx, "serve.slice", t_done + epoch_off,
                    t_slice - t_done, attrs={"rows": req.rows})
            req.done.set()
            lat.labels(segment="queue").observe(
                req.dequeue_t - req.enqueue_t)
            lat.labels(segment="pad").observe(t_disp - t_pad)
            lat.labels(segment="dispatch").observe(wall)
            lat.labels(segment="total").observe(
                t_done - req.enqueue_t,
                exemplar=None if req.trace is None
                else req.trace.trace_id)
        self._m_requests.labels(outcome="ok").inc(len(batch))
