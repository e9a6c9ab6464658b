"""Span tracer: wall-time scopes feeding metrics AND the Chrome trace.

The counterpart of ``mxnet_tpu/telemetry/spans.py``, the same code.
``telemetry.span("fwd")`` is a context manager and a decorator.  Every
span records its host wall time into the ``mxtpu_span_seconds``
histogram (labeled by span name) and into the per-step accumulator the
JSONL step-log drains; when the profiler is running
(``profiler_set_state('run')``) the same interval is appended to the
Chrome trace via :func:`mxnet_tpu_torch.profiler.record_event`, on the
profiler's clock, so spans and operator events land in ONE trace file.

A span reads the host clock only: it never waits for the card, so the
eager step it times stays asynchronous (its wall is dispatch, not device
time).  Spans nest freely; the trace event carries the thread id so the
prefetcher's and the consumer's spans render on separate rows.
"""
from __future__ import annotations

import functools
import threading
import time

from .. import profiler
from . import tracing
from .registry import histogram

__all__ = ["span", "drain_step_spans", "step_span_totals"]

_SPAN_HIST = None          # created lazily (after catalog import settles)
_step_lock = threading.Lock()
_step_spans = {}           # name -> [total_seconds, count] since last step


def _hist():
    global _SPAN_HIST
    if _SPAN_HIST is None:
        _SPAN_HIST = histogram("mxtpu_span_seconds")
    return _SPAN_HIST


class span:
    """Time a scope::

        with telemetry.span("fwd"):
            ...

    or decorate a function::

        @telemetry.span("data.fetch")
        def next_batch(): ...

    One instance may be shared (the decorator form re-enters it from
    many threads): enter state lives on a per-instance thread-local
    stack, not on the instance itself.
    """

    def __init__(self, name, category="span"):
        self.name = name
        self.category = category
        self._tls = threading.local()

    def __enter__(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        # active trace? this span becomes a child span of it; the cost
        # without a trace is ONE thread-local read (tracing.current)
        ctx = tracing.current()
        tr = None
        if ctx is not None:
            tracing.attach(ctx.child())
            tr = (ctx, time.time())
        stack.append((time.perf_counter(), profiler.now_us(), tr))
        return self

    def __exit__(self, *exc):
        t0, start_us, tr = self._tls.stack.pop()
        dur = time.perf_counter() - t0
        if tr is not None:
            parent, ts0 = tr
            child = tracing.current()
            tracing.detach(parent)
            if child is not None:
                tracing.record_span(
                    parent, self.name, ts0, dur,
                    span_id=child.span_id,
                    status="error" if exc and exc[0] is not None
                    else None)
        _hist().labels(span=self.name).observe(dur)
        with _step_lock:
            acc = _step_spans.get(self.name)
            if acc is None:
                _step_spans[self.name] = [dur, 1]
            else:
                acc[0] += dur
                acc[1] += 1
        if profiler.is_running():
            profiler.record_event(
                self.name, start_us, dur * 1e6, category=self.category,
                tid=threading.get_ident() % (1 << 31))
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapper


def drain_step_spans():
    """Spans accumulated since the last drain, as
    ``{name: {"total_s": s, "count": n}}`` — consumed by the JSONL
    step-log so each record carries that step's phase timings."""
    with _step_lock:
        out = {name: {"total_s": v[0], "count": v[1]}
               for name, v in _step_spans.items()}
        _step_spans.clear()
    return out


def step_span_totals():
    """Non-draining view of the current per-step accumulator."""
    with _step_lock:
        return {name: {"total_s": v[0], "count": v[1]}
                for name, v in _step_spans.items()}
