"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

The counterpart of ``mxnet_tpu/telemetry/registry.py``, the same code:

* every metric must be declared in :data:`~mxnet_tpu_torch.telemetry.
  catalog.CATALOG` — creation of an undeclared name raises immediately;
* one registry lock guards all samples (emit cost: a dict lookup and a
  float add); it is reentrant, so a signal handler that records while the
  main thread holds it does not deadlock, and no CUDA call is ever made
  under it (values arrive as host floats);
* ``labels(**kv)`` returns a bound child with a pre-resolved sample key
  for hot paths;
* histograms use fixed upper bounds declared at creation, so rendering
  never rebalances and concurrent observes never allocate.
"""
from __future__ import annotations

import threading
import time

from ..base import MXNetError
from .catalog import CATALOG, COUNTER, GAUGE, HISTOGRAM, TIME_BUCKETS

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "REGISTRY",
           "counter", "gauge", "histogram"]


class _Child:
    """A metric bound to one resolved label set — the hot-path handle."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, value=1):
        self._metric._add(self._key, value)

    def dec(self, value=1):
        self._metric._add(self._key, -value)

    def set(self, value):
        self._metric._set(self._key, value)

    def observe(self, value, weight=1, exemplar=None):
        self._metric._observe(self._key, value, weight, exemplar)

    def get(self):
        return self._metric._get(self._key)


class Metric:
    """Base labeled instrument.  Label-less metrics proxy the empty-key
    child so ``counter(name).inc()`` works directly."""

    kind = None

    def __init__(self, name, labelnames=(), help="", registry=None):
        self.name = name
        self.labelnames = tuple(labelnames)
        self.help = help
        self._registry = registry
        self._samples = {}
        self._default = _Child(self, ()) if not self.labelnames else None

    # ------------------------------------------------------------ labels
    def labels(self, **kv):
        """Bound child for one label set (hot paths cache the result)."""
        if set(kv) != set(self.labelnames):
            raise MXNetError(
                "metric %r takes labels %s, got %s"
                % (self.name, sorted(self.labelnames), sorted(kv)))
        key = tuple((k, str(kv[k])) for k in self.labelnames)
        return _Child(self, key)

    def _require_default(self):
        if self._default is None:
            raise MXNetError(
                "metric %r has labels %s; call .labels(...) first"
                % (self.name, sorted(self.labelnames)))
        return self._default

    # --------------------------------------------- label-less delegation
    def inc(self, value=1):
        self._require_default().inc(value)

    def dec(self, value=1):
        self._require_default().dec(value)

    def set(self, value):
        self._require_default().set(value)

    def observe(self, value, weight=1, exemplar=None):
        self._require_default().observe(value, weight, exemplar)

    def get(self):
        return self._require_default().get()

    # -------------------------------------------------------- internals
    def _lock(self):
        return self._registry._lock

    def _add(self, key, value):
        raise MXNetError("metric %r (%s) does not support add"
                         % (self.name, self.kind))

    def _set(self, key, value):
        raise MXNetError("metric %r (%s) does not support set"
                         % (self.name, self.kind))

    def _observe(self, key, value, weight=1, exemplar=None):
        raise MXNetError("metric %r (%s) does not support observe"
                         % (self.name, self.kind))

    def _get(self, key):
        with self._lock():
            return self._samples.get(key, 0.0)

    def samples(self):
        """{label key tuple: value} snapshot (histograms: dict values;
        nested exemplar maps are copied too, so readers never race a
        concurrent observe)."""
        with self._lock():
            out = {}
            for k, v in self._samples.items():
                if isinstance(v, dict):
                    v = dict(v)
                    ex = v.get("exemplars")
                    if ex is not None:
                        v["exemplars"] = dict(ex)
                out[k] = v
            return out

    def _clear(self):
        with self._lock():
            self._samples.clear()


class Counter(Metric):
    """Monotonic count; negative increments are rejected."""

    kind = COUNTER

    def _add(self, key, value):
        if value < 0:
            raise MXNetError("counter %r cannot decrease (got %r)"
                             % (self.name, value))
        with self._lock():
            self._samples[key] = self._samples.get(key, 0.0) + value


class Gauge(Metric):
    """Point-in-time value; settable and bidirectional."""

    kind = GAUGE

    def _add(self, key, value):
        with self._lock():
            self._samples[key] = self._samples.get(key, 0.0) + value

    def _set(self, key, value):
        with self._lock():
            self._samples[key] = float(value)


class Histogram(Metric):
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    Buckets are upper bounds; an implicit +Inf bucket catches the tail.
    Bucket counts are stored non-cumulative and rendered cumulative by
    the Prometheus exporter.  ``observe(value, weight=w)`` credits the
    bucket/sum/count by ``w`` instead of 1 — the time-weighted form the
    queue-occupancy sampler uses (bucket counts become seconds-at-depth,
    so sum/count is the time-weighted mean).
    """

    kind = HISTOGRAM

    def __init__(self, name, labelnames=(), help="", registry=None,
                 buckets=TIME_BUCKETS):
        super().__init__(name, labelnames, help, registry)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise MXNetError("histogram %r: buckets must be strictly "
                             "increasing, got %s" % (name, list(b)))
        self.buckets = b

    def _observe(self, key, value, weight=1, exemplar=None):
        value = float(value)
        weight = float(weight)
        if weight < 0:
            raise MXNetError("histogram %r: negative observe weight %r"
                             % (self.name, weight))
        with self._lock():
            s = self._samples.get(key)
            if s is None:
                s = {"buckets": [0] * (len(self.buckets) + 1),
                     "sum": 0.0, "count": 0}
                self._samples[key] = s
            i = 0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    break
            else:
                i = len(self.buckets)
            s["buckets"][i] += weight
            s["sum"] += value * weight
            s["count"] += weight
            if exemplar is not None:
                # each bucket remembers ONE recent observation's trace
                # id — the histogram-exemplar hook (telemetry.tracing)
                ex = s.get("exemplars")
                if ex is None:
                    ex = s["exemplars"] = {}
                ex[i] = (str(exemplar), value, round(time.time(), 3))

    def _get(self, key):
        with self._lock():
            s = self._samples.get(key)
            return dict(s) if s else {"buckets": [], "sum": 0.0,
                                      "count": 0}


_KINDS = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class Registry:
    """Holds metrics; creation is get-or-create and catalog-checked.

    ``catalog=None`` lifts the declaration requirement — for tests and
    embedders that want a private scratch registry.
    """

    def __init__(self, catalog=CATALOG):
        self._lock = threading.RLock()
        self._metrics = {}
        self._catalog = catalog

    def _get_or_create(self, kind, name, labelnames, help, buckets=None):
        if self._catalog is not None:
            decl = self._catalog.get(name)
            if decl is None:
                raise MXNetError(
                    "metric %r is not declared in telemetry.CATALOG — "
                    "add it there (and to docs/api/telemetry.md; "
                    "tools/ci_check.py guards the two against drift)"
                    % name)
            dkind, dlabels, dhelp = decl
            if dkind != kind:
                raise MXNetError("metric %r is declared as a %s, "
                                 "requested as a %s" % (name, dkind, kind))
            labelnames = labelnames or dlabels
            if tuple(labelnames) != tuple(dlabels):
                raise MXNetError(
                    "metric %r is declared with labels %s, requested "
                    "with %s" % (name, list(dlabels), list(labelnames)))
            help = help or dhelp
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or tuple(m.labelnames) != \
                        tuple(labelnames):
                    raise MXNetError(
                        "metric %r already registered as %s%s"
                        % (name, m.kind, list(m.labelnames)))
                return m
            cls = _KINDS[kind]
            if kind == HISTOGRAM:
                m = cls(name, labelnames, help, registry=self,
                        buckets=buckets or TIME_BUCKETS)
            else:
                m = cls(name, labelnames, help, registry=self)
            self._metrics[name] = m
            return m

    def counter(self, name, labelnames=(), help=""):
        return self._get_or_create(COUNTER, name, labelnames, help)

    def gauge(self, name, labelnames=(), help=""):
        return self._get_or_create(GAUGE, name, labelnames, help)

    def histogram(self, name, labelnames=(), help="", buckets=None):
        return self._get_or_create(HISTOGRAM, name, labelnames, help,
                                   buckets=buckets)

    def metrics(self):
        with self._lock:
            return dict(self._metrics)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def reset(self):
        """Clear every sample but keep the metric objects, so children
        cached at module import stay valid."""
        for m in self.metrics().values():
            m._clear()

    # ------------------------------------------------------- snapshots
    def flat(self, kinds=None):
        """{'name' or 'name{l="v"}': value} for scalar metrics; the
        JSONL / report snapshot format.  Histograms are flattened to
        ``name_sum`` / ``name_count`` entries."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            if kinds is not None and m.kind not in kinds:
                continue
            for key, val in sorted(m.samples().items()):
                suffix = "" if not key else \
                    "{%s}" % ",".join('%s="%s"' % kv for kv in key)
                if m.kind == HISTOGRAM:
                    out[name + "_sum" + suffix] = val["sum"]
                    out[name + "_count" + suffix] = val["count"]
                else:
                    out[name + suffix] = val
        return out


#: the process-wide default registry (module-level helpers below)
REGISTRY = Registry()


def counter(name, labelnames=(), help=""):
    """Get-or-create a catalog-declared counter on the default registry."""
    return REGISTRY.counter(name, labelnames, help)


def gauge(name, labelnames=(), help=""):
    """Get-or-create a catalog-declared gauge on the default registry."""
    return REGISTRY.gauge(name, labelnames, help)


def histogram(name, labelnames=(), help="", buckets=None):
    """Get-or-create a catalog-declared histogram on the default
    registry."""
    return REGISTRY.histogram(name, labelnames, help, buckets=buckets)
