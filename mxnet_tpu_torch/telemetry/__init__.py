"""Telemetry: unified metrics, tracing spans, and run reports.

The counterpart of ``mxnet_tpu/telemetry``: the same metric names
(:data:`CATALOG`), JSONL step records, Chrome trace format, ioview
verdicts and flight-recorder dumps, so the JAX package's reader tools
(``tools/run_top.py``, ``tools/flight_read.py``, ``tools/io_top.py``,
``tools/trace_top.py``) read the port's files unchanged.

* **metrics registry** (:mod:`.registry`) — thread-safe counters, gauges
  and fixed-bucket histograms, every name declared in :data:`CATALOG`;
* **span tracer** (:mod:`.spans`) — ``telemetry.span("fwd")`` on the
  executor, Module, trainer and IO stack, mirrored into the Chrome trace
  when the profiler runs (:mod:`mxnet_tpu_torch.profiler`);
* **distributed tracing** (:mod:`.tracing`) — one trace per training
  step, tail-sampled, exported as ``mxtpu-trace/1`` JSONL
  (``MXNET_TPU_TRACE_DIR``);
* **exporters** (:mod:`.exporters`) — the JSONL step log
  (``MXNET_TPU_TELEMETRY_JSONL``), Prometheus text (:func:`render_prom`,
  ``MXNET_TPU_TELEMETRY_PORT``) and the end-of-run :func:`report`;
* **compile events** (:mod:`.compile`) — the port's kernel builds;
* **flight recorder** (:mod:`.flight`) — a ring of recent events dumped
  to ``MXNET_TPU_FLIGHT_DIR`` on error, OOM, SIGTERM or crash;
* **device memory** (:mod:`.memory`) — the caching allocator's live
  statistics at step boundaries, ``MXNET_TPU_MEMORY_BUDGET`` and OOM
  forensics;
* **step segments** (:mod:`.distview`, single rank) — ``compute`` /
  ``input_wait`` / ``collective_wait``;
* **input-pipeline view** (:mod:`.ioview`) — per-stage accounting, queue
  occupancy and the bottleneck verdict;
* **training-health numerics** (:mod:`.numerics`) — sampled parameter
  and gradient statistics (``MXNET_TPU_NUMERICS_EVERY``, off by default);
* **SLO engine** (:mod:`.slo`) — declarative rules, burn-rate alerts and
  the ``mxtpu-health/1`` verdict, ticked by ``step_end`` and by the
  serving front door's background thread.

Nothing here adds a sync with the card on the default path: spans read
the host clock, memory sampling reads the allocator's host-side counters,
and numerics fetch their statistics only on sampled steps.

Not yet ported, and named so that a caller learns it at once:
:data:`costdb` (the cost database, ROADMAP Queue A item 9) raises on any
use; so does the cross-rank half of :mod:`.distview` (item 6).
"""
from __future__ import annotations

import os as _os

from ..base import MXNetError as _MXNetError
from .catalog import CATALOG, NOT_EMITTED, selfcheck
from .registry import (REGISTRY, Registry, Counter, Gauge, Histogram,
                       counter, gauge, histogram)
from . import tracing
from .spans import span, drain_step_spans, step_span_totals
from . import flight
from . import memory
from . import distview
from . import ioview
from . import numerics
from . import slo
from .exporters import (step_end, jsonl_event, render_prom, report,
                        start_http_server, jsonl_path, env_port, reset,
                        reset_steps)
from . import compile as compile_events
from .exporters import _init_env_state


class _NotPorted:
    """A JAX telemetry submodule the port names but has not ported: any
    attribute raises."""

    def __init__(self, name, item):
        self._name = name
        self._item = item

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise _MXNetError(
            "telemetry.%s.%s: telemetry.%s is not yet ported to "
            "mxnet_tpu_torch (ROADMAP Queue A item %s)"
            % (self._name, attr, self._name, self._item))

    def __repr__(self):
        return "<telemetry.%s: not yet ported>" % self._name


#: the cost database (``mxnet_tpu.telemetry.costdb``): not yet ported
costdb = _NotPorted("costdb", 9)

__all__ = [
    "CATALOG", "NOT_EMITTED", "selfcheck",
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "span", "drain_step_spans", "step_span_totals",
    "step_end", "jsonl_event", "render_prom", "report",
    "start_http_server", "jsonl_path", "env_port", "reset",
    "reset_steps", "compile_events",
    "flight", "memory", "distview", "ioview", "numerics", "tracing",
    "costdb", "slo",
]

compile_events.install()
_init_env_state()
# black-box mode: an uncaught crash leaves a flight dump
if flight.dump_dir():
    flight.install_excepthook()
_port = env_port()
if _port > 0:
    try:
        start_http_server(_port)
    except (OSError, OverflowError, ValueError):
        # an unusable port must not break `import mxnet_tpu_torch`
        import logging as _logging
        _logging.getLogger(__name__).warning(
            "MXNET_TPU_TELEMETRY_PORT=%s: cannot bind the metrics "
            "endpoint; telemetry continues without it",
            _os.environ["MXNET_TPU_TELEMETRY_PORT"])
