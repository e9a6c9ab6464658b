"""Exporters: JSONL step-log, Prometheus text format, end-of-run report.

The counterpart of ``mxnet_tpu/telemetry/exporters.py``, with the same
record and text formats, so the JAX package's reader tools
(``tools/run_top.py``, ``tools/io_top.py``) read the port's files:

* :func:`step_end` — the per-step emitter every training loop calls
  (``Module.fit``, ``ShardedTrainer.step``/``run_steps``, the bench).  It
  advances the step counters/histograms and, when
  ``MXNET_TPU_TELEMETRY_JSONL`` names a file, appends ONE json line per
  step carrying the step time, that step's span timings, a full
  counter/gauge snapshot (the memory gauges sampled at that step's end)
  and the ioview block.  It reads host clocks and host-side counters
  only, so it adds no sync with the card;
* :func:`render_prom` — Prometheus text exposition of every metric,
  served by :func:`start_http_server` (``MXNET_TPU_TELEMETRY_PORT``);
* :func:`report` — the end-of-run dict (step-time percentiles,
  throughput, compile count/time, per-phase breakdown, memory) that
  ``tools.bench`` embeds in its JSON line.

``step_end`` drives the SLO engine's step cadence (``slo.on_step``), as
in the JAX package; the JAX cost-database hook is not ported
(``telemetry.costdb`` raises).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from .catalog import COUNTER, GAUGE, HISTOGRAM
from .registry import REGISTRY, counter, gauge, histogram
from . import compile as compile_mod
from . import distview as distview_mod
from . import flight
from . import ioview as ioview_mod
from . import memory as memory_mod
from . import slo as slo_mod
from . import tracing as tracing_mod
from .spans import drain_step_spans

__all__ = ["step_end", "jsonl_event", "render_prom", "report",
           "start_http_server", "jsonl_path", "env_port", "reset",
           "reset_steps"]

# retained step durations for percentiles (bounded: ~12h at 10 steps/s)
_MAX_DURS = 500_000
_lock = threading.Lock()
_step_durs = deque(maxlen=_MAX_DURS)
_jsonl = {"path": None, "fh": None}
# compile count/time attributed by the first-call heuristic in windows
# discarded by reset_steps() (kept for parity: the port's builds report
# themselves, so the heuristic never runs)
_heur_carry = {"count": 0, "time": 0.0}
# counter snapshot at the previous step boundary (flight-event deltas)
_last_counters = {}


def jsonl_path():
    """Current step-log destination (``MXNET_TPU_TELEMETRY_JSONL``), or
    None when the step-log is off."""
    return os.environ.get("MXNET_TPU_TELEMETRY_JSONL") or None


# rank of this process (MXNET_TPU_PROCESS_ID; 0 outside a job) — ONE
# parser for the JSONL records, the /debug endpoint, and flight dumps
_proc_rank = distview_mod.rank


def env_port():
    """The metrics port this process should bind
    (``MXNET_TPU_TELEMETRY_PORT``; 0 = endpoint off).  Co-located
    ranks must not race to bind one fixed port, so the LOCAL launcher
    assigns each worker ``port+rank`` in its environment (and records
    the choice in its supervisor JSONL ``worker_start`` event); the
    ssh launcher — one rank per host, no collision — passes the
    configured port through unchanged."""
    try:
        port = int(os.environ.get("MXNET_TPU_TELEMETRY_PORT", "0"))
    except ValueError:
        return 0
    return max(0, port)


def _jsonl_handle():
    """Open/rotate/close the step-log handle to match the env var (a
    test or a launcher may change it mid-process).  An unwritable path
    disables the step-log with one warning — the observability layer
    must never kill the training loop it observes."""
    path = jsonl_path()
    if path != _jsonl["path"]:
        if _jsonl["fh"] is not None:
            try:
                _jsonl["fh"].close()
            except OSError:
                pass
        fh = None
        if path:
            try:
                fh = open(path, "a")
            except OSError as e:
                import logging
                logging.getLogger(__name__).warning(
                    "MXNET_TPU_TELEMETRY_JSONL=%r cannot be opened "
                    "(%s); step-log disabled for this run", path, e)
        # record the path even on failure so the open is not retried
        # (and the warning not repeated) on every subsequent step
        _jsonl["fh"] = fh
        _jsonl["path"] = path
    return _jsonl["fh"]


def step_end(samples=None, step_time=None, extra=None, count=1):
    """Mark ``count`` training steps complete (1 for ordinary loops;
    ``ShardedTrainer.run_steps`` passes its scan length, since the
    chain IS count full optimizer updates observed once from the host).

    ``samples``: samples PER STEP (feeds throughput); ``step_time``:
    host wall seconds per step (feeds the ``mxtpu_step_seconds``
    histogram and the percentile window); ``extra``: dict merged into
    the JSONL record (trainers attach e.g. the loss).  Emits ONE JSONL
    record per call — a ``count`` > 1 record carries the whole chain's
    span timings and says so via its ``count`` field.  Cheap when the
    JSONL is off: three counter updates."""
    count = max(1, int(count))
    counter("mxtpu_step_total").inc(count)
    if samples:
        counter("mxtpu_samples_total").inc(samples * count)
    if step_time is not None:
        h = histogram("mxtpu_step_seconds")
        for _ in range(count):
            h.observe(step_time)
        with _lock:
            _step_durs.extend([float(step_time)] * count)
    spans = drain_step_spans()
    # live device-memory sample at the step boundary (the allocator's
    # host-side counters; inert without a CUDA device): the gauges land
    # in the JSONL snapshot below and in any later flight dump
    memory_mod.sample_live_memory()
    step_no = int(counter("mxtpu_step_total").get())
    counters = REGISTRY.flat(kinds=(COUNTER,))
    with _lock:
        deltas = {k: v - _last_counters.get(k, 0)
                  for k, v in counters.items()
                  if v != _last_counters.get(k, 0)}
        _last_counters.clear()
        _last_counters.update(counters)
    # the input-pipeline view's per-step block (telemetry.ioview):
    # per-stage deltas + stall/starved + occupancy + iterator position,
    # on the MXNET_TPU_IOVIEW_EVERY cadence.  Runs even when the JSONL
    # is off — the call also ticks the window bottleneck classifier
    io_rec = ioview_mod.step_record()
    ev = {"step": step_no, "step_time_s": step_time, "samples": samples,
          "spans": spans, "counter_deltas": deltas}
    if count > 1:
        ev["count"] = count
    if extra and extra.get("segments"):
        # straggler-attribution split (distview): worth a ring slot so
        # a postmortem black box carries the last steps' segment shape
        ev["segments"] = extra["segments"]
    flight.record("step_end", **ev)
    # the SLO judge rides the step cadence: one clock read per step, a
    # full rule evaluation at most every MXNET_TPU_SLO_TICK_S
    slo_mod.on_step()
    with _lock:
        fh = _jsonl_handle()
        if fh is None:
            return
        rec = {
            "ts": round(time.time(), 6),
            "step": step_no,
            "rank": _proc_rank(),
            "step_time_s": step_time,
            "samples": samples,
            "spans": spans,
            "counters": counters,
            "gauges": REGISTRY.flat(kinds=(GAUGE,)),
        }
        if count > 1:
            rec["count"] = count
        if io_rec is not None:
            rec["io"] = io_rec
        if extra:
            rec.update(extra)
        fh.write(json.dumps(rec) + "\n")
        fh.flush()


def jsonl_event(event, **fields):
    """Append one NON-step event record to this rank's JSONL step-log
    (no-op returning False when the step-log is off).

    The record is ``{"ts", "rank", "event": <name>, ...fields}`` — no
    ``step`` key, so per-step consumers skip it, while the JAX package's
    run aggregator (``telemetry.distview.RunAggregator``) passes it
    through into the ``mxtpu-run/1`` timeline as an ``event`` record
    (``io_resume`` writes ``data_resume`` and ``backpressure_adjust``);
    fields must be JSON-serializable."""
    with _lock:
        fh = _jsonl_handle()
        if fh is None:
            return False
        rec = {"ts": round(time.time(), 6), "rank": _proc_rank(),
               "event": str(event)}
        rec.update(fields)
        try:
            fh.write(json.dumps(rec, default=repr) + "\n")
            fh.flush()
        except (OSError, ValueError):
            return False
        return True


# ------------------------------------------------------------- prometheus

def _escape(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(key, extra=None):
    parts = ['%s="%s"' % (k, _escape(v)) for k, v in key]
    if extra:
        parts.extend('%s="%s"' % (k, _escape(v))
                     for k, v in extra.items())
    return "{%s}" % ",".join(parts) if parts else ""


def _fmt_num(x):
    if x == float("inf"):
        return "+Inf"
    f = float(x)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prom():
    """The registry in Prometheus text exposition format (v0.0.4):
    ``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket`` series with
    ``le`` labels for histograms."""
    lines = []
    for name, m in sorted(REGISTRY.metrics().items()):
        samples = m.samples()
        if not samples:
            continue
        lines.append("# HELP %s %s" % (name, _escape(m.help)))
        lines.append("# TYPE %s %s" % (name, m.kind))
        for key, val in sorted(samples.items()):
            if m.kind == HISTOGRAM:
                cum = 0
                bounds = list(m.buckets) + [float("inf")]
                exemplars = val.get("exemplars") or {}
                for i, (ub, n) in enumerate(zip(bounds,
                                                val["buckets"])):
                    cum += n
                    line = "%s_bucket%s %s" % (
                        name, _fmt_labels(key, {"le": _fmt_num(ub)}),
                        cum)
                    ex = exemplars.get(i)
                    if ex is not None:
                        # OpenMetrics exemplar suffix: the bucket names
                        # a REAL trace a reader can pull up with
                        # tools/trace_top.py --trace <id>
                        line += ' # {trace_id="%s"} %s %s' \
                            % (ex[0], _fmt_num(ex[1]), ex[2])
                    lines.append(line)
                lines.append("%s_sum%s %s"
                             % (name, _fmt_labels(key),
                                _fmt_num(val["sum"])))
                lines.append("%s_count%s %s"
                             % (name, _fmt_labels(key), val["count"]))
            else:
                lines.append("%s%s %s" % (name, _fmt_labels(key),
                                          _fmt_num(val)))
    return "\n".join(lines) + "\n"


_server = {"httpd": None, "thread": None}


def start_http_server(port=None):
    """Serve ``render_prom()`` on ``/metrics`` from a daemon thread
    (stdlib only), plus ``/debug`` (JSON rank status).  ``POST
    /debug/capture`` starts an on-demand capture
    (``distview.capture_now``) when ``MXNET_TPU_CAPTURE_DIR`` is set, else
    answers 403.
    ``port=None`` reads ``MXNET_TPU_TELEMETRY_PORT``
    (:func:`env_port`); 0 binds an
    ephemeral port.  Returns the server object (its
    ``server_address[1]`` is the bound port); idempotent per process.
    """
    if _server["httpd"] is not None:
        return _server["httpd"]
    if port is None:
        port = env_port()
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def _send(self, body, ctype, status=200):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/metrics"):
                self._send(render_prom().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
                return
            if self.path.rstrip("/") == "/debug":
                from . import distview
                status = {
                    "rank": _proc_rank(),
                    "pid": os.getpid(),
                    "step": int(counter("mxtpu_step_total").get()),
                    "capture": distview.capture_status(),
                }
                self._send(json.dumps(status, default=repr)
                           .encode("utf-8"), "application/json")
                return
            if self.path.rstrip("/") == "/debug/capture":
                # a state change (profiler overhead + disk writes):
                # POST only, and only when the operator armed capture
                self.send_error(405, "POST /debug/capture")
                return
            self.send_error(404)

        def do_POST(self):
            if self.path.rstrip("/") != "/debug/capture":
                self.send_error(404)
                return
            from . import distview
            if not distview.capture_dir():
                self._send(json.dumps(
                    {"started": False,
                     "reason": "MXNET_TPU_CAPTURE_DIR is not set"})
                    .encode("utf-8"), "application/json", status=403)
                return
            res = distview.capture_now(trigger="http")
            self._send(json.dumps(res).encode("utf-8"),
                       "application/json")

        def log_message(self, fmt, *args):
            pass   # scrapes must not spam the training log

    httpd = ThreadingHTTPServer(("0.0.0.0", int(port)), _Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="mxtpu-telemetry-http")
    t.start()
    _server["httpd"] = httpd
    _server["thread"] = t
    return httpd


# ----------------------------------------------------------------- report

def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _heuristic_compiles(durs):
    """First-call-vs-steady-state estimate: steps whose wall time dwarfs
    the median are counted as compile-inflated, the excess over the
    median as compile time.  Used only when builds do not report
    themselves (never in the port; kept for the JAX package's report)."""
    if len(durs) < 2:
        return 0, 0.0
    s = sorted(durs)
    p50 = _percentile(s, 0.50)
    thresh = max(4.0 * p50, p50 + 0.05)
    hits = [d for d in durs if d > thresh]
    return len(hits), sum(d - p50 for d in hits)


def report():
    """End-of-run summary dict: step count + step-time percentiles,
    throughput (samples/sec and records/sec over summed step time),
    compile count/time, per-phase span breakdown, and the full counter
    snapshot.  ``tools.bench`` embeds this in its JSON line."""
    with _lock:
        durs = list(_step_durs)
    sdurs = sorted(durs)
    total_time = sum(durs)
    steps = int(counter("mxtpu_step_total").get())
    samples = counter("mxtpu_samples_total").get()
    records = sum(counter("mxtpu_io_records_total").samples().values())

    if compile_mod.installed():
        compile_count = int(counter("mxtpu_compile_total").get())
        compile_time = counter("mxtpu_compile_seconds_total").get()
        compile_source = compile_mod.SOURCE
    else:
        compile_count, compile_time = _heuristic_compiles(durs)
        with _lock:
            compile_count += _heur_carry["count"]
            compile_time += _heur_carry["time"]
        compile_source = "heuristic"

    phases = {}
    for key, val in histogram("mxtpu_span_seconds").samples().items():
        name = dict(key).get("span", "?")
        phases[name] = {
            "count": val["count"],
            "total_s": round(val["sum"], 6),
            "mean_s": round(val["sum"] / max(1, val["count"]), 6),
        }

    return {
        "steps": steps,
        "step_time_s": {
            "p50": round(_percentile(sdurs, 0.50), 6),
            "p90": round(_percentile(sdurs, 0.90), 6),
            "p99": round(_percentile(sdurs, 0.99), 6),
            "mean": round(total_time / len(durs), 6) if durs else 0.0,
            "min": round(sdurs[0], 6) if sdurs else 0.0,
            "max": round(sdurs[-1], 6) if sdurs else 0.0,
        },
        "throughput": {
            "samples_per_sec": round(samples / total_time, 3)
            if total_time else 0.0,
            "records_per_sec": round(records / total_time, 3)
            if total_time else 0.0,
        },
        "compile": {
            "count": compile_count,
            "total_s": round(float(compile_time), 6),
            "source": compile_source,
        },
        "phases": phases,
        "memory": {
            "plans": memory_mod.plans_dict(),
            "live": memory_mod.sample_live_memory(),
        },
        "counters": REGISTRY.flat(kinds=(COUNTER,)),
    }


def reset_steps():
    """Clear only the per-step window — step/samples counters, the
    step-time histogram/percentiles, the span histogram and per-step
    accumulator — keeping process-lifetime counters (compile, IO,
    kvstore, resilience) intact.  ``tools.bench`` calls this after its
    warmup/compile steps so the reported percentiles and throughput
    cover exactly the timed loop, while compile accounting still spans
    the whole process (the heuristic fallback carries the discarded
    window's compile attribution forward)."""
    drain_step_spans()
    counter("mxtpu_step_total")._clear()
    counter("mxtpu_samples_total")._clear()
    histogram("mxtpu_step_seconds")._clear()
    histogram("mxtpu_span_seconds")._clear()
    with _lock:
        if not compile_mod.installed() and _step_durs:
            # without reporting builds the first-call heuristic is the
            # only compile signal, and it lives in the durations being
            # discarded — bank its estimate so report() keeps it
            c, t = _heuristic_compiles(list(_step_durs))
            _heur_carry["count"] += c
            _heur_carry["time"] += t
        _step_durs.clear()


def reset():
    """Clear every sample, the percentile window, the per-step span
    accumulator, the flight ring + memory-plan registry, the cost
    database, and the step-log handle (the env var is re-read on the next step).  Metric
    objects and cached label children stay valid."""
    REGISTRY.reset()
    drain_step_spans()
    flight.clear()
    ioview_mod.reset()
    memory_mod.clear_plans()
    from . import costdb as costdb_mod
    costdb_mod.reset()
    from . import numerics as numerics_mod
    numerics_mod.reset()
    slo_mod.reset()
    tracing_mod.reset()
    with _lock:
        _step_durs.clear()
        _last_counters.clear()
        _heur_carry["count"] = 0
        _heur_carry["time"] = 0.0
        if _jsonl["fh"] is not None:
            try:
                _jsonl["fh"].close()
            except OSError:
                pass
        _jsonl["fh"] = None
        _jsonl["path"] = None
    _init_env_state()


def _init_env_state():
    """Seed env-derived gauges: the restart attempt this process runs
    under (``MXNET_TPU_RESTART_COUNT``, set by a supervisor)."""
    try:
        restarts = int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        restarts = 0
    gauge("mxtpu_watchdog_restarts").set(restarts)
