"""Cross-rank run observability: straggler attribution, the run timeline
and on-demand live capture.

The counterpart of ``mxnet_tpu/telemetry/distview.py``, in three pieces:

* straggler attribution (worker half): each training step's host wall is
  split into ``compute`` / ``input_wait`` / ``collective_wait``
  (:func:`record_step_segments` -> ``mxtpu_step_segment_seconds``), and a
  timestamp barrier just before a cross-process collective
  (:func:`pre_collective_barrier`: an all-gather of each rank's arrival
  time over the job's process group) measures how long this rank waits
  for its slowest peer (``mxtpu_collective_wait_seconds``) and the arrival
  spread (``mxtpu_rank_step_skew_seconds``);
* fleet aggregation (supervisor half): :class:`RunAggregator` tails every
  rank's JSONL step log (``tools/launch.py`` gives worker N its own
  ``<base>.rank<N>``) and merges them into one ``mxtpu-run/1`` timeline
  (per-step p50/max across ranks, the worst rank, skew, restart and
  fault events); :func:`read_run_timeline` and :func:`summarize_run` read
  it back;
* on-demand live capture (worker half): a SIGUSR1 handler
  (:func:`install_capture_handler`) captures a bounded ``torch.profiler``
  window (the Chrome trace) plus a flight-recorder snapshot on a running
  rank, without restarting it; ``tools/launch.py`` relays the signal to
  every worker.

Module-level imports are stdlib-only and in-package imports are deferred
into the worker-half functions, so the launcher loads this file by path
and never imports torch to aggregate text streams.
"""
from __future__ import annotations

import json
import logging
import os
import signal as _signal
import threading
import time

__all__ = [
    "RUN_SCHEMA", "SEGMENTS", "rank", "world", "skew_every",
    "record_step_segments", "pre_collective_barrier",
    "capture_dir", "capture_seconds", "capture_now", "capture_status",
    "install_capture_handler", "rank_jsonl_path", "split_jsonl",
    "RunAggregator", "read_run_timeline", "summarize_run",
]

#: run-timeline schema tag (first line of the ``<base>.run`` JSONL)
RUN_SCHEMA = "mxtpu-run/1"

#: step segment names, in display order
SEGMENTS = ("compute", "input_wait", "collective_wait")


def rank():
    """This process's rank (``MXNET_TPU_PROCESS_ID``; 0 outside a job)."""
    try:
        return int(os.environ.get("MXNET_TPU_PROCESS_ID", "0") or 0)
    except ValueError:
        return 0


def world():
    """Processes in the job (``MXNET_TPU_NUM_PROCESSES``; 1 outside)."""
    try:
        return int(os.environ.get("MXNET_TPU_NUM_PROCESSES", "1") or 1)
    except ValueError:
        return 1


def skew_every():
    """``MXNET_TPU_SKEW_EVERY`` (default 8): one timestamp barrier every N
    calls of :func:`pre_collective_barrier` (0 = never)."""
    try:
        return max(0, int(os.environ.get("MXNET_TPU_SKEW_EVERY", "8")))
    except ValueError:
        return 8


def record_step_segments(total_s, input_s=0.0, collective_s=0.0,
                         count=1):
    """Split one step's host wall time into the three segments and
    record them into ``mxtpu_step_segment_seconds{segment=...}``.

    ``compute`` is the remainder (``total - input - collective``, floored
    at 0): with eager dispatch it is the host's dispatch of the step, the
    card running behind it.  ``count`` > 1 (a ``run_steps`` chain)
    observes the per-step average ``count`` times, as ``step_end`` feeds
    ``mxtpu_step_seconds``.  Returns the (un-averaged) segments dict for
    the JSONL record."""
    from .registry import histogram
    input_s = max(0.0, float(input_s))
    collective_s = max(0.0, float(collective_s))
    compute_s = max(0.0, float(total_s) - input_s - collective_s)
    seg = {"compute": compute_s, "input_wait": input_s,
           "collective_wait": collective_s}
    h = histogram("mxtpu_step_segment_seconds")
    count = max(1, int(count))
    scale = 1.0 / count
    for name, val in seg.items():
        child = h.labels(segment=name)
        for _ in range(count):
            child.observe(val * scale)
    return {k: round(v, 6) for k, v in seg.items()}


_skew_state = {"calls": 0, "warm": False}


def pre_collective_barrier(site="trainer.step"):
    """Timestamp barrier just before a cross-process collective.

    Every rank all-gathers its arrival wall-clock time over the job's
    process group; the call is itself the barrier, so this rank's measured
    wait is how long it stalled for its slowest peer.  Records
    ``mxtpu_collective_wait_seconds`` (the wait: about 0 on the straggler)
    and ``mxtpu_rank_step_skew_seconds`` (max - min arrival) and a
    ``skew`` flight event.  Returns ``{"wait_s", "skew_s",
    "slowest_rank", "rank"}``, or None when disabled
    (``MXNET_TPU_SKEW_EVERY=0``), off the cadence, or outside a job of
    several processes.  Never raises: a failed barrier leaves the skew
    unmeasured, never the step dead."""
    every = skew_every()
    if every == 0:
        return None
    try:
        from ..parallel import multihost
        if multihost.world_size() <= 1:
            return None
        _skew_state["calls"] += 1
        if (_skew_state["calls"] - 1) % every:
            return None
        import torch
        dist = multihost._dist()
        dev = multihost.collective_device()
        n = multihost.world_size()
        if not _skew_state.get("warm"):
            # the first all-gather sets up the communicator: an untimed
            # round, flipped before the attempt so a failure here cannot
            # leave this rank one gather ahead of its peers
            _skew_state["warm"] = True
            warm = [torch.zeros(1, dtype=torch.float64, device=dev)
                    for _ in range(n)]
            dist.all_gather(warm, torch.zeros(1, dtype=torch.float64,
                                               device=dev))
        t_arrive = time.time()
        p0 = time.perf_counter()
        got = [torch.zeros(1, dtype=torch.float64, device=dev)
               for _ in range(n)]
        dist.all_gather(got, torch.tensor([t_arrive], dtype=torch.float64,
                                          device=dev))
        wait_s = time.perf_counter() - p0
        ts = [float(t.item()) for t in got]
        skew_s = max(ts) - min(ts)
        slowest = ts.index(max(ts))
        my_rank = multihost.rank()
    except Exception as e:  # the skew probe is instrumentation around the step: a failed barrier leaves the skew unmeasured, never the step dead
        logging.getLogger(__name__).warning(
            "distview: pre-collective timestamp barrier failed at %s "
            "(%s); skew unmeasured for this step", site, e)
        return None
    from .registry import gauge, histogram
    from . import flight
    histogram("mxtpu_collective_wait_seconds").observe(wait_s)
    gauge("mxtpu_rank_step_skew_seconds").set(skew_s)
    flight.record("skew", site=site, wait_s=round(wait_s, 6),
                  skew_s=round(skew_s, 6), slowest_rank=slowest)
    return {"wait_s": wait_s, "skew_s": skew_s,
            "slowest_rank": slowest, "rank": my_rank}


# ------------------------------------------------- on-demand live capture

def capture_dir():
    """Destination of on-demand capture windows
    (``MXNET_TPU_CAPTURE_DIR``), or None when capture is off."""
    return os.environ.get("MXNET_TPU_CAPTURE_DIR") or None


def capture_seconds():
    """The trace window's length (``MXNET_TPU_CAPTURE_SECONDS``, default
    3)."""
    try:
        return max(0.1, float(os.environ.get("MXNET_TPU_CAPTURE_SECONDS",
                                             "3")))
    except ValueError:
        return 3.0


_capture_lock = threading.Lock()
_capture = {"active": False, "installed": False, "last": None}


def capture_status():
    """``{"active": bool, "last": dict or None}`` for the /debug
    endpoint."""
    with _capture_lock:
        return {"active": _capture["active"], "last": _capture["last"]}


def capture_now(trigger="api", seconds=None, directory=None):
    """Capture a bounded ``torch.profiler`` window (its Chrome trace, the
    card's kernels included where there is one) plus a flight snapshot on
    this running rank, without pausing it.  The window runs on a
    background thread; files land under ``<dir>/rank<N>/``
    (``MXNET_TPU_CAPTURE_DIR``, or ``.profiles/capture``).  One capture at
    a time: a concurrent trigger is reported and dropped.  Returns
    ``{"started": bool, "dir": path, ...}``."""
    directory = directory or capture_dir() or os.path.join(".profiles",
                                                           "capture")
    window = capture_seconds() if seconds is None else \
        max(0.1, float(seconds))
    out = os.path.join(directory, "rank%d" % rank())
    # non-blocking: the SIGUSR1 handler runs this on the main thread,
    # possibly inside a capture_status call that holds the lock
    if not _capture_lock.acquire(blocking=False):
        return {"started": False, "dir": out,
                "reason": "capture state busy"}
    try:
        if _capture["active"]:
            return {"started": False, "dir": out,
                    "reason": "capture already in progress"}
        _capture["active"] = True
    finally:
        _capture_lock.release()

    def _run():
        info = {"trigger": trigger, "dir": out, "seconds": window,
                "ts": round(time.time(), 6), "trace": False,
                "flight": None}
        try:
            os.makedirs(out, exist_ok=True)
            from . import flight
            from .registry import counter
            counter("mxtpu_capture_total").labels(trigger=trigger).inc()
            flight.record("capture", trigger=trigger, seconds=window,
                          dir=out)
            # the ring snapshot first: it is the black box even when the
            # profiler cannot trace
            info["flight"] = flight.dump("capture", directory=out)
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                time.sleep(window)
            path = os.path.join(out, "trace-%d.json" % os.getpid())
            prof.export_chrome_trace(path)
            info["trace"] = path
        except Exception as e:  # capture rides on a live training process: a profiler failure logs and drops the window, never the run
            info["error"] = str(e)
            logging.getLogger(__name__).warning(
                "distview: on-demand capture failed (%s); training "
                "continues", e)
        finally:
            with _capture_lock:
                _capture["active"] = False
                _capture["last"] = info

    threading.Thread(target=_run, daemon=False,
                     name="mxtpu-capture").start()
    return {"started": True, "dir": out, "seconds": window}


def install_capture_handler(signum=None):
    """Install the SIGUSR1 on-demand capture handler on this process
    (main thread only; idempotent).  The handler only starts the capture
    thread, so a step in progress is never interrupted.  Returns True
    when the handler is installed."""
    if signum is None:
        signum = _signal.SIGUSR1
    if _capture["installed"]:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False

    def handler(sig, frame):
        capture_now(trigger="signal")

    try:
        _signal.signal(signum, handler)
    except (ValueError, OSError):
        return False
    _capture["installed"] = True
    return True


# ---------------------------------------------------- fleet aggregation
# Everything below is stdlib-only: tools/launch.py loads this module by
# file path and must never import torch (the supervisor stays light).

def split_jsonl(buf):
    """Tolerantly parse a chunk of a JSONL stream that may end
    mid-append: returns ``(records, partial)`` where ``records`` are
    the parsed dict lines (malformed/non-dict lines skipped) and
    ``partial`` is the unterminated tail to carry into the next chunk.
    The shared core of every live tailer (:meth:`RunAggregator.poll`,
    ``tools/run_top.py --follow``)."""
    lines = buf.split("\n")
    partial = lines.pop()
    records = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records, partial


def rank_jsonl_path(base, r):
    """Per-rank step-log path the launcher assigns to worker ``r``
    (``<base>.rank<N>``); the supervisor keeps ``<base>`` for its own
    events and writes the merged timeline to ``<base>.run``."""
    return "%s.rank%d" % (base, int(r))


class RunAggregator:
    """Merge per-rank JSONL step-logs into one run-level timeline.

    The supervisor polls :meth:`poll` (cheap: incremental reads from
    the last byte offset per rank); whenever a step has been reported
    by every rank — or falls ``window`` steps behind the newest, which
    means some rank died or skipped it — ONE timeline record is
    appended to ``out_path``:

    ``{"kind": "step", "step": N, "n_ranks": k, "p50_s", "max_s",
    "min_s", "worst_rank", "skew_s", "grad_skew", "digest_mismatch",
    "ranks": {rank: {"t_s", "segments", "skew_s", "grad_norm",
    "digest"}}}`` (the numeric fields appear on steps the
    training-health numerics layer sampled — telemetry.numerics)

    plus ``run_begin`` (the schema header), passthrough ``event``
    records (worker start/death, watchdog restarts, flight dumps), and
    a final ``run_end``.  All records are plain JSON lines so the
    timeline can itself be tailed live (``tools/run_top.py --follow``).
    """

    def __init__(self, base_path, num_ranks, out_path=None, window=64):
        self.base = base_path
        self.n = max(1, int(num_ranks))
        self.out_path = out_path or base_path + ".run"
        self.window = max(1, int(window))
        # tail each rank stream from its CURRENT end: workers append
        # ('a' mode), so a rerun over the same base must not ingest the
        # previous job's records — whose repeated step numbers would
        # then shadow the new run's steps as duplicates
        self._offsets = {}        # rank -> (byte offset, partial line)
        for r in range(self.n):
            try:
                self._offsets[r] = (
                    os.path.getsize(rank_jsonl_path(base_path, r)), "")
            except OSError:
                pass              # not created yet: start at 0
        self._all_ranks = self.n  # every rank ever launched (elastic
                                  # shrinks self.n; streams stay tailed)
        self._pending = {}        # (attempt, step) -> {rank: record}
        self._emitted = set()     # (attempt, step) already written
        self._floor = -1          # steps <= this were pruned from
                                  # _emitted (still emitted; see feed)
        self._attempt = 0         # current watchdog attempt
        self._max_step = 0        # newest step seen in this attempt
        self._steps_written = 0
        self._seen_dumps = set()
        self._lock = threading.Lock()
        self._closed = False
        #: optional fleet-scope SLO evaluator (telemetry.slo.
        #: FleetHealth): launch.py attaches one; every emitted step is
        #: judged and alert transitions land in the timeline as
        #: ``event: alert`` records
        self.health = None
        try:
            # fresh timeline per job: a reused base must not leave the
            # old run's records above this run's run_begin header
            open(self.out_path, "w").close()
        except OSError:
            pass
        self._write({"schema": RUN_SCHEMA, "kind": "run_begin",
                     "ts": round(time.time(), 6), "num_ranks": self.n,
                     "base": os.path.basename(base_path)})

    def begin_attempt(self, attempt):
        """Start watchdog attempt N: flush the previous attempt's
        partial steps (its telemetry step counters restart from the
        resumed checkpoint, so step numbers repeat across attempts)."""
        attempt = int(attempt)
        with self._lock:
            if attempt == self._attempt:
                return
            self._emit_ready(final=True)
            self._attempt = attempt
            self._max_step = 0
            self._floor = -1

    def set_num_ranks(self, n):
        """Elastic resize (tools/launch.py --elastic): subsequent
        attempts expect ``n`` ranks per step, so a shrunk fleet's steps
        complete immediately instead of waiting out the partial-step
        window for ranks that left.  Departed ranks' streams stay
        tailed (``_all_ranks`` never shrinks) so their final buffered
        lines still land in the timeline."""
        with self._lock:
            self.n = max(1, int(n))
            self._all_ranks = max(self._all_ranks, self.n)

    # ------------------------------------------------------------ output
    def _write(self, rec):
        try:
            with open(self.out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:
            logging.getLogger(__name__).warning(
                "distview: cannot append run timeline %r: %s",
                self.out_path, e)

    def note_event(self, record):
        """Pass a supervisor event (worker_start/worker_death/
        watchdog_restart/...) through into the timeline."""
        rec = {"kind": "event", "ts": round(time.time(), 6)}
        rec.update(record)
        with self._lock:
            self._write(rec)

    # ------------------------------------------------------------- input
    def feed(self, r, rec):
        """Ingest one parsed JSONL record from rank ``r``.  Step records
        aggregate; worker EVENT records (``telemetry.jsonl_event`` —
        reshard / rank_join / rank_leave and the data-plane
        data_resume / data_remap / backpressure_adjust breadcrumbs)
        pass through into the timeline with the rank attached;
        anything else is ignored."""
        step = rec.get("step")
        if not isinstance(step, (int, float)):
            if isinstance(rec.get("event"), str):
                ev = dict(rec)
                ev.setdefault("rank", int(r))
                ev["kind"] = "event"
                with self._lock:
                    self._write(ev)
            return
        step = int(step)
        compact = {"t_s": rec.get("step_time_s"),
                   "ts": rec.get("ts")}
        if rec.get("segments"):
            compact["segments"] = rec["segments"]
        if rec.get("skew_s") is not None:
            compact["skew_s"] = rec["skew_s"]
        if rec.get("slowest_rank") is not None:
            compact["slowest_rank"] = rec["slowest_rank"]
        if rec.get("count"):
            compact["count"] = rec["count"]
        # data-plane observability (telemetry.ioview): the per-stage
        # breakdown + iterator position ride the step record so
        # run_top/io_top can name the slow STAGE on the slow RANK when
        # input_wait dominates
        if isinstance(rec.get("io"), dict):
            compact["io"] = rec["io"]
        # training-health numerics (telemetry.numerics): the sampled
        # step's global grad norm + state digest ride the step record
        # so cross-rank numeric skew is visible next to the time skew
        if isinstance(rec.get("grad_norm"), (int, float)):
            compact["grad_norm"] = rec["grad_norm"]
        if isinstance(rec.get("digest"), int):
            compact["digest"] = rec["digest"]
        with self._lock:
            key = (self._attempt, step)
            # _floor covers keys pruned from _emitted: a rank lagging
            # far behind the window must not re-open a step that was
            # already flushed partial
            if key in self._emitted or step <= self._floor:
                return
            self._pending.setdefault(key, {})[int(r)] = compact
            self._max_step = max(self._max_step, step)
            self._emit_ready()

    def _emit_ready(self, final=False):
        """Emit (under self._lock) every pending step that is complete,
        or — when ``final`` or older than the window — partial."""
        for key in sorted(self._pending):
            attempt, step = key
            ranks = self._pending[key]
            complete = len(ranks) >= self.n
            stale = (final or attempt < self._attempt
                     or step <= self._max_step - self.window)
            if not complete and not stale:
                continue
            del self._pending[key]
            self._emitted.add(key)
            # bound the dedup set (a multi-day supervisor would grow it
            # forever): keys at or below _floor move into the scalar
            # floor check in feed(), so a rank lagging past the pruned
            # region still cannot re-open those steps
            if len(self._emitted) > 8 * self.window:
                self._floor = max(self._floor,
                                  self._max_step - 4 * self.window)
                self._emitted = {k for k in self._emitted
                                 if k[0] == self._attempt
                                 and k[1] > self._floor}
            self._steps_written += 1
            times = {r: v.get("t_s") for r, v in ranks.items()
                     if isinstance(v.get("t_s"), (int, float))}
            rec = {"kind": "step", "step": step, "attempt": attempt,
                   "ts": round(max((v.get("ts") or 0)
                                   for v in ranks.values()), 6),
                   "n_ranks": len(ranks),
                   "ranks": {str(r): ranks[r] for r in sorted(ranks)}}
            if times:
                vals = sorted(times.values())
                rec["p50_s"] = round(vals[(len(vals) - 1) // 2], 6)
                rec["min_s"] = round(vals[0], 6)
                rec["max_s"] = round(vals[-1], 6)
                rec["worst_rank"] = max(times, key=times.get)
            skews = [v.get("skew_s") for v in ranks.values()
                     if isinstance(v.get("skew_s"), (int, float))]
            if skews:
                rec["skew_s"] = round(max(skews), 6)
            gnorms = [v.get("grad_norm") for v in ranks.values()
                      if isinstance(v.get("grad_norm"), (int, float))]
            if len(gnorms) >= 2:
                # cross-rank grad-norm spread: nonzero means the ranks
                # are not stepping the same numbers — the divergence
                # signal tools/numdiff.py then localizes per tensor
                rec["grad_skew"] = round(max(gnorms) - min(gnorms), 9)
            digests = {v.get("digest") for v in ranks.values()
                       if isinstance(v.get("digest"), int)}
            if len(digests) > 1:
                rec["digest_mismatch"] = True
            self._write(rec)
            if self.health is not None:
                # self._lock is already held: write alert transitions
                # directly (note_event would deadlock re-taking it)
                try:
                    for ev in self.health.observe_step(rec):
                        self._write(ev)
                except Exception:  # mxlint: allow-broad-except(a fleet-rule bug must not stop the timeline merge it annotates)
                    logging.getLogger(__name__).warning(
                        "distview: fleet SLO evaluation failed on "
                        "step %s", step, exc_info=True)

    # -------------------------------------------------------------- poll
    def poll(self):
        """Incrementally read every rank's stream (and any new flight
        dumps) and emit newly-complete steps.  Returns the number of
        records ingested this call."""
        fed = 0
        for r in range(self._all_ranks):
            path = rank_jsonl_path(self.base, r)
            off, partial = self._offsets.get(r, (0, ""))
            try:
                with open(path) as f:
                    f.seek(off)
                    chunk = f.read()
                    off = f.tell()
            except OSError:
                continue
            records, partial = split_jsonl(partial + chunk)
            self._offsets[r] = (off, partial)
            for rec in records:
                self.feed(r, rec)
                fed += 1
        self._poll_flight_dumps()
        return fed

    def _poll_flight_dumps(self):
        """Surface new black-box dumps (MXNET_TPU_FLIGHT_DIR) as
        timeline events — a rank that dies between supervisor heartbeats
        still leaves its breadcrumb in step order."""
        d = os.environ.get("MXNET_TPU_FLIGHT_DIR")
        if not d:
            return
        try:
            names = sorted(f for f in os.listdir(d)
                           if f.startswith("flight-")
                           and f.endswith(".json"))
        except OSError:
            return
        for name in names:
            if name in self._seen_dumps:
                continue
            self._seen_dumps.add(name)
            self.note_event({"event": "flight_dump",
                             "path": os.path.join(d, name)})

    def close(self):
        """Final flush: emit partially-reported steps and the
        ``run_end`` trailer.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.poll()
        with self._lock:
            self._emit_ready(final=True)
            if self.health is not None:
                try:
                    self._write({"kind": "event",
                                 "event": "fleet_health",
                                 "ts": round(time.time(), 6),
                                 **self.health.verdict()})
                except Exception:  # mxlint: allow-broad-except(the closing verdict is best-effort; run_end must still be written)
                    pass
            self._write({"kind": "run_end", "ts": round(time.time(), 6),
                         "steps": self._steps_written})


# --------------------------------------------------- timeline reading

def read_run_timeline(path):
    """Parse + validate an ``mxtpu-run/1`` timeline (JSONL).  Returns
    the record list; raises ValueError naming the problem (unreadable
    file, malformed line, wrong/missing schema header, malformed step
    records) — ``tools/flight_read.py`` and ``tools/run_top.py`` both
    route through this."""
    recs = []
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        raise ValueError("cannot read run timeline %r: %s" % (path, e))
    lines = raw.split("\n")
    # a LIVE timeline may end mid-append: a final line with no newline
    # is an in-progress record, not corruption — ignore it (--follow's
    # partial-line carry does the same); mid-file garbage still raises
    tail_partial = lines.pop() if lines and not raw.endswith("\n") \
        else None
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise ValueError("run timeline %r line %d: %s"
                             % (path, i, e))
        if not isinstance(rec, dict):
            raise ValueError("run timeline %r line %d: not a "
                             "JSON object" % (path, i))
        recs.append(rec)
    if tail_partial and tail_partial.strip():
        try:
            rec = json.loads(tail_partial)
            if isinstance(rec, dict):
                recs.append(rec)
        except ValueError:
            pass                # still being written
    if not recs:
        raise ValueError("run timeline %r is empty" % path)
    head = recs[0]
    if head.get("schema") != RUN_SCHEMA or head.get("kind") != "run_begin":
        raise ValueError(
            "run timeline %r: first record must be the %r run_begin "
            "header (got %r)" % (path, RUN_SCHEMA,
                                 {k: head.get(k)
                                  for k in ("schema", "kind")}))
    for i, rec in enumerate(recs, 1):
        kind = rec.get("kind")
        if kind not in ("run_begin", "run_end", "step", "event"):
            raise ValueError("run timeline %r record %d: unknown kind %r"
                             % (path, i, kind))
        if kind == "step":
            if not isinstance(rec.get("step"), int) or \
                    not isinstance(rec.get("ranks"), dict):
                raise ValueError(
                    "run timeline %r record %d: step records need an "
                    "int 'step' and a 'ranks' object" % (path, i))
    return recs


def summarize_run(records):
    """Postmortem roll-up of a timeline: step counts, cross-rank
    step-time stats, the straggler (most-frequent worst rank), peak
    skew, per-rank segment totals, the numerics columns (per-rank last
    grad norm/digest, peak cross-rank grad-norm skew, digest-mismatch
    step count), and the event list.  Input is
    :func:`read_run_timeline` output; the result is plain JSON-able —
    ``tools/run_top.py --summarize`` prints it."""
    steps = [r for r in records if r.get("kind") == "step"]
    events = [r for r in records if r.get("kind") == "event"]
    head = records[0]
    # fleet SLO alerts (telemetry.slo.FleetHealth transitions written
    # into the timeline) + the closing fleet_health verdict
    alerts = [e for e in events if e.get("event") == "alert"]
    firing_now = {}
    for a in alerts:
        if a.get("to") == "firing":
            firing_now[a.get("rule")] = a
        elif a.get("to") == "resolved":
            firing_now.pop(a.get("rule"), None)
    fleet_health = None
    for e in events:
        if e.get("event") == "fleet_health":
            fleet_health = {k: e.get(k)
                            for k in ("status", "firing", "rules")}
    if fleet_health is None and alerts:
        fleet_health = {
            "status": "critical" if any(
                a.get("severity") == "critical"
                for a in firing_now.values())
            else ("degraded" if firing_now else "healthy"),
            "firing": sorted(firing_now),
        }
    worst = {}
    seg_totals = {}
    rank_times = {}
    skew_max = 0.0
    skew_last = None
    grad_skew_max = None
    digest_mismatch_steps = 0
    rank_numerics = {}
    io_stages = {}      # rank -> {stage: seconds}
    io_position = {}    # rank -> last reported position
    for s in steps:
        w = s.get("worst_rank")
        if w is not None:
            worst[str(w)] = worst.get(str(w), 0) + 1
        if isinstance(s.get("skew_s"), (int, float)):
            skew_max = max(skew_max, s["skew_s"])
            skew_last = s["skew_s"]
        if isinstance(s.get("grad_skew"), (int, float)):
            grad_skew_max = max(grad_skew_max or 0.0, s["grad_skew"])
        if s.get("digest_mismatch"):
            digest_mismatch_steps += 1
        for r, v in (s.get("ranks") or {}).items():
            if isinstance(v.get("grad_norm"), (int, float)):
                rn = rank_numerics.setdefault(r, {})
                rn["grad_norm_last"] = v["grad_norm"]
                rn["grad_norm_steps"] = rn.get("grad_norm_steps", 0) + 1
            if isinstance(v.get("digest"), int):
                rank_numerics.setdefault(r, {})["digest_last"] = \
                    v["digest"]
            if isinstance(v.get("t_s"), (int, float)):
                # a run_steps chain reports the per-step AVERAGE with a
                # count; carry the count so totals match the segment
                # totals (which are whole-chain wall time)
                n = v.get("count") if isinstance(v.get("count"), int) \
                    else 1
                rank_times.setdefault(r, []).append((v["t_s"], max(1, n)))
            for name, val in (v.get("segments") or {}).items():
                if isinstance(val, (int, float)):
                    st = seg_totals.setdefault(r, {})
                    st[name] = st.get(name, 0.0) + val
            io = v.get("io")
            if isinstance(io, dict):
                tot = io_stages.setdefault(r, {})
                for stage, sv in (io.get("stages") or {}).items():
                    if isinstance(sv, dict) and \
                            isinstance(sv.get("s"), (int, float)):
                        tot[stage] = tot.get(stage, 0.0) + sv["s"]
                if isinstance(io.get("position"), dict):
                    io_position[r] = io["position"]
    per_rank = {}
    for r, ts in sorted(rank_times.items()):
        ts = sorted(ts)
        per_rank[r] = {
            "steps": sum(n for _t, n in ts),
            "p50_s": round(ts[(len(ts) - 1) // 2][0], 6),
            "max_s": round(ts[-1][0], 6),
            "total_s": round(sum(t * n for t, n in ts), 6),
        }
        if r in seg_totals:
            per_rank[r]["segments_s"] = {
                k: round(v, 6) for k, v in sorted(seg_totals[r].items())}
    for r, rn in rank_numerics.items():
        per_rank.setdefault(r, {}).update(rn)
    for r, tot in io_stages.items():
        per_rank.setdefault(r, {})["io_stages_s"] = {
            k: round(v, 6) for k, v in sorted(tot.items())}
    for r, pos in io_position.items():
        per_rank.setdefault(r, {})["data_position"] = pos
    straggler = max(worst, key=worst.get) if worst else None
    # the cross-rank io-bottleneck verdict: when the straggler's steps
    # are dominated by input_wait (the data plane, not compute, makes
    # it slow) and it reported an io stage breakdown, NAME the slowest
    # stage on that rank — the answer run_top surfaces when the step
    # segments say "input"
    io_bottleneck = None
    if straggler is not None:
        seg = seg_totals.get(straggler, {})
        input_s = seg.get("input_wait", 0.0)
        stages = io_stages.get(straggler)
        if stages and input_s > 0 and input_s >= seg.get("compute", 0.0):
            slow_stage = max(stages, key=stages.get)
            io_bottleneck = {"rank": int(straggler),
                             "stage": slow_stage,
                             "stage_s": round(stages[slow_stage], 6),
                             "input_wait_s": round(input_s, 6)}
    return {
        "schema": head.get("schema"),
        "num_ranks": head.get("num_ranks"),
        "steps": len(steps),
        "complete_steps": sum(1 for s in steps
                              if s.get("n_ranks") == head.get("num_ranks")),
        "straggler": None if straggler is None else int(straggler),
        "worst_rank_counts": {k: worst[k] for k in sorted(worst)},
        "skew_max_s": round(skew_max, 6),
        "skew_last_s": skew_last,
        "grad_skew_max": grad_skew_max,
        "digest_mismatch_steps": digest_mismatch_steps,
        "io_bottleneck": io_bottleneck,
        "health": fleet_health,
        "alerts": [{k: a.get(k) for k in ("ts", "step", "rule", "to",
                                          "severity", "value", "bound")
                    if a.get(k) is not None} for a in alerts],
        "per_rank": per_rank,
        "events": [{k: e.get(k) for k in ("ts", "event", "rank", "pid",
                                          "attempt", "exit_code", "path",
                                          "telemetry_port", "rule",
                                          "to", "severity", "status")
                    if e.get(k) is not None} for e in events],
        "ended": any(r.get("kind") == "run_end" for r in records),
    }
