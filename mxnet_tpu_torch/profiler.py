"""Profiler: Chrome-trace dump plus the device trace of ``torch.profiler``.

The counterpart of ``mxnet_tpu/profiler.py`` (reference
``src/engine/profiler.{h,cc}`` and ``python/mxnet/profiler.py``), in two
layers:

* Python-level events — the executor's forward and backward, imperative
  dispatch (``ndarray.invoke``), each graph node that ``eval_graph`` runs
  (the trainer's eager step runs op by op) and the telemetry spans — are
  recorded here on one clock (:func:`now_us`) and dumped by
  :func:`dump_profile` in the reference's Chrome trace-event JSON
  (``{"traceEvents": [...], "displayTimeUnit": "ms"}``);
* device detail comes from ``torch.profiler`` (CPU and, where there is a
  card, CUDA activity through CUPTI), started and stopped with the
  profiler's state when ``MXNET_PROFILER_XLA_DIR`` names a directory.  The
  JAX package writes an xprof trace there; the port writes the Chrome
  trace ``torch.profiler`` exports, ``device-<pid>-<n>.json``, whose
  ``kernel`` events name each CUDA kernel launched (:func:`device_traces`
  lists them).  Stopping it waits for the card, so the last kernels are
  in the trace: that sync is the profiler's, outside any step.

Recording adds no sync: an event is two reads of the host clock.
``MXNET_PROFILER_AUTOSTART=1`` starts the profiler at import in mode
``all`` (``MXNET_PROFILER_MODE=0``: symbolic) and dumps to
``MXNET_PROFILER_FILENAME`` at exit, as the reference does;
``MXNET_PROFILER_XLA_DIR`` is read when the profiler starts.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "record_event", "record_scope", "is_running", "now_us",
           "device_traces"]

_state = {
    "mode": "symbolic",      # 'symbolic' | 'all' | 'imperative'
    "filename": "profile.json",
    "running": False,
    "events": [],
    "device": None,          # the running torch.profiler.profile
    "device_traces": [],     # exported device trace files
}
_lock = threading.Lock()
_t0 = time.perf_counter()


def now_us():
    """Microseconds on the profiler's clock (trace-event timebase), which
    the telemetry spans stamp their events on too."""
    return (time.perf_counter() - _t0) * 1e6


_now_us = now_us


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Reference MXSetProfilerConfig (c_api.cc:79-95)."""
    if mode not in ("symbolic", "all", "imperative"):
        raise ValueError("invalid profiler mode %r" % mode)
    with _lock:
        _state["mode"] = mode
        _state["filename"] = filename


def _start_device_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_device_trace(prof, directory):
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    with _lock:
        n = len(_state["device_traces"]) + 1
    path = os.path.join(directory, "device-%d-%d.json" % (os.getpid(), n))
    prof.export_chrome_trace(path)
    with _lock:
        _state["device_traces"].append(path)
    return path


def profiler_set_state(state="stop"):
    """Reference MXSetProfilerState: 'run' | 'stop'.  With
    ``MXNET_PROFILER_XLA_DIR`` set, 'run' starts ``torch.profiler`` and
    'stop' stops it and writes its Chrome trace there."""
    if state == "run":
        directory = os.environ.get("MXNET_PROFILER_XLA_DIR") or None
        with _lock:
            _state["running"] = True
            start = directory and _state["device"] is None
            if start:
                # claimed under the lock: a racing 'run' must not start a
                # second session; rolled back if the start fails
                _state["device"] = "starting"
        if start:
            try:
                prof = _start_device_trace()
            except BaseException:
                with _lock:
                    _state["device"] = None
                raise
            with _lock:
                _state["device"] = (prof, directory)
    elif state == "stop":
        with _lock:
            _state["running"] = False
            session, _state["device"] = _state["device"], None
        if isinstance(session, tuple):
            _stop_device_trace(*session)
    else:
        raise ValueError("invalid profiler state %r" % state)


def is_running(imperative=False):
    if not _state["running"]:
        return False
    if imperative and _state["mode"] == "symbolic":
        # reference kOnlySymbolic skips imperative ops
        # (threaded_engine.cc:289-295)
        return False
    return True


def record_event(name, start_us, dur_us, category="operator", tid=0):
    """Append one complete ('X') trace event."""
    with _lock:
        _state["events"].append({
            "name": name, "cat": category, "ph": "X",
            "ts": start_us, "dur": dur_us, "pid": 0, "tid": tid,
        })


class record_scope:
    """Context manager timing a scope into the profile."""

    def __init__(self, name, category="operator", imperative=False):
        self.name = name
        self.category = category
        self.imperative = imperative

    def __enter__(self):
        self.active = is_running(self.imperative)
        self.start = _now_us() if self.active else 0
        return self

    def __exit__(self, *exc):
        if self.active:
            record_event(self.name, self.start, _now_us() - self.start,
                         self.category,
                         tid=threading.get_ident() % (1 << 31))


def dump_profile(finished=True):
    """Write Chrome trace-event JSON (reference MXDumpProfile)."""
    with _lock:
        events = list(_state["events"])
        if finished:
            _state["events"] = []
        filename = _state["filename"]
    with open(filename, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return filename


def device_traces():
    """Paths of the device traces written so far, oldest first."""
    with _lock:
        return list(_state["device_traces"])


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    # the JAX package autostarts in mode all; MXNET_PROFILER_MODE, when
    # set, chooses as the reference does (0 symbolic, else all)
    _mode = os.environ.get("MXNET_PROFILER_MODE")
    profiler_set_config(mode="symbolic" if _mode == "0" else "all",
                        filename=os.environ.get("MXNET_PROFILER_FILENAME",
                                                "profile.json"))
    profiler_set_state("run")
    atexit.register(dump_profile)
