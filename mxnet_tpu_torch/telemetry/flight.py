"""Flight recorder: a black box for training runs.

The counterpart of ``mxnet_tpu/telemetry/flight.py``: a bounded ring of
recent structured events — step begin/end, compile (kernel build) events,
fault injections, io verdicts, counter deltas — cheap enough to run
always, dumped to a JSON "black box" file when the run dies: on
:class:`~mxnet_tpu_torch.base.MXNetError` in a guarded training seam, on
an annotated ``torch.cuda.OutOfMemoryError`` (see :mod:`.memory`), on
SIGTERM preemption (:meth:`ShardedTrainer.install_preemption_handler`),
and on any uncaught exception (the excepthook installed when
``MXNET_TPU_FLIGHT_DIR`` is set).  The JAX ``tools/flight_read.py``
pretty-prints a dump of either package.

Recording is always on; *dumping* requires ``MXNET_TPU_FLIGHT_DIR`` to
name a writable directory — without it :func:`dump` is a no-op returning
``None``.

The ring takes no lock.  The preemption handler runs in the main thread
between bytecodes and dumps the ring, possibly while that same thread
is inside :func:`record`: a lock there would deadlock the handler.  An
append to a bounded ``deque`` and ``next()`` on an ``itertools.count``
are each atomic under the interpreter lock, and a snapshot that races an
append is retaken.

Dump schema (``"schema": "mxtpu-flight/1"``, the JAX package's)::

    {
      "schema": "mxtpu-flight/1",
      "reason": "oom" | "error" | "sigterm" | "crash" | <caller string>,
      "ts": <unix seconds>, "pid": ..., "host": ...,
      "rank": <MXNET_TPU_PROCESS_ID>,
      "restart_count": <MXNET_TPU_RESTART_COUNT>,
      "error": <str or null>,
      "events": [{"seq": n, "ts": ..., "kind": ..., ...fields}, ...],
      "counters": {...}, "gauges": {...},     # registry snapshot
      "memory_plans": {},                     # no static plan here
      "live_memory": {...} | null             # torch.cuda.memory_stats
    }
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import time
from collections import deque

from ..base import MXNetError
from . import tracing
from .catalog import COUNTER, GAUGE
from .registry import REGISTRY, counter

__all__ = ["FlightRecorder", "RECORDER", "record", "events", "clear",
           "dump", "dump_dir", "capacity", "crash_guard",
           "install_excepthook"]

DEFAULT_CAPACITY = 512


def dump_dir():
    """Dump destination directory (``MXNET_TPU_FLIGHT_DIR``), or None
    when black-box dumping is off."""
    return os.environ.get("MXNET_TPU_FLIGHT_DIR") or None


def capacity():
    """Ring capacity (``MXNET_TPU_FLIGHT_EVENTS``, default 512)."""
    try:
        n = int(os.environ.get("MXNET_TPU_FLIGHT_EVENTS",
                               str(DEFAULT_CAPACITY)))
    except ValueError:
        n = DEFAULT_CAPACITY
    return max(8, n)


class FlightRecorder:
    """Bounded ring of structured events + the dump writer.

    One module-level instance (:data:`RECORDER`) serves the process;
    tests may build private ones.  Every method is safe from any thread
    and from a signal handler (no lock, see the module docstring).
    """

    def __init__(self, capacity_=None):
        self._events = deque(maxlen=capacity_ or capacity())
        self._seq = itertools.count(1)
        self._dumps = itertools.count(1)

    # ----------------------------------------------------------- record
    def record(self, kind, **fields):
        """Append one event; returns its sequence number.  ``fields``
        must be JSON-serializable (the dump writer falls back to repr
        for anything that is not)."""
        ev = {"kind": str(kind), "ts": round(time.time(), 6)}
        ev.update(fields)
        if "trace_id" not in ev:
            # events recorded under an active trace carry its id, so the
            # flight ring and the trace files join
            ctx = tracing.current()
            if ctx is not None:
                ev["trace_id"] = ctx.trace_id
        ev["seq"] = next(self._seq)
        self._events.append(ev)
        counter("mxtpu_flight_events_total").labels(kind=str(kind)).inc()
        return ev["seq"]

    def events(self):
        """Snapshot of the ring, oldest first (copies, safe to mutate)."""
        while True:
            try:
                return [dict(e) for e in list(self._events)]
            except RuntimeError:       # an append raced the copy
                continue

    def clear(self):
        self._events.clear()
        self._seq = itertools.count(1)

    def __len__(self):
        return len(self._events)

    # ------------------------------------------------------------- dump
    def dump(self, reason, path=None, error=None, directory=None):
        """Write the black box.  Returns the written path, or None when
        dumping is disabled (no ``path``, no ``directory``, and
        ``MXNET_TPU_FLIGHT_DIR`` unset).  Never raises: the recorder
        must not replace the error it is documenting — write failures
        are logged and swallowed."""
        if path is None:
            directory = directory or dump_dir()
            if not directory:
                return None
            path = os.path.join(
                directory, "flight-%d-%03d-%s.json"
                % (os.getpid(), next(self._dumps), _slug(reason)))
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            doc = self._payload(reason, error)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True, default=repr)
            os.replace(tmp, path)
        except Exception as e:  # the error being documented must win
            import logging
            logging.getLogger(__name__).warning(
                "flight recorder: cannot write black box %r: %s", path, e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        counter("mxtpu_flight_dumps_total").labels(
            reason=_slug(reason)).inc()
        return path

    def _payload(self, reason, error):
        from . import memory as memory_mod
        from .distview import rank as _rank
        try:
            restart = int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
        except ValueError:
            restart = 0
        return {
            "schema": "mxtpu-flight/1",
            "reason": str(reason),
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "rank": _rank(),
            "restart_count": restart,
            "error": None if error is None else str(error),
            "events": self.events(),
            "counters": REGISTRY.flat(kinds=(COUNTER,)),
            "gauges": REGISTRY.flat(kinds=(GAUGE,)),
            "memory_plans": memory_mod.plans_dict(),
            "live_memory": memory_mod.device_memory_stats(),
        }


def _slug(reason):
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in str(reason))[:40] or "dump"


#: the process-wide recorder (module-level helpers below)
RECORDER = FlightRecorder()


def record(kind, **fields):
    """Record one event on the default recorder."""
    return RECORDER.record(kind, **fields)


def events():
    """Snapshot of the default recorder's ring, oldest first."""
    return RECORDER.events()


def clear():
    """Empty the default recorder's ring (telemetry.reset calls this)."""
    RECORDER.clear()


def dump(reason, path=None, error=None, directory=None):
    """Dump the default recorder — see :meth:`FlightRecorder.dump`."""
    return RECORDER.dump(reason, path=path, error=error,
                         directory=directory)


class crash_guard:
    """Context manager: on :class:`MXNetError` (fault injections, budget
    violations, annotated OOMs — anything the framework raises on
    purpose), record an ``error`` event and dump the black box, then
    re-raise unchanged.  Nested guards dump once: the innermost tags the
    exception and outer levels pass it through.

    ::

        with flight.crash_guard("trainer.step"):
            loss = step(...)
    """

    def __init__(self, site, recorder=None):
        self.site = site
        self._rec = recorder or RECORDER

    def __enter__(self):
        return self

    def __exit__(self, etype, exc, tb):
        if exc is None or not isinstance(exc, MXNetError):
            return False
        if getattr(exc, "_mxtpu_flight_dumped", False):
            return False
        try:
            exc._mxtpu_flight_dumped = True
        except AttributeError:
            pass
        from .memory import HbmOomError
        reason = "oom" if isinstance(exc, HbmOomError) else "error"
        self._rec.record("error", site=self.site,
                         error_type=type(exc).__name__,
                         message=str(exc)[:2000])
        self._rec.dump(reason, error=exc)
        return False


_hook_installed = [False]


def install_excepthook():
    """Chain a ``sys.excepthook`` that dumps the black box (reason
    ``crash``) on any uncaught exception, then delegates to the previous
    hook.  Installed at import when ``MXNET_TPU_FLIGHT_DIR`` is set, so
    a process that dies leaves a dump.  Idempotent."""
    if _hook_installed[0]:
        return
    _hook_installed[0] = True
    prev = sys.excepthook

    def hook(etype, value, tb):
        if not getattr(value, "_mxtpu_flight_dumped", False):
            try:
                RECORDER.record("crash", error_type=etype.__name__,
                                message=str(value)[:2000])
                RECORDER.dump("crash", error=value)
            except Exception:  # never mask the original crash
                pass
        prev(etype, value, tb)

    sys.excepthook = hook
