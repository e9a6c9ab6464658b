"""Straggler attribution, single-rank part.

The counterpart of ``mxnet_tpu/telemetry/distview.py``.  Ported: the
per-step split of host wall time into ``compute`` / ``input_wait`` /
``collective_wait`` (:func:`record_step_segments` →
``mxtpu_step_segment_seconds``), and the rank/world readers.  The
cross-rank half — the pre-collective timestamp barrier, the
``mxtpu-run/1`` run aggregator and the on-demand live capture — belongs to
multi-GPU training (ROADMAP Queue A item 6): each raises "not yet ported".
The JAX ``tools/run_top.py`` reads the port's JSONL step log with the JAX
package's own aggregator.
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = [
    "RUN_SCHEMA", "SEGMENTS", "rank", "world", "skew_every",
    "record_step_segments", "pre_collective_barrier",
    "capture_dir", "capture_seconds", "capture_now", "capture_status",
    "install_capture_handler", "rank_jsonl_path", "split_jsonl",
    "RunAggregator", "read_run_timeline", "summarize_run",
]

#: run-timeline schema tag of the JAX package's aggregator
RUN_SCHEMA = "mxtpu-run/1"

#: step segment names, in display order
SEGMENTS = ("compute", "input_wait", "collective_wait")

_NOT_PORTED = ("not yet ported to mxnet_tpu_torch: the cross-rank "
               "distview comes with multi-GPU training (ROADMAP Queue A "
               "item 6)")


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
    """``MXNET_TPU_SKEW_EVERY`` (default 8): the barrier's cadence in the
    JAX package; read here only to report it."""
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


def pre_collective_barrier(site="trainer.step"):
    """None in a one-process run (no peer to wait for), as in the JAX
    package; across processes it is not yet ported."""
    if world() <= 1:
        return None
    raise MXNetError("pre_collective_barrier: " + _NOT_PORTED)


def capture_dir():
    """``MXNET_TPU_CAPTURE_DIR``, or None."""
    return os.environ.get("MXNET_TPU_CAPTURE_DIR") or None


def capture_seconds():
    """``MXNET_TPU_CAPTURE_SECONDS`` (default 3)."""
    try:
        return max(0.1, float(os.environ.get("MXNET_TPU_CAPTURE_SECONDS",
                                             "3")))
    except ValueError:
        return 3.0


def capture_status():
    """The ``/debug`` endpoint's capture block: live capture is not
    ported."""
    return {"armed": False, "active": False, "reason": _NOT_PORTED}


def capture_now(trigger="api", seconds=None, directory=None):
    raise MXNetError("capture_now: " + _NOT_PORTED)


def install_capture_handler(signum=None):
    raise MXNetError("install_capture_handler: " + _NOT_PORTED)


def split_jsonl(buf):
    raise MXNetError("split_jsonl: " + _NOT_PORTED)


def rank_jsonl_path(base, r):
    raise MXNetError("rank_jsonl_path: " + _NOT_PORTED)


class RunAggregator:
    """The ``mxtpu-run/1`` aggregator: not yet ported."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("RunAggregator: " + _NOT_PORTED)


def read_run_timeline(path):
    raise MXNetError("read_run_timeline: " + _NOT_PORTED)


def summarize_run(records):
    raise MXNetError("summarize_run: " + _NOT_PORTED)
