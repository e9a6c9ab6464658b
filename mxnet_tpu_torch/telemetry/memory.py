"""Device memory accounting: live statistics, budget and OOM forensics.

The counterpart of ``mxnet_tpu/telemetry/memory.py`` over PyTorch's
caching allocator:

* **live stats** — :func:`sample_live_memory` reads
  ``torch.cuda.memory_stats()`` (host-side counters of the caching
  allocator: no sync with the card) into the ``mxtpu_hbm_bytes_in_use`` /
  ``mxtpu_hbm_peak_bytes`` gauges (``allocated_bytes.all.current`` /
  ``.peak``, label ``cuda:<i>``) at step boundaries;
  :func:`device_memory_stats` gives the JAX package's key names
  (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit`` from the
  device's properties, ...);
* **budget** — ``MXNET_TPU_MEMORY_BUDGET`` is the fraction of device
  capacity the run may use (default 1.0; <= 0 disables).  Eager PyTorch
  has no static plan before dispatch, so the port applies the fraction to
  the caching allocator (:func:`apply_budget`,
  ``torch.cuda.set_per_process_memory_fraction``): an allocation past it
  raises ``torch.cuda.OutOfMemoryError``, which :class:`annotate_oom`
  turns into :class:`HbmOomError`.  :func:`check_budget` checks a
  :class:`MemoryPlan` a caller built against the same budget;
* **OOM annotation** — :class:`annotate_oom` re-raises a device
  ``OutOfMemoryError`` as :class:`HbmOomError` with the live statistics and
  the largest live blocks of the allocator's snapshot
  (:func:`largest_live_buffers`), counts it and records it in the flight
  ring.

No static plan exists here: XLA's ``memory_analysis``/``cost_analysis``
have no eager counterpart.  :func:`plan_of` returns None,
:func:`planned_executable` returns the function it is given, and the plan
registry stays empty unless a caller registers a plan it built.
``MXNET_TPU_HBM_LIMIT_BYTES`` overrides the capacity, as in the JAX
package.
"""
from __future__ import annotations

import os
import threading

from ..base import MXNetError
from .registry import counter, gauge
from . import flight

__all__ = [
    "HbmOomError", "MemoryPlan",
    "memory_analysis_of", "cost_analysis_of", "plan_of",
    "register_plan", "get_plan", "plans_dict", "clear_plans",
    "device_memory_stats", "device_capacity_bytes", "sample_live_memory",
    "budget_fraction", "apply_budget", "check_budget", "planned_executable",
    "dispatch_planned", "is_oom_error", "annotate_oom",
    "largest_live_buffers",
]

#: plan byte categories, in breakdown display order
CATEGORIES = ("argument", "output", "temp", "alias", "generated_code")


class HbmOomError(MXNetError):
    """A device out-of-memory annotated with the live statistics and the
    largest live blocks (raised by :func:`annotate_oom`; the original
    error is chained)."""


# ------------------------------------------------------- static plans

def memory_analysis_of(compiled):
    """None: eager PyTorch compiles no program with a memory analysis."""
    return None


def cost_analysis_of(compiled):
    """None: eager PyTorch compiles no program with a cost analysis."""
    return None


class MemoryPlan:
    """A program's footprint, bytes per category plus FLOPs / bytes
    accessed — built by a caller that knows them (nothing in the port
    computes one)."""

    def __init__(self, program, memory=None, cost=None):
        self.program = program
        self.memory = dict(memory or {})
        self.cost = dict(cost or {})

    @property
    def total_bytes(self):
        m = self.memory
        total = sum(m.get(c, 0) for c in
                    ("argument", "output", "temp", "generated_code"))
        return max(0, total - m.get("alias", 0))

    def as_dict(self):
        d = {"program": self.program, "total_bytes": self.total_bytes}
        d.update({"%s_bytes" % c: self.memory[c] for c in CATEGORIES
                  if c in self.memory})
        d.update(self.cost)
        return d

    def breakdown(self):
        parts = ["%s=%s" % (c, _fmt_bytes(self.memory[c]))
                 for c in CATEGORIES if c in self.memory]
        parts.append("total=%s" % _fmt_bytes(self.total_bytes))
        if "flops" in self.cost:
            parts.append("flops=%.3g" % self.cost["flops"])
        return ", ".join(parts)

    def __repr__(self):
        return "MemoryPlan(%r: %s)" % (self.program, self.breakdown())


def _fmt_bytes(n):
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return ("%.1f %s" if unit != "B" else "%.0f %s") % (n, unit)
        n /= 1024.0


def plan_of(compiled, program):
    """None: the port has no static plan of a program before dispatch."""
    return None


_plans_lock = threading.Lock()
_PLANS = {}


def register_plan(plan):
    """Record a caller-built plan (the plan registry the flight dump and
    ``report()`` snapshot).  Nothing in the port calls it, so the
    ``mxtpu_memory_plan_bytes`` family stays unset (catalog
    ``NOT_EMITTED``)."""
    with _plans_lock:
        _PLANS[plan.program] = plan
    flight.record("memory_plan", program=plan.program,
                  total_bytes=plan.total_bytes, **plan.cost)
    return plan


def get_plan(program):
    with _plans_lock:
        return _PLANS.get(program)


def plans_dict():
    """{program: plan dict} snapshot — empty unless a caller registered
    one."""
    with _plans_lock:
        return {name: p.as_dict() for name, p in sorted(_PLANS.items())}


def clear_plans():
    with _plans_lock:
        _PLANS.clear()


# -------------------------------------------------------- live memory

def _cuda_ready():
    """Whether a CUDA context exists in this process: sampling must not
    create one (nor fail) in a CPU-only run."""
    try:
        import torch
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:  # a broken CUDA install reads as no device
        return False


def device_memory_stats(device=None):
    """The caching allocator's statistics of ``device`` (default: the
    current CUDA device) under the JAX package's key names, or None
    without an initialized CUDA device."""
    if not _cuda_ready():
        return None
    import torch
    try:
        idx = torch.cuda.current_device() if device is None \
            else torch.device(device).index or 0
        s = torch.cuda.memory_stats(idx)
        limit = torch.cuda.get_device_properties(idx).total_memory
    except Exception:  # sampling degrades to None, never to a crash
        return None
    return {
        "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
        "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
        "bytes_limit": int(limit),
        "num_allocs": int(s.get("allocation.all.allocated", 0)),
        "num_alloc_retries": int(s.get("num_alloc_retries", 0)),
        "num_ooms": int(s.get("num_ooms", 0)),
    }


def device_capacity_bytes(device=None):
    """Usable device memory in bytes: ``MXNET_TPU_HBM_LIMIT_BYTES`` when
    set, else the device's ``total_memory``, else None."""
    try:
        env = int(os.environ.get("MXNET_TPU_HBM_LIMIT_BYTES", "0") or 0)
    except ValueError:
        env = 0
    if env:
        return env
    stats = device_memory_stats(device)
    return stats["bytes_limit"] if stats else None


def sample_live_memory():
    """Read the current device's allocator statistics into the
    ``mxtpu_hbm_bytes_in_use`` / ``mxtpu_hbm_peak_bytes`` gauges (label
    ``cuda:<i>``).  Returns the stats dict, or None without a CUDA
    device.  Host-side counters only: no sync with the card."""
    if not _cuda_ready():
        return None
    import torch
    idx = torch.cuda.current_device()
    stats = device_memory_stats(idx)
    if stats is None:
        return None
    label = "cuda:%d" % idx
    gauge("mxtpu_hbm_bytes_in_use").labels(device=label).set(
        stats["bytes_in_use"])
    gauge("mxtpu_hbm_peak_bytes").labels(device=label).set(
        stats["peak_bytes_in_use"])
    return stats


# -------------------------------------------------------------- budget

def budget_fraction():
    """``MXNET_TPU_MEMORY_BUDGET``: fraction of device capacity the run
    may use (default 1.0; a value <= 0 disables the budget)."""
    try:
        return float(os.environ.get("MXNET_TPU_MEMORY_BUDGET", "1.0"))
    except ValueError:
        return 1.0


def apply_budget(device):
    """Cap the caching allocator of CUDA ``device`` at
    ``budget_fraction()`` of its capacity (a fraction in (0, 1));
    returns the fraction applied, or None.  The trainer calls it at
    construction."""
    fraction = budget_fraction()
    if not 0.0 < fraction < 1.0:
        return None
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.set_per_process_memory_fraction(fraction, dev.index or 0)
    flight.record("memory_budget", device=str(dev), fraction=fraction)
    return fraction


def check_budget(plan, capacity=None, fraction=None, device=None):
    """Raise :class:`~mxnet_tpu_torch.base.MXNetError` when a caller-built
    plan's total exceeds ``fraction * capacity``.  Inert for ``plan=None``
    (the port's case: no plan before dispatch), an unknown capacity, or
    a disabled budget."""
    if fraction is None:
        fraction = budget_fraction()
    if fraction <= 0 or plan is None:
        return
    if capacity is None:
        capacity = device_capacity_bytes(device)
    if not capacity:
        return
    budget = int(capacity * fraction)
    if plan.total_bytes <= budget:
        return
    flight.record("budget_exceeded", program=plan.program,
                  total_bytes=plan.total_bytes, budget_bytes=budget)
    raise MXNetError(
        "memory budget check: program %r needs %s of device memory but "
        "only %s is budgeted (capacity %s x MXNET_TPU_MEMORY_BUDGET=%.2f)."
        "  Plan breakdown: %s.  Options: reduce the per-device batch "
        "size, or raise the budget fraction if the headroom is "
        "intentional." % (plan.program, _fmt_bytes(plan.total_bytes),
                          _fmt_bytes(budget), _fmt_bytes(capacity),
                          fraction, plan.breakdown()))


def planned_executable(program, fn, args):
    """``fn`` unchanged: nothing is compiled ahead of dispatch, so there
    is no plan to register or check."""
    return fn


def dispatch_planned(cache, program, fn, args):
    """``fn(*args)``: the JAX package's planned dispatch without a plan."""
    return fn(*args)


# ------------------------------------------------------- OOM forensics

def is_oom_error(exc):
    """True for a device out-of-memory: ``torch.cuda.OutOfMemoryError``,
    or a RuntimeError whose message says CUDA ran out of memory.  A
    host-side :class:`MemoryError` is not one."""
    if isinstance(exc, MemoryError):
        return False
    try:
        import torch
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    msg = str(exc)
    return "CUDA out of memory" in msg or "RESOURCE_EXHAUSTED" in msg


def largest_live_buffers(n=8):
    """The ``n`` largest live blocks of the caching allocator's snapshot
    as ``(nbytes, shape, dtype)`` tuples, largest first (the allocator
    knows sizes, not tensor shapes: shape is ``(nbytes,)`` and dtype
    ``"bytes"``).  Empty without a CUDA device."""
    if not _cuda_ready():
        return []
    import torch
    try:
        snap = torch.cuda.memory._snapshot()
    except Exception:  # a debugging API: degrade to no forensics
        return []
    sizes = []
    for seg in snap.get("segments", []):
        for blk in seg.get("blocks", []):
            if blk.get("state") == "active_allocated":
                sizes.append(int(blk.get("size", 0)))
    sizes.sort(reverse=True)
    return [(s, (s,), "bytes") for s in sizes[:n]]


class annotate_oom:
    """Context manager around a dispatch: a device out-of-memory is
    re-raised as :class:`HbmOomError` whose message carries the live
    statistics and the largest live blocks; the event is counted
    (``mxtpu_oom_total``) and recorded in the flight ring.  Other errors
    pass through untouched.

    ::

        with memory.annotate_oom("trainer.step"):
            loss = step(batch)
    """

    def __init__(self, program):
        self.program = program

    def __enter__(self):
        return self

    def __exit__(self, etype, exc, tb):
        if exc is None or isinstance(exc, HbmOomError) \
                or not is_oom_error(exc):
            return False
        counter("mxtpu_oom_total").labels(program=self.program).inc()
        live = device_memory_stats()
        buffers = largest_live_buffers()
        flight.record(
            "oom", program=self.program, plan_total_bytes=None,
            bytes_in_use=(live or {}).get("bytes_in_use"),
            peak_bytes_in_use=(live or {}).get("peak_bytes_in_use"))
        lines = ["device out of memory while running %r." % self.program,
                 "static memory plan: none (eager PyTorch plans nothing "
                 "before dispatch)."]
        if live:
            lines.append(
                "live device memory: bytes_in_use=%s, peak=%s, "
                "reserved=%s, limit=%s."
                % (_fmt_bytes(live["bytes_in_use"]),
                   _fmt_bytes(live["peak_bytes_in_use"]),
                   _fmt_bytes(live["bytes_reserved"]),
                   _fmt_bytes(live["bytes_limit"])))
        else:
            lines.append("live device memory: no CUDA device statistics.")
        if buffers:
            lines.append("largest live blocks: %s." % "; ".join(
                _fmt_bytes(b) for b, _shape, _dtype in buffers))
        lines.append(
            "Advice: reduce the per-device batch size or the model's "
            "width.  A flight-recorder dump of the final seconds is "
            "written when MXNET_TPU_FLIGHT_DIR is set.")
        raise HbmOomError(" ".join(lines)) from exc
