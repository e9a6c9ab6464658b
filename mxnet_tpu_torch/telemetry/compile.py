"""Compile-event capture: the port's kernel builds.

The counterpart of ``mxnet_tpu/telemetry/compile.py``.  The JAX package
counts XLA backend compiles through ``jax.monitoring``; the port compiles
no XLA programs.  Its compiles are the ``nvcc`` (and ``g++``) builds of
``cuda_build.py`` and of ``mx.rtc`` — each a shared library built on first
use and cached by the hash of its source — and each build calls
:func:`record_build`, which feeds ``mxtpu_compile_total`` /
``mxtpu_compile_seconds_total`` and leaves a ``compile`` flight event.
So a rebuild inside a training step shows in the step's counter deltas
as a recompile does in the JAX package.  A cached library that is only
loaded is not a compile.
"""
from __future__ import annotations

from .registry import counter

__all__ = ["install", "installed", "record_build", "SOURCE"]

#: ``report()["compile"]["source"]``: where compile events come from
SOURCE = "nvcc"


def install():
    """True: the builds report themselves, nothing to register."""
    return True


def installed():
    """True: compile counts are exact, not the step-time heuristic."""
    return True


def record_build(seconds, what):
    """Count one finished build of ``what`` that took ``seconds``."""
    counter("mxtpu_compile_total").inc()
    counter("mxtpu_compile_seconds_total").inc(float(seconds))
    from . import flight
    flight.record("compile", duration_s=round(float(seconds), 6),
                  what=str(what))
