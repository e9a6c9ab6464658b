"""Monitor: statistics of intermediate outputs during training.

The counterpart of ``mxnet_tpu/monitor.py``.  ``install(exe)`` hooks an
Executor through ``set_monitor_callback``; every ``interval``-th ``tic()``
activates it, and until ``toc()`` each op output whose name matches
``pattern`` gives ``(step, name, stat_func(output))``.  ``toc()`` returns
them as ``(step, name, value string)`` triples, the JAX ``Monitor``'s,
and ``toc_print()`` logs them.  The stat is computed on the output's device
as the forward runs; ``toc()`` reads it back.

The JAX package has two routes: statistics computed inside its compiled
forward (the default) and an eager per-node callback (``eager=True``).
The port runs eagerly, so it has the one route, which gives the eager
route's triples; ``eager`` is accepted and changes nothing.  As in the JAX
package, ``toc()`` mirrors each statistic into the telemetry gauge
``mxtpu_monitor_stat{tensor}`` (its mean; the values are on the host by
then, so no transfer is added); ``Executor.set_stats_monitor`` is the
numerics route.
"""
from __future__ import annotations

import logging
import re

import numpy as np

from . import telemetry
from .ndarray import NDArray

__all__ = ["Monitor"]


def asum_stat(x):
    """The mean absolute value of an NDArray, as an NDArray on its
    device."""
    return NDArray(x.data.abs().float().mean())


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 eager=None):
        """``interval``: activate on every ``interval``-th ``tic()``;
        ``stat_func``: NDArray -> statistic (default :func:`asum_stat`);
        ``pattern``: a regular expression the output names must match
        from their start; ``sort``: ``toc()`` orders by name."""
        self.stat_func = stat_func or asum_stat
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.eager = eager

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Hook ``exe``'s forward."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start a step: activate on every ``interval``-th call."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the step: ``[(step, name, value string)]`` of the outputs
        seen while active (empty when it was not)."""
        if not self.activated:
            return []
        self.activated = False
        queue = sorted(self.queue, key=lambda x: x[1]) if self.sort \
            else self.queue
        res = []
        for n, k, v_list in queue:
            if not isinstance(v_list, list):
                v_list = [v_list]
            s = ""
            host = []
            for v in v_list:
                if isinstance(v, NDArray):
                    v = v.asnumpy()
                host.append(v)
                s += str(v) + "\t"
            res.append((n, k, s))
            try:
                telemetry.gauge("mxtpu_monitor_stat").labels(
                    tensor=str(k)).set(float(np.mean(np.asarray(host[0]))))
            except (TypeError, ValueError, IndexError):
                pass      # a non-numeric or empty custom statistic
        self.queue = []
        return res

    def toc_print(self):
        """``toc()``, logged one line a statistic."""
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
