"""Batch ladder: one Predictor handle per batch size, one CUDA graph a rung.

The counterpart of ``mxnet_tpu/serving/ladder.py``, which AOT-compiles one
executable per rung at startup and owns the "zero compiles in the request
path" contract.  Here the counterpart of one compiled executable is one
captured ``torch.cuda.CUDAGraph``:

* :meth:`BatchLadder.warm_up` runs each rung once eagerly (that run builds
  the kernels, sets their attributes and encodes their TMA descriptors),
  captures the rung's ``Executor.forward(is_train=False)`` in a graph, and
  replays it once to measure the wall that seeds the scheduler's estimate.
  Every capture is one ``compile`` event (``telemetry.compile``), so
  ``mxtpu_compile_total`` counts the rungs as the JAX warm-up counts its
  compiles, and the request path adds none;
* :meth:`BatchLadder.dispatch` copies the padded feed into the input
  tensors captured with the graph, replays it, and copies out the output
  tensors captured with it.  The graph bakes in every address the forward
  used (the flash kernel's TMA descriptors carry raw pointers), so the
  ladder keeps those tensors itself and writes them directly: a rebinding
  of the Predictor's arrays (an ``NDArray`` assigned under
  ``autograd.record()`` is a fresh tensor) never leaves a replay on stale
  inputs;
* the graphs are captured in the constructing thread, before any batcher
  starts, and share one memory pool: rungs replay one at a time, from the
  batcher's single scheduler thread.

A capture that fails raises :class:`~mxnet_tpu_torch.base.MXNetError`
naming the rung and the op being captured; there is no eager fallback on
the card.  On a CPU context the ladder runs eagerly (the CPU has no
graphs).  Rung walls fold every live dispatch into an EWMA
(:meth:`BatchLadder.observe_wall`).

Not yet ported (ROADMAP Queue A item 9): the JAX ladder's static-liveness
budget gate on the largest rung (``budget_check`` is accepted, warns
and checks nothing) and its fitted cost model (``MXNET_TPU_SERVE_COST_MODEL``).

The ladder is not thread-safe: the Batcher drives it from its single
scheduler thread.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..base import MXNetError
from ..predictor import Predictor, pad_batch
from ..telemetry import tracing

__all__ = ["BatchLadder", "ladder_rungs", "DEFAULT_RUNGS"]

log = logging.getLogger(__name__)

#: default rung set: powers-of-4 ladder (MXNET_TPU_SERVE_LADDER overrides)
DEFAULT_RUNGS = (1, 4, 16, 64)

#: EWMA weight of a newly observed dispatch wall
_EWMA_ALPHA = 0.2


def ladder_rungs(spec=None):
    """Parse a ladder spec (``"1,4,16,64"`` or a sequence) into a sorted
    tuple of distinct positive batch sizes.  ``spec=None`` reads
    ``MXNET_TPU_SERVE_LADDER``; empty or unset gives
    :data:`DEFAULT_RUNGS`."""
    if spec is None:
        spec = os.environ.get("MXNET_TPU_SERVE_LADDER", "")
    if isinstance(spec, (tuple, list)):
        rungs = tuple(sorted({int(r) for r in spec}))
    else:
        toks = [t for t in str(spec).replace(";", ",").split(",")
                if t.strip()]
        if not toks:
            return DEFAULT_RUNGS
        try:
            rungs = tuple(sorted({int(t) for t in toks}))
        except ValueError:
            raise MXNetError(
                "bad ladder spec %r (MXNET_TPU_SERVE_LADDER): expected "
                "comma-separated batch sizes like '1,4,16,64'" % (spec,))
    if not rungs or rungs[0] < 1:
        raise MXNetError("ladder rungs must be positive, got %r" % (rungs,))
    return rungs


def _failed_op(exc):
    """The op note that ``eval_graph`` attaches to an error raised while it
    runs a node, searched along the exception's context chain (a capture
    that fails inside the forward fails again when it ends)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        for note in getattr(exc, "__notes__", ()):
            if note.startswith("while running op "):
                return note[len("while running "):]
        exc = exc.__cause__ or exc.__context__
    return None


class BatchLadder:
    """Predictors at a ladder of batch sizes over one set of weights, one
    captured CUDA graph a rung on the card.

    ``predictor``: a bound :class:`~mxnet_tpu_torch.predictor.Predictor`
    (its own batch need not be a rung; each rung is an independent
    ``reshaped()`` handle over the shared weights).  ``rungs``: see
    :func:`ladder_rungs`.  ``budget_check``: the JAX ladder's memlive gate
    on the largest rung; accepted, and until ``analysis.memlive`` is
    ported it checks nothing and says so in a warning.  ``warm``: warm
    (and on the card capture) every rung now; pass False to defer to
    :meth:`warm_up`."""

    def __init__(self, predictor, rungs=None, budget_check=True, warm=True):
        if not isinstance(predictor, Predictor):
            raise MXNetError("BatchLadder needs a Predictor, got %r"
                             % type(predictor).__name__)
        self._rungs = ladder_rungs(rungs)
        self._input_names = list(predictor._input_names)
        # per-input trailing (non-batch) dims + dtype from the bound
        # executor: the rung handles only ever change axis 0
        self._tails, self._dtypes = {}, {}
        for n in self._input_names:
            arr = predictor._executor.arg_dict[n]
            self._tails[n] = tuple(arr.shape)[1:]
            self._dtypes[n] = np.dtype(arr.dtype)
        self._preds = {}
        for r in self._rungs:
            shapes = {n: (r,) + self._tails[n] for n in self._input_names}
            self._preds[r] = predictor.reshaped(shapes)
        self._device = predictor._executor._device
        self._graphs = {}        # rung -> (CUDAGraph, inputs, outputs)
        self._pool = None        # the memory pool the graphs share
        self._stream = None      # the side stream they were captured on
        self._wall = {}          # rung -> EWMA wall estimate (seconds)
        self._warmed = False
        if budget_check:
            log.warning("serving ladder: budget_check is not applied (the "
                        "memory gate waits for analysis.memlive)")
        if warm:
            self.warm_up()

    # ------------------------------------------------------------ properties
    @property
    def rungs(self):
        """The sorted rung tuple."""
        return self._rungs

    @property
    def max_rung(self):
        return self._rungs[-1]

    @property
    def input_names(self):
        return list(self._input_names)

    @property
    def warmed(self):
        """True once every rung has run (and on the card been captured)."""
        return self._warmed

    @property
    def graphs(self):
        """True when the rungs replay captured CUDA graphs (a CUDA
        context), False when they run eagerly (the CPU)."""
        return self._device.type == "cuda"

    def input_tail(self, name):
        """Non-batch dims of one input (the shape a request row must
        have)."""
        return self._tails[name]

    def input_dtype(self, name):
        return self._dtypes[name]

    # -------------------------------------------------------------- warm-up
    def warm_up(self):
        """Warm every rung (ascending): one eager forward, then on the card
        the capture of the rung's graph (one ``compile`` event) and one
        replay, whose wall (the outputs copied to the host) seeds the
        scheduler's estimate; on the CPU a second eager forward measures
        the wall.  Returns {rung: wall_seconds}."""
        for r in self._rungs:
            feed = {n: np.zeros((r,) + self._tails[n], dtype=self._dtypes[n])
                    for n in self._input_names}
            pred = self._preds[r]
            for n, arr in feed.items():
                pred.set_input(n, arr)
            if self.graphs:
                self._capture(r)
            else:
                pred._executor.forward(is_train=False)
            t0 = time.perf_counter()
            self._run(r)
            wall = time.perf_counter() - t0
            self._wall[r] = wall
            log.info("serving ladder: rung %d warm (wall %.2f ms%s)", r,
                     wall * 1e3, ", CUDA graph" if self.graphs else "")
        self._warmed = True
        return dict(self._wall)

    def _capture(self, rung):
        """One eager forward of ``rung`` on the capture stream, then its
        capture into a CUDA graph in the pool the rungs share."""
        from ..telemetry import compile as _compile
        exe = self._preds[rung]._executor
        if exe._monitor_callback is not None or exe._stats_cb is not None:
            raise MXNetError(
                "serving ladder: rung %d has an executor monitor; a monitor "
                "fetches op outputs to the host, which a CUDA graph cannot "
                "capture" % rung)
        with torch.cuda.device(self._device):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
                self._pool = torch.cuda.graph_pool_handle()
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                exe.forward(is_train=False)       # builds, sets, encodes
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                    outs = exe.forward(is_train=False)
            except Exception as e:  # named, never an eager fallback
                op = _failed_op(e)
                raise MXNetError(
                    "serving ladder: capturing rung %d in a CUDA graph "
                    "failed %s: %s: %s"
                    % (rung, "while running " + op if op else
                       "at the end of the capture", type(e).__name__,
                       str(e).splitlines()[0] if str(e) else "")) from e
            seconds = time.perf_counter() - t0
        inputs = {n: exe.arg_dict[n]._data for n in self._input_names}
        self._graphs[rung] = (graph, inputs, [o.data for o in outs])
        _compile.record_build(seconds, "serve.rung%d cuda graph" % rung)

    # ------------------------------------------------------------- dispatch
    def pick_rung(self, rows):
        """Smallest rung that fits ``rows`` (None when rows exceed the
        largest rung: the caller splits or refuses)."""
        for r in self._rungs:
            if rows <= r:
                return r
        return None

    def estimate_wall(self, rung):
        """Scheduler-facing wall estimate for one rung: the measured EWMA,
        else the largest known wall (an unknown rung must not look free to
        the deadline check)."""
        if rung in self._wall:
            return self._wall[rung]
        return max(self._wall.values()) if self._wall else 0.0

    def observe_wall(self, rung, wall):
        """Fold a measured dispatch wall into the rung's EWMA."""
        prev = self._wall.get(rung)
        self._wall[rung] = wall if prev is None else \
            (1.0 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * wall

    def _run(self, rung):
        """The rung's forward on its staged inputs: the graph's replay on
        the card, the eager forward on the CPU.  Returns every output as
        numpy, all rows."""
        captured = self._graphs.get(rung)
        if captured is None:
            if self.graphs:
                raise MXNetError("serving ladder: rung %d has no captured "
                                 "graph; call warm_up()" % rung)
            exe = self._preds[rung]._executor
            exe.forward(is_train=False)
            return [o.asnumpy() for o in exe.outputs]
        graph, _, outs = captured
        with torch.cuda.device(self._device):
            graph.replay()
            return [o.cpu().numpy() for o in outs]

    def dispatch(self, rung, feed):
        """Run one batch at ``rung``.  ``feed``: name -> array of at most
        ``rung`` rows (padded here).  Returns every output as numpy, all
        rows; the caller slices per request.  Never captures or builds
        after warm-up: the card replays the rung's graph."""
        if rung not in self._preds:
            raise MXNetError("no rung %r in ladder %r" % (rung, self._rungs))
        pred = self._preds[rung]
        captured = self._graphs.get(rung)
        pad_rows = 0
        for n in self._input_names:
            arr = feed[n]
            if arr.shape[0] != rung:
                pad_rows = max(pad_rows, rung - arr.shape[0])
                arr = pad_batch(arr, rung)
            if captured is None:
                pred.set_input(n, arr)
            else:                       # the graph's own input tensors
                captured[1][n].copy_(torch.from_numpy(np.ascontiguousarray(
                    arr, dtype=self._dtypes[n])))
        pred._partial_rows.clear()      # the batcher owns slicing
        outs = self._run(rung)
        # detail for the batcher's serve.dispatch trace span (no-op
        # without an attached context): the rung actually run, rows the
        # ladder itself had to pad, and the slice handed back for the
        # batcher to split per request
        tracing.annotate(ladder_rung=rung, ladder_pad_rows=pad_rows,
                         ladder_slice_outputs=len(outs))
        return outs

    def describe(self):
        """Structured ladder state for ``/healthz``: the JAX ladder's
        fields (``cost_model_ms`` stays empty: no cost model yet), the
        rungs captured as CUDA graphs, and the context."""
        return {
            "rungs": list(self._rungs),
            "warmed": self._warmed,
            "wall_ms": {str(r): round(self._wall[r] * 1e3, 3)
                        for r in sorted(self._wall)},
            "cost_model_ms": {},
            "inputs": {n: {"tail": list(self._tails[n]),
                           "dtype": str(self._dtypes[n])}
                       for n in self._input_names},
            "graphs": sorted(self._graphs),
            "context": str(self._preds[self._rungs[0]].context),
        }
