"""Serving tier: batch ladder, continuous batcher, HTTP front door.

The counterpart of ``mxnet_tpu/serving/``:

* :class:`~mxnet_tpu_torch.serving.ladder.BatchLadder` holds one
  Predictor per batch size over shared weights and, on the card, one
  captured CUDA graph a rung (the counterpart of the JAX ladder's AOT
  executables): after warm-up a request replays a graph and never
  builds or captures; partial batches pad to the nearest rung;
* :class:`~mxnet_tpu_torch.serving.batcher.Batcher` coalesces requests
  into rungs within a batching window, schedules earliest-deadline-first
  and sheds load early, with the JAX batcher's metrics, flight events,
  trace spans and ``serve.dispatch`` fault seam;
* :class:`~mxnet_tpu_torch.serving.server.Server` answers
  ``POST /predict``, ``GET /healthz`` (``?deep=1`` adds the SLO
  verdict), ``GET /alerts`` and ``GET /metrics``, and arms the SLO
  engine's ticker.

``python -m mxnet_tpu_torch.serving --checkpoint PREFIX`` runs a replica
on ``gpu(0)``.
"""
from __future__ import annotations

from .ladder import BatchLadder, ladder_rungs, DEFAULT_RUNGS
from .batcher import Batcher, RequestShed
from .server import Server, serve_port

__all__ = ["BatchLadder", "ladder_rungs", "DEFAULT_RUNGS",
           "Batcher", "RequestShed", "Server", "serve_port"]
