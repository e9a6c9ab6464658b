"""Runtime configuration: the ``MXNET_*`` environment-variable catalog.

The counterpart of ``mxnet_tpu/config.py``: the same names and defaults, so
a launch script written for either package reads the same.  Each entry says
whether the port reads the variable (``honored``) or accepts it and does
nothing with it (``inert``: the job belongs to a subsystem the port has not
ported yet, or to PyTorch).  ``get``, ``get_int`` and ``get_bool`` read
the environment with the catalog's default.
"""
from __future__ import annotations

import os

__all__ = ["get", "get_int", "get_bool", "describe"]

_NOT_PORTED = "not yet ported to mxnet_tpu_torch"

# name -> (default, status, note)
_CATALOG = {
    # engine / threading: PyTorch's eager dispatch on CUDA streams
    "MXNET_ENGINE_TYPE": ("ThreadedEnginePerDevice", "inert",
                          "PyTorch dispatches eagerly on CUDA streams"),
    "MXNET_CPU_WORKER_NTHREADS": ("1", "inert",
                                  "PyTorch's intra-op threads"),
    "MXNET_GPU_WORKER_NTHREADS": ("2", "inert", ""),
    "MXNET_GPU_COPY_NTHREADS": ("2", "inert", ""),
    "MXNET_CPU_PRIORITY_NTHREADS": ("4", "inert", ""),
    # memory
    "MXNET_GPU_MEM_POOL_RESERVE": ("5", "inert",
                                   "PyTorch's caching allocator owns "
                                   "device memory"),
    "MXNET_EXEC_NUM_TEMP": ("1", "inert", ""),
    # executor
    "MXNET_EXEC_BULK_EXEC_INFERENCE": ("1", "inert",
                                       "graphs run op by op, eagerly"),
    "MXNET_EXEC_BULK_EXEC_TRAIN": ("1", "inert", ""),
    "MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN": ("15", "inert", ""),
    "MXNET_EXEC_INPLACE_GRAD_SUM_CAP": ("8", "inert", ""),
    "MXNET_BACKWARD_DO_MIRROR": ("0", "inert",
                                 "activation recomputation: " + _NOT_PORTED),
    "NNVM_EXEC_MATCH_RANGE": ("16", "inert", ""),
    # kvstore
    "MXNET_KVSTORE_REDUCTION_NTHREADS": ("4", "inert", ""),
    "MXNET_KVSTORE_BIGARRAY_BOUND": ("1000000", "honored",
                                     "update_on_kvstore heuristic "
                                     "(model.py)"),
    "MXNET_ENABLE_GPU_P2P": ("1", "inert", ""),
    # fusion and graph rewrites
    "MXNET_FUSE_CONV_BN": ("0", "inert",
                           "the conv1x1+BN pass: " + _NOT_PORTED),
    "MXNET_FUSE_BLOCKS": ("0", "honored",
        "block-granularity fusion (analysis.fusion): conv+BN+ReLU and "
        "FC+activation chains run as single regions, the 1x1 ones under "
        "NHWC on K5; the default of Executor binds and of "
        "ShardedTrainer(fuse_blocks=None), read where no block_fusion "
        "context decides"),
    "MXNET_STEM_S2D": ("0", "inert", "stem space-to-depth: " + _NOT_PORTED),
    "MXNET_PHASE_BWD": ("0", "inert",
                        "phase-decomposed stride-2 backward: "
                        + _NOT_PORTED),
    "MXNET_CONV1X1_DOT": ("0", "inert",
                          "pointwise convolutions as dots: " + _NOT_PORTED),
    # profiler
    "MXNET_PROFILER_AUTOSTART": ("0", "inert", "profiler: " + _NOT_PORTED),
    "MXNET_PROFILER_MODE": ("0", "inert", ""),
    "MXNET_PROFILER_FILENAME": ("profile.json", "inert", ""),
    "MXNET_PROFILER_XLA_DIR": ("", "inert", ""),
    "MXNET_CUDNN_AUTOTUNE_DEFAULT": ("0", "inert",
                                     "cuDNN's heuristics choose the "
                                     "algorithms"),
    # tests
    "MXNET_TEST_DEVICE": ("cpu", "inert", ""),
    # multi-process bootstrap
    "MXNET_TPU_NUM_PROCESSES": ("1", "inert",
                                "multi-process training: " + _NOT_PORTED),
    "MXNET_TPU_PROCESS_ID": ("0", "inert", ""),
    "MXNET_TPU_COORDINATOR": ("", "inert", ""),
    # the input pipeline
    "MXNET_USE_NATIVE_REC": ("", "honored",
                             "force (1) or disable (0) the native JPEG "
                             "record pipeline in tools.train_imagenet; "
                             "1 raises where the port's native library "
                             "has no JPEG decoder"),
    # resilience
    "MXNET_TPU_FAULTS": ("", "inert", "fault injection: " + _NOT_PORTED),
    "MXNET_TPU_BAD_RECORD_QUOTA": ("0", "honored",
                                   "max corrupt/truncated records a "
                                   "reader skips by magic-resync before "
                                   "raising (0 = strict)"),
    "MXNET_TPU_HEARTBEAT_TIMEOUT": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_INIT_TIMEOUT": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_INIT_RETRIES": ("2", "inert", _NOT_PORTED),
    "MXNET_TPU_BARRIER_TIMEOUT": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_BARRIER_RETRIES": ("1", "inert", _NOT_PORTED),
    "MXNET_TPU_RESTART_BUDGET": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_HEARTBEAT_INTERVAL": ("0.2", "inert", _NOT_PORTED),
    "MXNET_TPU_RESTART_COUNT": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_STRICT_BIND": ("0", "inert",
                              "the graph verifier: " + _NOT_PORTED),
    # telemetry
    "MXNET_TPU_TELEMETRY_JSONL": ("", "inert",
                                  "telemetry: " + _NOT_PORTED),
    "MXNET_TPU_TELEMETRY_PORT": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_FLIGHT_DIR": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_FLIGHT_EVENTS": ("512", "inert", _NOT_PORTED),
    "MXNET_TPU_TRACE_SAMPLE": ("1", "inert", _NOT_PORTED),
    "MXNET_TPU_TRACE_DIR": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_TRACE_RING": ("256", "inert", _NOT_PORTED),
    "MXNET_TPU_TRACE_SLOW_PCT": ("0.95", "inert", _NOT_PORTED),
    "MXNET_TPU_IOVIEW_EVERY": ("1", "inert",
                               "the input pipeline's stage accounting: "
                               + _NOT_PORTED),
    "MXNET_TPU_DATA_RESUME": ("1", "inert",
                              "iterator state in checkpoints: "
                              + _NOT_PORTED),
    "MXNET_TPU_BACKPRESSURE": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_IOVIEW_WINDOW": ("5", "inert", _NOT_PORTED),
    "MXNET_TPU_SKEW_EVERY": ("8", "inert", _NOT_PORTED),
    "MXNET_TPU_CAPTURE_DIR": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_CAPTURE_SECONDS": ("3", "inert", _NOT_PORTED),
    "MXNET_TPU_MEMORY_BUDGET": ("1.0", "inert", _NOT_PORTED),
    "MXNET_TPU_HBM_LIMIT_BYTES": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_MEMLIVE_TOL": ("0.25", "inert", _NOT_PORTED),
    "MXNET_TPU_COSTDB": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_COSTDB_SAMPLE": ("16", "inert", _NOT_PORTED),
    "MXNET_TPU_PEAK_FLOPS": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_PEAK_BW": ("", "inert", _NOT_PORTED),
    # communication overlap
    "MXNET_TPU_OVERLAP": ("1", "inert",
                          "bucketed gradient allreduce: " + _NOT_PORTED
                          + "; DevicePrefetchIter always stages on its "
                          "own stream"),
    "MXNET_TPU_BUCKET_BYTES": ("4194304", "inert", _NOT_PORTED),
    # elastic training
    "MXNET_TPU_ELASTIC": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_MIN_WORKERS": ("1", "inert", _NOT_PORTED),
    "MXNET_TPU_FLEET": ("0", "inert", _NOT_PORTED),
    # serving tier
    "MXNET_TPU_SERVE_LADDER": ("1,4,16,64", "inert",
                               "the port's ladder takes its rungs as an "
                               "argument"),
    "MXNET_TPU_SERVE_WINDOW_MS": ("5", "inert", ""),
    "MXNET_TPU_SERVE_QUEUE_DEPTH": ("64", "inert", ""),
    "MXNET_TPU_SERVE_DEADLINE_MS": ("1000", "inert", ""),
    "MXNET_TPU_SERVE_PORT": ("8080", "inert", ""),
    "MXNET_TPU_SERVE_COST_MODEL": ("", "inert", ""),
    "MXNET_TPU_RESHARD_RULES": ("", "inert", _NOT_PORTED),
    # autotuner and plan search
    "MXNET_TPU_AUTOTUNE": ("cache", "inert", _NOT_PORTED),
    "MXNET_TPU_TUNE_CACHE": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_PLAN_SEARCH": ("cache", "inert", _NOT_PORTED),
    "MXNET_TPU_PLAN_BUDGET": ("64", "inert", _NOT_PORTED),
    "MXNET_TPU_PLAN_BEAM": ("8", "inert", _NOT_PORTED),
    # training-health numerics
    "MXNET_TPU_NUMERICS_EVERY": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_NUMERICS_STRICT": ("0", "inert", _NOT_PORTED),
    "MXNET_TPU_NUMERICS_LEDGER": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_NUMERICS_SPIKE": ("10", "inert", _NOT_PORTED),
    "MXNET_TPU_NUMERICS_DEAD": ("1.0", "inert", _NOT_PORTED),
    # SLO engine
    "MXNET_TPU_SLO": ("1", "inert", _NOT_PORTED),
    "MXNET_TPU_SLO_RULES": ("", "inert", _NOT_PORTED),
    "MXNET_TPU_SLO_TICK_S": ("1.0", "inert", _NOT_PORTED),
    "MXNET_TPU_SLO_FAST_S": ("60", "inert", _NOT_PORTED),
    "MXNET_TPU_SLO_SLOW_S": ("300", "inert", _NOT_PORTED),
    "MXNET_TPU_SLO_LATENCY_MS": ("250", "inert", _NOT_PORTED),
}


def get(name, default=None):
    """The variable's value, else ``default``, else the catalog's default
    (None for a name outside the catalog)."""
    if name in _CATALOG and default is None:
        default = _CATALOG[name][0]
    return os.environ.get(name, default)


def get_int(name, default=None):
    v = get(name, default)
    return int(v) if v not in (None, "") else 0


def get_bool(name, default=None):
    v = get(name, default)
    return str(v) in ("1", "true", "True")


def describe():
    """The catalog as ``{name: (default, status, note)}``."""
    return dict(_CATALOG)
