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
    "MXNET_PROFILER_AUTOSTART": ("0", "honored",
                                 "1: start the profiler at import and "
                                 "dump its Chrome trace at exit "
                                 "(profiler.py)"),
    "MXNET_PROFILER_MODE": ("0", "honored",
                            "the autostarted profiler's mode when set: "
                            "0 symbolic, else all (unset: all, as the "
                            "JAX package)"),
    "MXNET_PROFILER_FILENAME": ("profile.json", "honored",
                                "the autostarted profiler's dump file"),
    "MXNET_PROFILER_XLA_DIR": ("", "honored",
                               "device trace directory: torch.profiler's "
                               "Chrome trace (CUDA kernels included) of "
                               "each run/stop window; the JAX package "
                               "writes xprof traces here"),
    "MXNET_CUDNN_AUTOTUNE_DEFAULT": ("0", "inert",
                                     "cuDNN's heuristics choose the "
                                     "algorithms"),
    # tests
    "MXNET_TEST_DEVICE": ("cpu", "honored",
                          "test_utils.default_context: cpu, gpu or "
                          "gpu(N); unset, the current context (gpu(0) "
                          "unless a context is open): the 'cpu' beside "
                          "it is the JAX catalog's, which test_utils "
                          "does not apply"),
    # multi-process bootstrap
    "MXNET_TPU_NUM_PROCESSES": ("1", "honored",
                                "telemetry.distview.world(): above 1 the "
                                "cross-rank barrier raises (multi-process "
                                "training: " + _NOT_PORTED + ")"),
    "MXNET_TPU_PROCESS_ID": ("0", "honored",
                             "this process's rank: serve_port's offset "
                             "(serving/server.py), the trace and flight "
                             "records' rank (telemetry/tracing.py, "
                             "telemetry/slo.py, telemetry/distview.py)"),
    "MXNET_TPU_COORDINATOR": ("", "inert", ""),
    # the input pipeline
    "MXNET_USE_NATIVE_REC": ("", "honored",
                             "force (1) or disable (0) the native JPEG "
                             "record pipeline in tools.train_imagenet; "
                             "1 raises where the port's native library "
                             "has no JPEG decoder"),
    # resilience
    "MXNET_TPU_FAULTS": ("", "honored",
                         "fault injection at the named seams "
                         "(resilience.py): site:p=,seed=,n=,after=,kind=,"
                         "delay=;..."),
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
    "MXNET_TPU_RESTART_COUNT": ("0", "honored",
                                "the restart attempt a supervisor runs "
                                "this process under: the "
                                "mxtpu_watchdog_restarts gauge "
                                "(telemetry/exporters.py) and the flight "
                                "dumps (telemetry/flight.py)"),
    "MXNET_TPU_STRICT_BIND": ("0", "honored",
                              "1: every Executor bind and ShardedTrainer "
                              "runs the graph verifier (analysis) at its "
                              "shapes before any op runs, with the "
                              "memory-liveness leg when a budget is "
                              "armed"),
    # telemetry (telemetry/)
    "MXNET_TPU_TELEMETRY_JSONL": ("", "honored",
                                  "append one JSON line per training step "
                                  "(span timings, segments, full counter/"
                                  "gauge snapshot, ioview block) to this "
                                  "file"),
    "MXNET_TPU_TELEMETRY_PORT": ("0", "honored",
                                 "serve Prometheus text metrics on "
                                 "http://0.0.0.0:PORT/metrics (0 = off)"),
    "MXNET_TPU_FLIGHT_DIR": ("", "honored",
                             "write flight-recorder dumps here on "
                             "MXNetError/OOM/SIGTERM/crash (recording "
                             "is always on)"),
    "MXNET_TPU_FLIGHT_EVENTS": ("512", "honored",
                                "flight-recorder ring capacity"),
    "MXNET_TPU_TRACE_SAMPLE": ("1", "honored",
                               "tracing sample rate of ordinary traces, "
                               "in [0,1] (errors and the slow tail are "
                               "always kept; 0 disables tracing)"),
    "MXNET_TPU_TRACE_DIR": ("", "honored",
                            "append kept traces as mxtpu-trace/1 JSONL "
                            "to trace.rank<N>.jsonl here"),
    "MXNET_TPU_TRACE_RING": ("256", "honored",
                             "in-process kept-trace ring capacity"),
    "MXNET_TPU_TRACE_SLOW_PCT": ("0.95", "honored",
                                 "slow-tail retention percentile"),
    "MXNET_TPU_IOVIEW_EVERY": ("1", "honored",
                               "attach the input pipeline's io block to "
                               "every Nth step's JSONL record (0: no "
                               "block; the stage metrics and the "
                               "classifier keep running)"),
    "MXNET_TPU_DATA_RESUME": ("1", "honored",
                              "the data iterator's state in checkpoint "
                              "manifests, restored on resume "
                              "(io_resume.py)"),
    "MXNET_TPU_BACKPRESSURE": ("0", "honored",
                               "fit() installs a controller that moves "
                               "DevicePrefetchIter's depth on the ioview "
                               "verdict (io_resume.py)"),
    "MXNET_TPU_IOVIEW_WINDOW": ("5", "honored",
                                "ioview bottleneck-classifier window in "
                                "seconds"),
    "MXNET_TPU_SKEW_EVERY": ("8", "honored",
                             "read and reported by telemetry.distview "
                             "(skew_every); the cross-rank timestamp "
                             "barrier it paces: " + _NOT_PORTED),
    "MXNET_TPU_CAPTURE_DIR": ("", "honored",
                              "read by telemetry.distview.capture_dir; "
                              "on-demand live capture: " + _NOT_PORTED
                              + " (capture_status says so)"),
    "MXNET_TPU_CAPTURE_SECONDS": ("3", "honored",
                                  "read by telemetry.distview."
                                  "capture_seconds"),
    "MXNET_TPU_MEMORY_BUDGET": ("1.0", "honored",
                                "fraction of device capacity the caching "
                                "allocator may use "
                                "(set_per_process_memory_fraction at "
                                "trainer construction; <=0 or 1 off)"),
    "MXNET_TPU_HBM_LIMIT_BYTES": ("", "honored",
                                  "device-capacity override for the "
                                  "memory budget check"),
    "MXNET_TPU_MEMLIVE_TOL": ("0.25", "honored",
                              "analysis.memlive: MXG018's relative drift "
                              "tolerance between the static peak and the "
                              "measured total"),
    "MXNET_TPU_COSTDB": ("", "honored",
                         "telemetry.costdb: append mxtpu-costdb/1 "
                         "records here (flush, and at exit)"),
    "MXNET_TPU_COSTDB_SAMPLE": ("16", "honored",
                                "time every Nth dispatch per program "
                                "after the first (CUDA events on the "
                                "card; 0 = never)"),
    "MXNET_TPU_PEAK_FLOPS": ("", "honored",
                             "overrides the costdb peak FLOP/s (gpu: "
                             "989e12, the H100's dense bf16)"),
    "MXNET_TPU_PEAK_BW": ("", "honored",
                          "overrides the costdb peak bytes/s (gpu: "
                          "3.35e12)"),
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
    "MXNET_TPU_SERVE_LADDER": ("1,4,16,64", "honored",
                               "batch-ladder rungs the serving tier warms "
                               "at startup (one captured CUDA graph a "
                               "rung on the card); requests pad to the "
                               "nearest rung"),
    "MXNET_TPU_SERVE_WINDOW_MS": ("5", "honored",
                                  "batching window: how long the batcher "
                                  "holds the oldest queued request while "
                                  "coalescing toward the largest rung"),
    "MXNET_TPU_SERVE_QUEUE_DEPTH": ("64", "honored",
                                    "bounded request-queue depth; a submit "
                                    "beyond it is shed at once "
                                    "(queue_full)"),
    "MXNET_TPU_SERVE_DEADLINE_MS": ("1000", "honored",
                                    "default per-request deadline; a "
                                    "request whose remaining deadline "
                                    "cannot cover the estimated rung wall "
                                    "is shed early (deadline)"),
    "MXNET_TPU_SERVE_PORT": ("8080", "honored",
                             "serving replica base port; a replica binds "
                             "port + MXNET_TPU_PROCESS_ID"),
    "MXNET_TPU_SERVE_COST_MODEL": ("", "honored",
                                   "path to a fitted autotune cost model "
                                   "(mxtpu-costmodel/1) that prices each "
                                   "ladder rung from its graph's analytic "
                                   "flops and bytes "
                                   "(describe()['cost_model_ms'])"),
    "MXNET_TPU_RESHARD_RULES": ("", "inert", _NOT_PORTED),
    # autotuner and plan search
    "MXNET_TPU_AUTOTUNE": ("cache", "honored",
                           "off|cache|search: the kernel wrappers' and the "
                           "fusion planner's tuning-cache lookups "
                           "(autotune.cache.kernel_config); search tunes a "
                           "miss inline, never inside a CUDA-graph capture"),
    "MXNET_TPU_TUNE_CACHE": ("", "honored",
                             "tuning-cache directory: tunecache*.jsonl "
                             "merged on load, puts appended "
                             "(autotune.cache)"),
    "MXNET_TPU_PLAN_SEARCH": ("cache", "honored",
                              "off|cache: the bind-time graph_plan lookup "
                              "of Executor and ShardedTrainer "
                              "(analysis.plansearch.committed_decisions)"),
    "MXNET_TPU_PLAN_BUDGET": ("64", "honored",
                              "candidate plans the plan search's beam "
                              "scores (analysis.plansearch.plan_budget)"),
    "MXNET_TPU_PLAN_BEAM": ("8", "honored",
                            "the plan search's beam width "
                            "(analysis.plansearch.plan_beam)"),
    # training-health numerics (telemetry/numerics.py)
    "MXNET_TPU_NUMERICS_EVERY": ("0", "honored",
                                 "parameter and gradient statistics every "
                                 "Nth trainer step() (one host fetch on a "
                                 "sampled step); 0 disables"),
    "MXNET_TPU_NUMERICS_STRICT": ("0", "honored",
                                  "a fired anomaly rule dumps the flight "
                                  "ring and raises"),
    "MXNET_TPU_NUMERICS_LEDGER": ("", "honored",
                                  "append one mxtpu-numerics/1 record per "
                                  "sampled step to this file"),
    "MXNET_TPU_NUMERICS_SPIKE": ("10", "honored",
                                 "grad_spike factor over the EWMA; 0 "
                                 "disables the rule"),
    "MXNET_TPU_NUMERICS_DEAD": ("1.0", "honored",
                                "dead_grad threshold on a gradient's "
                                "zero fraction; 0 disables the rule"),
    # SLO engine
    "MXNET_TPU_SLO": ("1", "honored",
                      "the in-process SLO engine: 0 disables rule "
                      "evaluation (health() reports status=healthy, "
                      "disabled=true; no alert metrics, no ticker)"),
    "MXNET_TPU_SLO_RULES": ("", "honored",
                            "SLO rule-catalog override: @file.json or an "
                            "inline JSON list merged by rule name "
                            "(disable:true drops a rule), or "
                            "'rule.param=value;rule2.disable=1'; a "
                            "malformed spec warns once and keeps the "
                            "defaults"),
    "MXNET_TPU_SLO_TICK_S": ("1.0", "honored",
                             "background-ticker evaluation cadence in "
                             "seconds (floor 0.05); also rate-limits the "
                             "per-step evaluation"),
    "MXNET_TPU_SLO_FAST_S": ("60", "honored",
                             "default fast burn-rate window in seconds"),
    "MXNET_TPU_SLO_SLOW_S": ("300", "honored",
                             "default slow burn-rate window in seconds"),
    "MXNET_TPU_SLO_LATENCY_MS": ("250", "honored",
                                 "serving latency SLO threshold: a request "
                                 "slower than this is 'bad' for "
                                 "serve_p99_latency_burn"),
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
