"""The declared metric catalog: every metric the framework emits.

The counterpart of ``mxnet_tpu/telemetry/catalog.py``, with the same
``CATALOG``: names, kinds, label names and help, entry for entry, so a
dashboard or reader tool built for the JAX package reads the port's
metrics unchanged.  Each entry is ``name -> (kind, label names, help)``;
the registry refuses to create a metric that is not declared here (a
typo'd name fails at the emit site, not silently in a dashboard).

Some entries describe facts the port has no counterpart of (XLA's static
memory plan and cost analysis) or subsystems it has not ported (elastic
resharding).
They stay declared, so the vocabulary stays whole, and :data:`NOT_EMITTED`
names each with the reason nothing in the port emits it.

Naming follows Prometheus conventions: ``_total`` counters,
``_seconds``/``_bytes`` units, gauges unsuffixed.
"""
from __future__ import annotations

__all__ = ["CATALOG", "COUNTER", "GAUGE", "HISTOGRAM", "NOT_EMITTED",
           "selfcheck"]

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# seconds-scale latency buckets (histogram default): 0.5 ms .. 10 s
TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# name -> (kind, labelnames tuple, help)
CATALOG = {
    # ------------------------------------------------- training steps
    "mxtpu_step_total": (COUNTER, (), "training steps completed"),
    "mxtpu_samples_total": (COUNTER, (),
                            "samples consumed by training steps"),
    "mxtpu_step_seconds": (HISTOGRAM, (),
                           "host wall time per training step"),
    "mxtpu_span_seconds": (HISTOGRAM, ("span",),
                           "wall time per traced span (executor/module/"
                           "trainer/io phases)"),
    # ------------------------------------------------- XLA compilation
    "mxtpu_compile_total": (COUNTER, (),
                            "XLA backend compiles observed in this "
                            "process (jax.monitoring)"),
    "mxtpu_compile_seconds_total": (COUNTER, (),
                                    "total XLA backend compile time"),
    # ------------------------------------------------------------- IO
    "mxtpu_io_records_total": (COUNTER, ("source",),
                               "records read (source=recordio|native)"),
    "mxtpu_io_bad_records_total": (COUNTER, ("source",),
                                   "corrupt/truncated records skipped "
                                   "under MXNET_TPU_BAD_RECORD_QUOTA"),
    "mxtpu_io_resyncs_total": (COUNTER, ("source",),
                               "magic-resync scans after a corrupt "
                               "record"),
    "mxtpu_io_skipped_bytes_total": (COUNTER, ("source",),
                                     "bytes skipped while resyncing "
                                     "past corrupt records"),
    "mxtpu_io_prefetch_depth": (GAUGE, ("iter",),
                                "staged batches currently queued "
                                "(iter=host|device); last-observed "
                                "value set by the ioview occupancy "
                                "tracker under its own lock"),
    "mxtpu_io_prefetch_stall_seconds_total": (
        COUNTER, ("iter",),
        "time the consumer blocked waiting on the prefetcher"),
    "mxtpu_io_prefetch_starved_seconds_total": (
        COUNTER, ("iter",),
        "time prefetch producer threads idled waiting for the "
        "consumer to drain the queue (consumer-bound: the device, "
        "not the pipeline, bounds throughput)"),
    # ------------------------------- input-pipeline view (ioview)
    "mxtpu_io_stage_seconds": (HISTOGRAM, ("stage",),
                               "wall time per unit of work in each "
                               "input-pipeline stage (stage=read|"
                               "decode|augment|batch|host_prefetch|"
                               "device_stage)"),
    "mxtpu_io_stage_items_total": (COUNTER, ("stage",),
                                   "items processed per input-pipeline "
                                   "stage (records/images for the "
                                   "leaf stages, batches for the "
                                   "prefetch/staging stages)"),
    "mxtpu_io_bytes_total": (COUNTER, ("stage",),
                             "bytes flowing through each input-"
                             "pipeline stage"),
    "mxtpu_io_queue_occupancy": (HISTOGRAM, ("iter",),
                                 "time-weighted prefetch-queue "
                                 "occupancy: weighted observations "
                                 "where bucket counts are SECONDS "
                                 "spent at each staged-batch depth "
                                 "(sum/count = time-weighted mean "
                                 "depth)"),
    "mxtpu_io_bottleneck_total": (COUNTER, ("stage",),
                                  "per-window bottleneck verdicts from "
                                  "the ioview classifier (stage=<the "
                                  "slowest pipeline stage> when "
                                  "producer-bound, consumer when the "
                                  "training loop binds, balanced "
                                  "otherwise)"),
    "mxtpu_data_resume_total": (COUNTER, (),
                                "durable data-iterator restores from a "
                                "checkpoint manifest data_state entry "
                                "(io_resume.restore_iterator — mid-"
                                "epoch resume landed at the exact next "
                                "sample)"),
    "mxtpu_data_remap_samples": (GAUGE, (),
                                 "globally-consumed samples carried "
                                 "through the last elastic cursor "
                                 "remap (io_resume.remap_state: the "
                                 "permutation prefix re-cut for the "
                                 "new world size)"),
    "mxtpu_backpressure_adjust_total": (COUNTER, ("knob", "direction"),
                                        "runtime pipeline-knob moves by "
                                        "the backpressure controller "
                                        "(io_resume."
                                        "BackpressureController: "
                                        "direction=raise|lower per "
                                        "registered knob)"),
    # -------------------------------------------------------- kvstore
    "mxtpu_kvstore_push_bytes_total": (COUNTER, ("store",),
                                       "gradient bytes pushed "
                                       "(store=local|device|dist_sync|"
                                       "dist_async)"),
    "mxtpu_kvstore_pull_bytes_total": (COUNTER, ("store",),
                                       "weight bytes pulled"),
    "mxtpu_kvstore_pending_async": (GAUGE, (),
                                    "dist_async push/pull RPCs "
                                    "currently in flight"),
    # ------------------------- communication overlap (parallel.overlap)
    "mxtpu_overlap_buckets_total": (COUNTER, ("phase",),
                                    "gradient buckets launched by the "
                                    "overlap layer (phase=backward — "
                                    "the launch overlapped gradient "
                                    "production; drain — it waited "
                                    "for the optimizer boundary)"),
    "mxtpu_overlap_bucket_bytes": (HISTOGRAM, (),
                                   "payload bytes per launched "
                                   "gradient bucket "
                                   "(MXNET_TPU_BUCKET_BYTES sets the "
                                   "fill target)"),
    "mxtpu_overlap_drain_seconds": (HISTOGRAM, (),
                                    "wall time of the optimizer-"
                                    "boundary bucket drain (launch "
                                    "remainder + wait out every "
                                    "in-flight allreduce)"),
    "mxtpu_overlap_inflight_buckets": (GAUGE, (),
                                       "gradient buckets launched and "
                                       "not yet drained"),
    # ----------------------------------------------------- resilience
    "mxtpu_retry_total": (COUNTER, ("site",),
                          "retry attempts scheduled by "
                          "resilience.retry_call"),
    "mxtpu_fault_injected_total": (COUNTER, ("site",),
                                   "armed fault_point seams that fired"),
    "mxtpu_watchdog_restarts": (GAUGE, (),
                                "restart attempt this process is "
                                "running under (MXNET_TPU_RESTART_COUNT "
                                "from tools/launch.py)"),
    # -------------------------------------------------------- monitor
    "mxtpu_monitor_stat": (GAUGE, ("tensor",),
                           "latest Monitor stat value per matched "
                           "tensor"),
    # ------------------------------------------------ memory / HBM
    "mxtpu_memory_plan_bytes": (GAUGE, ("program", "category"),
                                "static XLA memory plan of a compiled "
                                "program (category=argument|output|temp|"
                                "alias|generated_code|total)"),
    "mxtpu_program_flops": (GAUGE, ("program",),
                            "XLA cost-analysis FLOPs per execution of "
                            "a compiled program"),
    "mxtpu_program_bytes_accessed": (GAUGE, ("program",),
                                     "XLA cost-analysis bytes accessed "
                                     "per execution (HBM traffic)"),
    "mxtpu_hbm_bytes_in_use": (GAUGE, ("device",),
                               "live device memory in use "
                               "(device.memory_stats, sampled at step "
                               "boundaries)"),
    "mxtpu_hbm_peak_bytes": (GAUGE, ("device",),
                             "peak device memory in use since process "
                             "start (device.memory_stats)"),
    "mxtpu_oom_total": (COUNTER, ("program",),
                        "RESOURCE_EXHAUSTED errors annotated with the "
                        "memory plan and live-bytes snapshot"),
    "mxtpu_predicted_peak_bytes": (GAUGE, ("program", "category"),
                                   "bind-time static liveness peak-HBM "
                                   "prediction (analysis.memlive; "
                                   "category=params|activations|"
                                   "residuals|optimizer|workspace|"
                                   "total)"),
    "mxtpu_remat_candidate_bytes": (GAUGE, ("program",),
                                    "residual bytes freeable at the "
                                    "predicted peak by the ranked "
                                    "MXG019 remat candidates"),
    "mxtpu_memlive_drift_ratio": (GAUGE, ("program",),
                                  "(static predicted peak - XLA "
                                  "memory_analysis total) / total for "
                                  "the last MXG018 comparison "
                                  "(MXNET_TPU_MEMLIVE_TOL bounds it)"),
    # ------------------------------------------------ flight recorder
    "mxtpu_flight_events_total": (COUNTER, ("kind",),
                                  "structured events recorded into the "
                                  "flight-recorder ring"),
    "mxtpu_flight_dumps_total": (COUNTER, ("reason",),
                                 "flight-recorder black-box dumps "
                                 "written (MXNET_TPU_FLIGHT_DIR)"),
    # ------------------------------- block fusion (analysis.fusion)
    "mxtpu_fusion_plans_total": (COUNTER, (),
                                 "block-fusion plans computed (one per "
                                 "trace with the pass enabled)"),
    "mxtpu_fusion_blocks_total": (COUNTER, ("kind",),
                                  "fused blocks emitted by the "
                                  "block-granularity fusion plan "
                                  "(kind=conv_bn_act|conv_bn|bn_act|"
                                  "fc_act)"),
    "mxtpu_fusion_relayouts_eliminated_total": (
        COUNTER, (),
        "region-boundary relayouts eliminated by the fusion layout "
        "plan (in-block interior edges + same-layout block "
        "adjacencies)"),
    "mxtpu_fusion_fallback_total": (COUNTER, ("reason",),
                                    "candidate chains the fusion pass "
                                    "left unfused, by reason"),
    # --------------------------------------- cost database (costdb)
    "mxtpu_block_mfu": (GAUGE, ("block",),
                        "latest derived model-FLOPs-utilization per "
                        "fused block / Pallas kernel (costdb roofline "
                        "attribution)"),
    "mxtpu_costdb_records_total": (COUNTER, ("kind",),
                                   "aggregate records created in the "
                                   "op/block cost database "
                                   "(kind=program|block|kernel|"
                                   "collective)"),
    # ----------------------------------------- autotuner (autotune)
    "mxtpu_tune_cache_hit_total": (COUNTER, ("op",),
                                   "trace-time tuning-cache lookups "
                                   "answered by a tuned entry "
                                   "(mxnet_tpu.autotune; the dispatch "
                                   "uses the measured-best block "
                                   "config)"),
    "mxtpu_tune_cache_miss_total": (COUNTER, ("op",),
                                    "tuning-cache lookups that fell "
                                    "back to the built-in heuristic "
                                    "(or triggered an inline search "
                                    "under MXNET_TPU_AUTOTUNE="
                                    "search)"),
    # ------------------------------- plan search (analysis.plansearch)
    "mxtpu_plan_cache_hit_total": (COUNTER, (),
                                   "bind-time graph_plan tuning-cache "
                                   "lookups answered by a committed "
                                   "plan entry (analysis.plansearch; "
                                   "the traces activate the searched "
                                   "decision vector)"),
    "mxtpu_plan_cache_miss_total": (COUNTER, (),
                                    "bind-time graph_plan lookups that "
                                    "fell back to the greedy fusion "
                                    "plan (untuned graph/mesh/layout)"),
    # ------------------------- static verification (mxnet_tpu.analysis)
    "mxtpu_verify_findings_total": (COUNTER, ("rule",),
                                    "verifier diagnostics reported, by "
                                    "rule id (MXG001-021; every "
                                    "Report.add increments — bind-time "
                                    "strict checks, CLI runs and "
                                    "ci_check sweeps all count)"),
    # ---------------------------- elastic training (parallel.reshard)
    "mxtpu_reshard_total": (COUNTER, ("kind",),
                            "mesh reshapes performed (kind=load — a "
                            "checkpoint restored onto a different mesh "
                            "shape; offline — tools/reshard.py "
                            "conversion; kvstore — DistKVStore state "
                            "migration)"),
    "mxtpu_reshard_params_total": (COUNTER, (),
                                   "named arrays restaged across mesh "
                                   "reshapes (params + aux; optimizer "
                                   "slots ride their param's plan "
                                   "entry)"),
    "mxtpu_reshard_bytes_total": (COUNTER, (),
                                  "bytes restaged across mesh "
                                  "reshapes"),
    "mxtpu_reshard_seconds": (HISTOGRAM, (),
                              "wall time per mesh reshape (plan + "
                              "per-param scatter onto the target "
                              "mesh)"),
    "mxtpu_elastic_resizes_total": (COUNTER, ("direction",),
                                    "world-size changes observed "
                                    "across a resume "
                                    "(direction=join|leave)"),
    # --------------------------- training-health numerics (numerics)
    "mxtpu_tensor_norm": (GAUGE, ("tensor", "kind"),
                          "latest sampled l2 norm per named tensor "
                          "(kind=param|grad|block|node; sampled every "
                          "MXNET_TPU_NUMERICS_EVERY steps inside the "
                          "jitted step)"),
    "mxtpu_grad_global_norm": (GAUGE, (),
                               "latest sampled global gradient l2 "
                               "norm (the grad_spike EWMA input)"),
    "mxtpu_nonfinite_total": (COUNTER, ("tensor",),
                              "non-finite (NaN/Inf) values detected "
                              "per watched tensor (grad/param/block "
                              "stats, monitored node outputs, and "
                              "metric/<name> update values)"),
    "mxtpu_numerics_anomalies_total": (COUNTER, ("rule",),
                                       "numerics anomaly rules fired "
                                       "(rule=nonfinite|grad_spike|"
                                       "dead_grad); each firing also "
                                       "leaves a numerics_anomaly "
                                       "flight event"),
    # ------------------------------------ cross-rank view (distview)
    "mxtpu_step_segment_seconds": (HISTOGRAM, ("segment",),
                                   "per-step host wall time split into "
                                   "segment=compute|input_wait|"
                                   "collective_wait (straggler "
                                   "attribution)"),
    "mxtpu_collective_wait_seconds": (HISTOGRAM, (),
                                      "time this rank stalled at a "
                                      "pre-collective timestamp barrier "
                                      "waiting for its slowest peer"),
    "mxtpu_rank_step_skew_seconds": (GAUGE, (),
                                     "arrival-time spread (max-min) "
                                     "across ranks at the last "
                                     "timestamp barrier — the "
                                     "straggler's lead"),
    "mxtpu_capture_total": (COUNTER, ("trigger",),
                            "on-demand live capture windows started "
                            "(trigger=signal|http|api)"),
    # ------------------------------------- serving tier (mxnet_tpu.serving)
    "mxtpu_serve_requests_total": (COUNTER, ("outcome",),
                                   "predict requests finished "
                                   "(outcome=ok|shed|error)"),
    "mxtpu_serve_shed_total": (COUNTER, ("reason",),
                               "requests refused by the load shedder "
                               "(reason=queue_full — the bounded queue "
                               "was at depth; deadline — the remaining "
                               "deadline could not cover the estimated "
                               "rung wall)"),
    "mxtpu_serve_rung_dispatch_total": (COUNTER, ("rung",),
                                        "coalesced batches dispatched "
                                        "per ladder rung (rung=batch "
                                        "size)"),
    "mxtpu_serve_request_seconds": (HISTOGRAM, ("segment",),
                                    "per-request serving latency split "
                                    "(segment=queue|pad|dispatch|"
                                    "total)"),
    "mxtpu_serve_rung_occupancy": (HISTOGRAM, ("rung",),
                                   "real-request rows divided by rung "
                                   "batch size per dispatched batch "
                                   "(1.0 = the rung left with no pad "
                                   "rows)"),
    "mxtpu_serve_queue_depth": (GAUGE, (),
                                "predict requests currently queued in "
                                "the batcher"),
    # ----------------------------------- SLO engine / alerting (slo)
    "mxtpu_alert_transitions_total": (COUNTER, ("rule", "to"),
                                      "alert state-machine transitions "
                                      "per SLO rule (to=pending|firing|"
                                      "cleared|resolved)"),
    "mxtpu_alert_state": (GAUGE, ("rule",),
                          "current alert state per SLO rule "
                          "(0=inactive 1=pending 2=firing)"),
    "mxtpu_alerts_firing": (GAUGE, ("severity",),
                            "SLO rules currently firing, by severity "
                            "(severity=warn|critical)"),
    "mxtpu_slo_burn_rate": (GAUGE, ("rule", "window"),
                            "latest error-budget burn rate per "
                            "burn_rate rule and window (window=fast|"
                            "slow; 1.0 = budget consumed exactly at "
                            "the objective's allowance)"),
    "mxtpu_health_status": (GAUGE, (),
                            "this rank's health verdict (0=healthy "
                            "1=degraded 2=critical)"),
    # ------------------------------ distributed tracing (telemetry.tracing)
    "mxtpu_traces_total": (COUNTER, ("status",),
                           "finished traces by final status "
                           "(status=ok|error|shed)"),
    "mxtpu_traces_kept_total": (COUNTER, ("reason",),
                                "traces retained by tail-sampling "
                                "(reason=error|shed|slow|sampled)"),
}

_XLA = "no eager PyTorch counterpart: XLA's compiled-program analysis"
_PLANS = ("the JAX package plans once a compile; the port plans each eager "
          "run of the graph, so a count would count runs")
_RESHARD = "elastic resharding not yet ported"

#: declared names nothing in the port emits, with the reason
NOT_EMITTED = {
    "mxtpu_memory_plan_bytes": _XLA + " (memory_analysis)",
    "mxtpu_program_flops": _XLA + " (cost_analysis)",
    "mxtpu_program_bytes_accessed": _XLA + " (cost_analysis)",
    "mxtpu_fusion_plans_total": _PLANS,
    "mxtpu_fusion_blocks_total": _PLANS,
    "mxtpu_fusion_relayouts_eliminated_total": _PLANS,
    "mxtpu_fusion_fallback_total": _PLANS,
    "mxtpu_reshard_total": _RESHARD,
    "mxtpu_reshard_params_total": _RESHARD,
    "mxtpu_reshard_bytes_total": _RESHARD,
    "mxtpu_reshard_seconds": _RESHARD,
    "mxtpu_elastic_resizes_total": _RESHARD,
}

# rung-occupancy fractions (histogram buckets): fill ratios up to full
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


def selfcheck():
    """Validate the catalog itself; returns a list of problem strings
    (empty = clean).  Checked: prometheus-legal metric and label names,
    counter ``_total``/unit suffixes, no reserved label names."""
    import re
    problems = []
    name_re = re.compile(r"^[a-z_][a-z0-9_]*$")
    for name, (kind, labels, help_) in sorted(CATALOG.items()):
        if not name_re.match(name):
            problems.append("metric %r: illegal prometheus name" % name)
        if not name.startswith("mxtpu_"):
            problems.append("metric %r: missing mxtpu_ namespace" % name)
        if kind not in (COUNTER, GAUGE, HISTOGRAM):
            problems.append("metric %r: unknown kind %r" % (name, kind))
        if kind == COUNTER and not name.endswith("_total"):
            problems.append("metric %r: counters end in _total" % name)
        if kind != COUNTER and name.endswith("_total"):
            problems.append("metric %r: _total reserved for counters"
                            % name)
        if not isinstance(labels, tuple):
            problems.append("metric %r: labelnames must be a tuple"
                            % name)
            continue
        for lbl in labels:
            if not name_re.match(lbl) or lbl.startswith("__"):
                problems.append("metric %r: illegal label %r"
                                % (name, lbl))
            if lbl in ("le", "quantile"):
                problems.append("metric %r: label %r is reserved by "
                                "histograms/summaries" % (name, lbl))
        if not help_:
            problems.append("metric %r: empty help string" % name)
    return problems
