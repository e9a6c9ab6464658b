"""CLI for the static analysis layer.

Usage::

    # verify serialized symbols (the reference -symbol.json layout)
    python -m mxnet_tpu_torch.analysis graph.json [--data 32,3,224,224] \
        [--tp 8]

    # verify model-zoo entries with their canonical input shapes
    python -m mxnet_tpu_torch.analysis --model resnet50 --model mlp [--tp 8]
    python -m mxnet_tpu_torch.analysis --model all

    # MXG010 with a fitted cost model (mxtpu-costmodel/1)
    python -m mxnet_tpu_torch.analysis --model resnet50 --cost-model m.json

    # run the source linter (tools/mxlint.py rules)
    python -m mxnet_tpu_torch.analysis --lint mxnet_tpu_torch/

    # static memory-liveness pass (MXG017-021): predicted peak,
    # remat/ZeRO/donation advice, optional budget gate
    python -m mxnet_tpu_torch.analysis --model resnet50 --memory \
        [--opt-slots 2] [--mem-budget BYTES] [--mem-tol 0.6] [--eval]

    # machine-readable diagnostics (schema mxtpu-analysis/1)
    python -m mxnet_tpu_torch.analysis --model mlp --memory --json

    # registry self-check only
    python -m mxnet_tpu_torch.analysis --registry

The counterpart of ``python -m mxnet_tpu.analysis``, with its options and
output.  Not yet ported, and refused with the ROADMAP item that brings
them: ``--mesh``, ``--pipeline``, ``--microbatches``, ``--sequence`` and
``--kv-push`` (the distributed pass, Queue A item 4).  ``--plan`` predicts
the plan committed to the tuning cache (``MXNET_TPU_TUNE_CACHE``).
Everything here runs on the CPU; no op runs on a device.

Exit status 1 when any error-severity diagnostic (or lint finding) is
reported; warnings alone exit 0 unless ``--strict-warnings``.
"""
from __future__ import annotations

import argparse
import os
import sys


def _parse_shape(s):
    return tuple(int(x) for x in s.replace("(", "").replace(")", "")
                 .split(",") if x.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="static graph verifier, memory liveness and linter")
    ap.add_argument("json", nargs="*",
                    help="serialized symbol JSON files to verify")
    ap.add_argument("--model", action="append", default=[],
                    help="model-zoo entry to verify ('all' for every "
                         "model); repeatable")
    ap.add_argument("--data", default=None,
                    help="data shape for JSON graphs, e.g. 32,3,224,224")
    ap.add_argument("--label", default=None,
                    help="label shape for JSON graphs (default: batch)")
    ap.add_argument("--tp", type=int, default=1,
                    help="verify tensor-parallel sharding coverage for "
                         "this model-axis size")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size for --model verification "
                         "(default 2, rounded up to dp x microbatches "
                         "under --pipeline; an EXPLICIT value is "
                         "verified as given)")
    ap.add_argument("--registry", action="store_true",
                    help="run the op-registry self-check")
    ap.add_argument("--lint", nargs="*", metavar="PATH", default=None,
                    help="run the mxlint source linter over PATHs "
                         "(default: mxlint's own directories)")
    ap.add_argument("--strict-warnings", action="store_true",
                    help="exit 1 on warnings too")
    ap.add_argument("--cost-model", default=None, metavar="PATH",
                    help="fitted mxnet_tpu_torch.autotune cost model "
                         "(mxtpu-costmodel/1 JSON); enables MXG010 "
                         "predicted-slow node detection")
    ap.add_argument("--slow-factor", type=float, default=3.0,
                    help="MXG010 threshold: flag nodes predicted "
                         "slower than this multiple of their "
                         "roofline-attainable time (default 3.0)")
    ap.add_argument("--plan", action="store_true",
                    help="MXG010 plan mode (needs --cost-model): "
                         "predict the COMMITTED fusion/layout plan — "
                         "the graph_plan tuning-cache entry under "
                         "MXNET_TPU_TUNE_CACHE, greedy on miss — "
                         "instead of the default per-node lowering")
    ap.add_argument("--layout", default="NCHW",
                    choices=("NCHW", "NHWC"),
                    help="trace layout the --plan lookup is keyed by "
                         "(default NCHW)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="mesh descriptor 'axis=size,axis=size' (e.g. "
                         "data=2,pipe=2); enables the distributed-"
                         "correctness pass (MXG011-016)")
    ap.add_argument("--pipeline", type=int, default=1, metavar="N",
                    help="verify an N-stage pipeline partition of the "
                         "graph (needs --mesh with a pipe axis)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="pipeline microbatch count (default 2x stages)")
    ap.add_argument("--sequence", action="store_true",
                    help="verify the sequence-parallel (ring attention) "
                         "composition over --seq-axis")
    ap.add_argument("--seq-axis", default="model",
                    help="mesh axis carrying sequence shards "
                         "(default model)")
    ap.add_argument("--kv-push", action="store_true",
                    help="include the DistKVStore push collective in "
                         "the verified schedule")
    ap.add_argument("--memory", action="store_true",
                    help="run the static memory-liveness pass "
                         "(MXG017-021): predicted peak HBM with "
                         "per-category breakdown, remat/ZeRO/donation "
                         "advice, and the budget gate when one is "
                         "armed (analysis.memlive)")
    ap.add_argument("--eval", dest="mem_eval", action="store_true",
                    help="--memory models the inference schedule "
                         "instead of the default fwd+bwd+update step")
    ap.add_argument("--opt-slots", type=int, default=2, metavar="N",
                    help="--memory: float32 optimizer slots per "
                         "parameter (default 2, the Adam layout; SGD "
                         "momentum uses 1, plain SGD 0)")
    ap.add_argument("--mem-budget", type=int, default=None,
                    metavar="BYTES",
                    help="--memory: explicit MXG017 peak budget in "
                         "bytes (default: device capacity x "
                         "MXNET_TPU_MEMORY_BUDGET when known)")
    ap.add_argument("--mem-tol", type=float, default=None,
                    help="--memory: MXG018 drift tolerance override "
                         "(default MXNET_TPU_MEMLIVE_TOL)")
    ap.add_argument("--json", dest="json_out", action="store_true",
                    help="emit machine-readable diagnostics (schema "
                         "mxtpu-analysis/1) on stdout instead of text")
    args = ap.parse_args(argv)

    if args.plan and not args.cost_model:
        ap.error("--plan needs --cost-model (the MXG010 predictor)")
    if (args.pipeline > 1 or args.sequence or args.kv_push) \
            and not args.mesh:
        ap.error("--pipeline/--sequence/--kv-push need --mesh "
                 "(the distributed pass verifies against a mesh "
                 "descriptor)")
    from ..base import MXNetError
    if args.mesh or args.pipeline > 1 or args.sequence or args.kv_push \
            or args.microbatches is not None:
        raise MXNetError(
            "--mesh/--pipeline/--microbatches/--sequence/--kv-push: the "
            "distributed-correctness pass (analysis.spmd) is not yet "
            "ported to mxnet_tpu_torch (ROADMAP Queue A item 4)")

    if not (args.json or args.model or args.registry
            or args.lint is not None):
        ap.error("nothing to do: give JSON files, --model, --registry "
                 "or --lint")

    from . import (load_mxlint, registry_selfcheck, verify_json,
                   verify_model)

    mesh_axes = None
    parallel_cfg = None
    batch = args.batch if args.batch is not None else 2

    failed = warned = False
    out_doc = None
    if args.json_out:
        out_doc = {"schema": "mxtpu-analysis/1", "targets": [],
                   "registry_problems": [], "lint": []}

    def mem_opts(program):
        """check_memory options for one target (None: --memory off)."""
        if not args.memory:
            return None
        return {"is_train": not args.mem_eval,
                "n_slots": 0 if args.mem_eval else args.opt_slots,
                "mesh": mesh_axes,
                "budget_bytes": args.mem_budget,
                "advice": True, "record": True,
                "program": program}

    def mem_summary(program):
        if not args.memory:
            return None
        from ..telemetry.memory import static_prediction
        return static_prediction(program)

    def fmt_peak(info):
        from ..telemetry.memory import _fmt_bytes
        bd = ", ".join("%s=%s" % (c, _fmt_bytes(v))
                       for c, v in (info.get("breakdown") or {}).items()
                       if v)
        return ("  predicted peak %s at %s (%s)"
                % (_fmt_bytes(info.get("peak_bytes", 0)),
                   info.get("peak_node", "?"), bd or "empty"))

    if args.registry:
        problems = registry_selfcheck()
        if out_doc is not None:
            out_doc["registry_problems"] = list(problems)
        else:
            for p in problems:
                print("MXG008 [error] <registry>: %s" % p)
            print("registry selfcheck: %d problem(s)" % len(problems))
        failed = failed or bool(problems)

    models = args.model
    if "all" in models:
        from .. import models as _zoo
        models = list(_zoo._MODELS)
    for name in models:
        program = "model:%s" % name
        _net, report = verify_model(name, batch=batch,
                                    tp_size=args.tp,
                                    cost_model=args.cost_model,
                                    slow_factor=args.slow_factor,
                                    plan=args.plan,
                                    plan_layout=args.layout,
                                    mesh=mesh_axes,
                                    parallel=parallel_cfg,
                                    memory=mem_opts(program))
        info = mem_summary(program)
        if out_doc is not None:
            rec = {"target": name, "kind": "model", "ok": report.ok,
                   "diagnostics": [d.as_dict() for d in report]}
            if info:
                rec["memory"] = info
            out_doc["targets"].append(rec)
        else:
            print("model %-20s %s" % (name, report))
            if info:
                print(fmt_peak(info))
        failed = failed or not report.ok
        warned = warned or bool(report.warnings)

    for path in args.json:
        with open(path) as f:
            js = f.read()
        shapes = {}
        if args.data:
            shapes["data"] = _parse_shape(args.data)
            shapes["softmax_label"] = (_parse_shape(args.label)
                                       if args.label
                                       else (shapes["data"][0],))
        program = "graph:%s" % os.path.basename(path)
        report = verify_json(js, shapes=shapes or None, tp_size=args.tp,
                             cost_model=args.cost_model,
                             slow_factor=args.slow_factor,
                             plan=args.plan, plan_layout=args.layout,
                             mesh=mesh_axes, parallel=parallel_cfg,
                             memory=mem_opts(program))
        info = mem_summary(program)
        if out_doc is not None:
            rec = {"target": path, "kind": "json", "ok": report.ok,
                   "diagnostics": [d.as_dict() for d in report]}
            if info:
                rec["memory"] = info
            out_doc["targets"].append(rec)
        else:
            print("%s: %s" % (path, report))
            if info:
                print(fmt_peak(info))
        failed = failed or not report.ok
        warned = warned or bool(report.warnings)

    if args.lint is not None:
        mxlint = load_mxlint()
        paths = args.lint
        if not paths:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            paths = [os.path.join(root, d)
                     for d in mxlint.DEFAULT_LINT_DIRS]
        findings = mxlint.lint_paths(paths)
        if out_doc is not None:
            out_doc["lint"] = [
                {"path": f.path, "line": f.line, "rule": f.rule,
                 "message": f.message} for f in findings]
        else:
            for f in findings:
                print(f)
            print("mxlint: %d finding(s)" % len(findings))
        failed = failed or bool(findings)

    code = 1 if (failed or (warned and args.strict_warnings)) else 0
    if out_doc is not None:
        import json as _json
        out_doc["ok"] = code == 0
        print(_json.dumps(out_doc, indent=2, sort_keys=False,
                          default=str))
    return code


if __name__ == "__main__":
    sys.exit(main())
