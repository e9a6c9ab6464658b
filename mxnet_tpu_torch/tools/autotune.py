"""autotune: tune the hand-written kernels' tiles against measurements, and
fit the learned cost model on the cost database.

The counterpart of the repo's ``tools/autotune.py`` (which imports the JAX
package), for :mod:`mxnet_tpu_torch.autotune`.  Modes:

**Per-op tuning**: measure every tile of explicit keys::

    python -m mxnet_tpu_torch.tools.autotune --op flash_fwd \\
        --shapes 16x1024x16x64 --causal --dtype bfloat16
    python -m mxnet_tpu_torch.tools.autotune --op flash_bwd \\
        --shapes 4x1024x16x64 --causal
    python -m mxnet_tpu_torch.tools.autotune --op matmul_stats \\
        --shapes 25088x1024x256 --dtype bfloat16

Shapes are ``BxTxHxD`` for flash, ``MxKxN`` for matmul_stats.  Winners
commit to the tuning cache (``--cache`` or ``MXNET_TPU_TUNE_CACHE``);
every candidate's measurement lands in the cost database (``--costdb`` or
``MXNET_TPU_COSTDB``) as the cost model's training data.  Keys already
cached are skipped (a second run searches nothing) unless ``--force``.

**Zoo-model mode**: tune every tunable kernel a model's fusion plan
launches, at the shapes its training step launches them with: K5's GEMMs
and the K5-or-library A/B of each K5 block, and the flash kernels of any
attention node::

    python -m mxnet_tpu_torch.tools.autotune --model resnet50 \\
        --batch 128 --dtype bfloat16

**Cost model**: ``--fit-model OUT`` fits and saves it; ``--report`` renders
each cached key's winner against the built-in choice (never worse on the
measured run: the built-in choice is a candidate) and the model's
calibration.  ``--json`` prints one document (``mxtpu-autotune/1``).

The tuners run on the card unless ``--cpu`` asks for the CPU, where the
wrappers run their plain versions (a control-flow check, no tuning).
Exit codes: 0 ok, 1 a requested tuning or fit failed, 2 usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

#: the default flash set: the GPT's training step and its serving rungs
DEFAULT_FLASH_SHAPES = ((16, 1024, 16, 64), (4, 1024, 16, 64),
                        (1, 1024, 16, 64))


def _parse_shapes(spec, rank, what):
    out = []
    for part in spec.split(","):
        dims = tuple(int(x) for x in part.lower().split("x") if x)
        if len(dims) != rank:
            raise ValueError("%s shape %r must have %d dims (%s)"
                             % (what, part, rank,
                                "BxTxHxD" if rank == 4 else "MxKxN"))
        out.append(dims)
    return out


def _backend(args):
    return "cpu" if args.cpu else "gpu"


def _cached(args, op, shapes, dtypes, extra=None):
    from .. import autotune
    return autotune.lookup(op, shapes, dtypes, extra=extra,
                           backend=_backend(args))


def _fmt_cfg(cfg):
    if not cfg:
        return "-"
    return ",".join("%s=%s" % (k, v) for k, v in sorted(cfg.items()))


def _runner(args, say, results, skipped):
    """The one probe-cache, skip, tune and report step of both sweeps."""
    def run(label, probe, fn):
        entry = None if args.force else probe()
        if entry is not None:
            say("autotune: %-44s cached (wall %.3g ms)"
                % (label, 1e3 * (entry.get("wall_s") or 0)))
            skipped.append({"key": label, "entry": entry})
            return
        rep = fn()
        best, heur = rep["best"], rep["heuristic"]
        delta = ""
        if heur and heur["wall_s"]:
            delta = " (%+.1f%% vs heuristic %s)" % (
                100.0 * (best["wall_s"] - heur["wall_s"]) / heur["wall_s"],
                _fmt_cfg(heur["config"]))
        say("autotune: %-44s -> %s  %.3g ms%s"
            % (label, _fmt_cfg(best["config"]), 1e3 * best["wall_s"],
               delta))
        results.append(rep)
    return run


def _device(args):
    return "cpu" if args.cpu else "cuda"


def _tune_flash_keys(args, run, shapes_causal):
    from .. import autotune
    for (shp, causal) in shapes_causal:
        for which in args.which:
            op = "flash_attention_%s" % which
            label = "%s %s causal=%d" % (op, "x".join(map(str, shp)),
                                         causal)
            run(label,
                lambda shp=shp, op=op, causal=causal: _cached(
                    args, op, [shp], [args.dtype],
                    extra={"causal": bool(causal)}),
                lambda shp=shp, which=which, causal=causal:
                autotune.tune_flash(
                    shp, dtype=args.dtype, causal=causal, which=which,
                    repeats=args.repeats,
                    max_candidates=args.max_candidates,
                    device=_device(args)))


def _tune_gemms(args, run, gemms):
    from .. import autotune
    for (m, k, n) in gemms:
        label = "matmul_stats %dx%dx%d" % (m, k, n)
        run(label,
            lambda m=m, k=k, n=n: _cached(
                args, "matmul_stats", [(m, k), (k, n)],
                [args.dtype, args.dtype]),
            lambda m=m, k=k, n=n: autotune.tune_matmul_stats(
                m, k, n, dtype=args.dtype, repeats=args.repeats,
                max_candidates=args.max_candidates, device=_device(args)))


def tune_keys(args, say):
    """The requested per-op tunings: ``(results, skipped)``."""
    results, skipped = [], []
    run = _runner(args, say, results, skipped)
    if args.op in ("flash_fwd", "flash_bwd"):
        args.which = (args.op.rsplit("_", 1)[1],)
        shapes = (_parse_shapes(args.shapes, 4, "flash") if args.shapes
                  else list(DEFAULT_FLASH_SHAPES))
        _tune_flash_keys(args, run, [(s, bool(args.causal))
                                     for s in shapes])
    elif args.op == "matmul_stats":
        _tune_gemms(args, run, _parse_shapes(args.shapes, 3, "matmul"))
    return results, skipped


def model_keys(model, batch, num_classes=10, layout="NHWC"):
    """The tunable keys of a zoo model's training step at ``batch``:
    ``(gemms, blocks, flashes)``, K5's ``(M, K, N)``, the K5 blocks'
    ``(kind, act, NHWC x shape, OIHW w shape)`` and the attention nodes'
    ``((B, T, H, D), causal)``, each sorted and distinct."""
    from .. import models
    from ..analysis import fusion, infer_node_shapes

    net = models.get_model(model, num_classes=num_classes)
    data_shape = {"mlp": (batch, 784), "lenet": (batch, 1, 28, 28)}.get(
        model, (batch, 3, 224, 224))
    topo, node_shapes = infer_node_shapes(
        net, {"data": data_shape, "softmax_label": (batch,)})
    plan = fusion.plan_block_fusion(net._topo(), net._entries,
                                    layout=layout, record=False,
                                    decisions={})
    gemms, blocks, flashes = set(), set(), set()
    for blk in plan.blocks.values():
        if not blk.pallas or blk.conv is None:
            continue
        src, idx = blk.conv.inputs[0]
        in_sh = node_shapes.get(id(src))
        if not in_sh or len(in_sh) <= idx:
            continue
        nb, c, h, w = in_sh[idx]          # the reference NCHW shapes
        nout = int(blk.conv.attrs.get("num_filter"))
        gemms.add((nb * h * w, c, nout))
        blocks.add((blk.kind, blk.act, (nb, h, w, c), (nout, c, 1, 1)))
    for node in topo:
        if node.is_variable or node.op is None:
            continue
        if node.op.name in ("_contrib_FlashAttention",
                            "_contrib_RingAttention"):
            src, idx = node.inputs[0]
            sh = node_shapes.get(id(src))
            if sh and len(sh) > idx and len(sh[idx]) == 4:
                # the node's own causal attr: the key the run looks up
                flashes.add((tuple(sh[idx]),
                             bool(node.attrs.get("causal", False))))
    return sorted(gemms), sorted(blocks, key=repr), sorted(flashes)


def tune_model(args, say):
    """Zoo-model mode: ``(results, skipped)``."""
    from .. import autotune
    results, skipped = [], []
    run = _runner(args, say, results, skipped)
    gemms, blocks, flashes = model_keys(args.model, args.batch,
                                        args.num_classes, args.layout)
    if args.layout != "NHWC":
        gemms, blocks = [], []          # K5 takes NHWC blocks only
    say("autotune: model %s -> %d K5 GEMM(s), %d K5 block(s), %d "
        "attention shape(s)" % (args.model, len(gemms), len(blocks),
                                len(flashes)))
    _tune_gemms(args, run, gemms)
    for (kind, act, x_shape, w_shape) in blocks:
        label = "block:%s %s" % (kind, "x".join(map(str, x_shape)))
        run(label,
            lambda kind=kind, act=act, x_shape=x_shape, w_shape=w_shape:
            _cached(args, "block:%s" % kind, [x_shape, w_shape],
                    [args.dtype, args.dtype],
                    extra={"layout": args.layout, "act": act or ""}),
            lambda kind=kind, act=act, x_shape=x_shape, w_shape=w_shape:
            autotune.tune_conv_block(
                x_shape, w_shape, kind=kind, act=act, layout=args.layout,
                dtype=args.dtype, repeats=args.repeats,
                device=_device(args)))
    args.which = ("fwd", "bwd")
    _tune_flash_keys(args, run, flashes)
    return results, skipped


def report(args, say):
    """Each cached key's winner against the built-in choice, and the cost
    model's calibration.  Returns ``(doc, ok)``."""
    from .. import autotune
    from ..telemetry import costdb

    cache_path = args.cache or autotune.cache_dir()
    doc = {"schema": "mxtpu-autotune/1", "report": True,
           "cache": cache_path, "keys": [], "calibration": None}
    entries = []
    if cache_path and os.path.exists(cache_path):
        entries, _skipped = autotune.read_entries(cache_path)
    say("tuning cache: %d entr%s under %r"
        % (len(entries), "y" if len(entries) == 1 else "ies", cache_path))
    if entries:
        say("%-24s %-28s %10s %10s %8s" % (
            "op", "tuned config", "tuned", "heuristic", "delta"))
    regressions = 0
    for e in sorted(entries, key=lambda e: (e["op"],
                                            json.dumps(e["shapes"]))):
        tw, hw = e.get("wall_s"), e.get("heuristic_wall_s")
        delta = None
        if tw and hw:
            delta = (hw - tw) / hw
            if tw > hw * (1 + 1e-9):
                regressions += 1
        doc["keys"].append({
            "op": e["op"], "shapes": e["shapes"], "dtypes": e["dtypes"],
            "extra": e.get("extra"), "config": e["config"], "wall_s": tw,
            "heuristic_config": e.get("heuristic_config"),
            "heuristic_wall_s": hw, "delta_frac": delta,
            "source": e.get("source")})
        say("%-24s %-28s %10s %10s %8s" % (
            e["op"][:24], _fmt_cfg(e["config"])[:28],
            "%.3gms" % (tw * 1e3) if tw else "-",
            "%.3gms" % (hw * 1e3) if hw else "-",
            "%+.1f%%" % (100 * delta) if delta is not None else "-"))
    doc["tuned_never_worse"] = regressions == 0

    db = args.costdb or costdb.db_dir()
    records = []
    if db and os.path.exists(db):
        records, _sk = costdb.read_records(db)
    model = None
    if args.cost_model:
        model = autotune.load_model(args.cost_model)
    elif records:
        try:
            model = autotune.fit_cost_model(records=records)
        except ValueError as e:
            say("cost model: %s" % e)
    if model is not None and records:
        cal = model.calibration(records)
        cal.pop("rows", None)
        doc["calibration"] = cal
        say("cost model calibration: n=%d  geo err x%.2f  mae(log)=%.3f"
            % (cal["n"], cal.get("geo_err_factor", float("nan")),
               cal.get("mae_log", float("nan"))))
    return doc, regressions == 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="autotune",
        description="tune the CUDA kernels' tiles; fit or report the "
                    "learned cost model")
    ap.add_argument("--op", choices=("flash_fwd", "flash_bwd",
                                     "matmul_stats"))
    ap.add_argument("--shapes", default=None,
                    help="comma-separated BxTxHxD (flash) or MxKxN "
                         "(matmul_stats); flash defaults to the GPT's "
                         "training and serving shapes")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--model", default=None,
                    help="zoo-model mode: tune every tunable kernel this "
                         "model's training step launches")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--layout", default="NHWC")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--repeats", type=int, default=3,
                    help="min-of-N timing repeats per candidate")
    ap.add_argument("--max-candidates", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run the tuners on the CPU (the plain versions: "
                         "a control-flow check)")
    ap.add_argument("--force", action="store_true",
                    help="re-tune keys already in the cache")
    ap.add_argument("--cache", default=None,
                    help="tuning-cache directory (sets "
                         "MXNET_TPU_TUNE_CACHE for this run)")
    ap.add_argument("--costdb", default=None,
                    help="cost-database directory (sets MXNET_TPU_COSTDB "
                         "for this run)")
    ap.add_argument("--fit-model", default=None, metavar="OUT",
                    help="fit the learned cost model on the costdb "
                         "records and save it here")
    ap.add_argument("--cost-model", default=None, metavar="PATH",
                    help="this saved model for --report instead of a "
                         "fresh fit")
    ap.add_argument("--report", action="store_true",
                    help="each cached key against the built-in choice, "
                         "and the cost model's calibration")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    if not (args.op or args.model or args.fit_model or args.report):
        ap.error("nothing to do: give --op, --model, --fit-model or "
                 "--report")
    if args.op == "matmul_stats" and not args.shapes:
        ap.error("--op matmul_stats needs --shapes MxKxN")
    if (args.op or args.model) and not args.cpu:
        import torch
        if not torch.cuda.is_available():
            print("autotune: no CUDA device; the tuners measure the GPU "
                  "(--cpu runs them on the CPU)", file=sys.stderr)
            return 2

    if args.cache:
        os.environ["MXNET_TPU_TUNE_CACHE"] = args.cache
    if args.costdb:
        os.environ["MXNET_TPU_COSTDB"] = args.costdb

    say = (lambda s: None) if args.as_json \
        else (lambda s: print(s, file=sys.stderr))

    from .. import autotune
    from ..telemetry import costdb as costdb_mod
    autotune.reload_cache()

    doc = {"schema": "mxtpu-autotune/1", "tuned": 0, "cached": 0,
           "failed": 0, "keys": []}
    ok = True
    if args.op or args.model:
        try:
            if args.model:
                results, skipped = tune_model(args, say)
            else:
                results, skipped = tune_keys(args, say)
        except ValueError as e:
            print("autotune: %s" % e, file=sys.stderr)
            return 2
        doc["tuned"] = len(results)
        doc["cached"] = len(skipped)
        for rep in results:
            doc["keys"].append({
                "op": rep["op"], "shapes": rep["shapes"],
                "config": rep["best"]["config"],
                "wall_s": rep["best"]["wall_s"],
                "heuristic_config": (rep["heuristic"] or {}).get("config"),
                "heuristic_wall_s": (rep["heuristic"] or {}).get("wall_s"),
                "candidates": [{"config": c["config"],
                                "wall_s": c["wall_s"]}
                               for c in rep["candidates"]]})
        for s in skipped:
            doc["keys"].append({
                "op": s["entry"]["op"], "shapes": s["entry"]["shapes"],
                "config": s["entry"]["config"],
                "wall_s": s["entry"].get("wall_s"), "cached": True})
        # the candidates' measurements are the cost model's food
        costdb_mod.flush()

    if args.fit_model:
        try:
            model = autotune.fit_cost_model(costdb_path=args.costdb)
            model.save(args.fit_model)
            doc["model"] = {"path": args.fit_model, "stats": model.stats}
            say("cost model: fit on %d record(s), r2=%.3f -> %s"
                % (model.stats.get("n", 0),
                   model.stats.get("r2", float("nan")), args.fit_model))
        except (ValueError, OSError) as e:
            say("cost model fit FAILED: %s" % e)
            doc["model"] = {"error": str(e)}
            ok = False

    if args.report:
        rep_doc, rep_ok = report(args, say)
        doc.update(rep_doc)
        ok = ok and rep_ok

    if args.as_json:
        print(json.dumps(doc, sort_keys=True))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
