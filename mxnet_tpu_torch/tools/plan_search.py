"""plan_search: search a model's whole-graph fusion and layout plan, and
commit the measured winner to the tuning cache.

The counterpart of the repo's ``tools/plan_search.py`` (which imports the
JAX package), for :mod:`mxnet_tpu_torch.analysis.plansearch`: a beam search
over the per-chain fuse or split, per-region layout and per-block K5
decisions of a model's plan, scored by the learned cost model; greedy and
the best predicted candidates measured over one eager forward and backward
on the card; the winner committed as a ``graph_plan`` entry keyed by graph
digest, layout, mesh and backend, which every later ``Executor`` bind and
``ShardedTrainer`` consults.  Usage::

    python -m mxnet_tpu_torch.tools.plan_search --model resnet50 \\
        --batch 128 --num-classes 1000 --dtype bfloat16 \\
        --mesh data=1,model=1
    python -m mxnet_tpu_torch.tools.plan_search --model mlp --no-measure

``--mesh`` keys the entry by a mesh's axis sizes, as ``ShardedTrainer``
looks it up (``build_mesh``'s one-device mesh is ``data=1,model=1``);
without it the entry is the Executor's.  A graph already cached is a hit
with no search (a second run searches nothing) unless ``--force``.  The measurement runs on the card
unless ``--cpu`` asks for the CPU.  Exit codes: 0 ok, 1 the search or its
measurement failed, 2 usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse_mesh(spec):
    """``'data=8,model=2'`` -> ``{"data": 8, "model": 2}``; ValueError on
    anything else."""
    out = {}
    for part in spec.split(","):
        name, _eq, size = part.partition("=")
        if not name.strip() or not size.strip():
            raise ValueError("bad mesh axis %r" % part)
        out[name.strip()] = int(size)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="plan_search",
        description="search, measure and commit a whole-graph fusion and "
                    "layout plan")
    ap.add_argument("--model", required=True,
                    help="model-zoo entry (mxnet_tpu_torch.models)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--layout", default="NHWC", choices=("NCHW", "NHWC"),
                    help="the image layout the plan is searched (and "
                         "keyed) at")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the parameters' and data's dtype in the "
                         "measured step")
    ap.add_argument("--budget", type=int, default=None,
                    help="candidate plans the cost model scores (default "
                         "MXNET_TPU_PLAN_BUDGET or 64)")
    ap.add_argument("--beam", type=int, default=None,
                    help="beam width (default MXNET_TPU_PLAN_BEAM or 8)")
    ap.add_argument("--topk", type=int, default=3,
                    help="best predicted candidates measured (greedy is "
                         "always measured beside them)")
    ap.add_argument("--repeats", type=int, default=2,
                    help="min-of-N timing repeats per measured candidate")
    ap.add_argument("--no-measure", action="store_true",
                    help="commit the best predicted plan without "
                         "measuring")
    ap.add_argument("--cost-model", default=None, metavar="PATH",
                    help="a fitted mxtpu-costmodel/1 JSON; default: a "
                         "fresh fit on the costdb records where there are "
                         "any, else the roofline's attainable time")
    ap.add_argument("--cache", default=None,
                    help="tuning-cache directory (sets "
                         "MXNET_TPU_TUNE_CACHE for this run)")
    ap.add_argument("--costdb", default=None,
                    help="cost-database directory (sets MXNET_TPU_COSTDB "
                         "for this run)")
    ap.add_argument("--mesh", default=None,
                    help="mesh axis sizes the entry is keyed by, e.g. "
                         "'data=1,model=1' (build_mesh's one-device "
                         "mesh, as ShardedTrainer keys it); "
                         "default: unkeyed, the Executor's key")
    ap.add_argument("--cpu", action="store_true",
                    help="measure on the CPU")
    ap.add_argument("--force", action="store_true",
                    help="search a graph already in the cache again")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    if args.cache:
        os.environ["MXNET_TPU_TUNE_CACHE"] = args.cache
    if args.costdb:
        os.environ["MXNET_TPU_COSTDB"] = args.costdb
    mesh = None
    if args.mesh:
        try:
            mesh = parse_mesh(args.mesh)
        except ValueError:
            ap.error("--mesh must look like 'data=8,model=2'")
    if not args.cpu and not args.no_measure:
        import torch
        if not torch.cuda.is_available():
            print("plan_search: no CUDA device; the measurement runs on "
                  "the GPU (--cpu runs it on the CPU)", file=sys.stderr)
            return 2

    say = (lambda s: None) if args.as_json \
        else (lambda s: print(s, file=sys.stderr))

    from .. import autotune, models
    from ..analysis import plansearch
    from ..telemetry import costdb as costdb_mod
    autotune.reload_cache()

    try:
        net = models.get_model(args.model, num_classes=args.num_classes)
    except ValueError as e:
        print("plan_search: %s" % e, file=sys.stderr)
        return 2
    data_shape = {"mlp": (args.batch, 784),
                  "lenet": (args.batch, 1, 28, 28)}.get(
        args.model, (args.batch, 3, 224, 224))
    data_shapes = {"data": data_shape, "softmax_label": (args.batch,)}

    model = None
    if args.cost_model:
        try:
            model = autotune.load_model(args.cost_model)
        except (OSError, ValueError) as e:
            print("plan_search: cannot load --cost-model: %s" % e,
                  file=sys.stderr)
            return 2
    else:
        db = args.costdb or costdb_mod.db_dir()
        if db and os.path.exists(db):
            try:
                records, _sk = costdb_mod.read_records(db)
                model = autotune.fit_cost_model(records=records)
                say("plan_search: cost model fit on %d costdb record(s)"
                    % model.stats.get("n", 0))
            except ValueError as e:
                say("plan_search: no cost model (%s): the roofline's "
                    "attainable time is the objective" % e)

    doc = plansearch.search_and_commit(
        net, data_shapes, layout=args.layout, model=model,
        budget=args.budget, beam=args.beam, topk=args.topk,
        repeats=args.repeats, mesh=mesh, force=args.force,
        measure=not args.no_measure, say=say,
        device="cpu" if args.cpu else "cuda", dtype=args.dtype)
    doc["model"] = args.model
    if args.as_json:
        print(json.dumps(doc, sort_keys=True, default=repr))
    elif not doc.get("cached"):
        ab = ""
        if doc.get("wall_s") and doc.get("greedy_wall_s"):
            ab = "  (measured %+.1f%% vs greedy)" % (
                100.0 * (doc["wall_s"] - doc["greedy_wall_s"])
                / doc["greedy_wall_s"])
        say("plan_search: %s -> %s  predicted %.3g ms (greedy %.3g ms)%s"
            % (args.model, doc.get("plan_id"),
               1e3 * (doc.get("predicted_s") or 0),
               1e3 * (doc.get("greedy_predicted_s") or 0), ab))
    return 1 if doc.get("error") else 0


if __name__ == "__main__":
    sys.exit(main())
