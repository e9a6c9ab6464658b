"""perf_top — rank the cost database's worst-MFU programs, blocks and
kernels.

The counterpart of the repo's ``tools/perf_top.py`` (which imports the JAX
package), with its ranking, table and ``mxtpu-perftop/1`` document: it
reads the ``mxtpu-costdb/1`` records a run left under ``MXNET_TPU_COSTDB``
(:mod:`mxnet_tpu_torch.telemetry.costdb`; ``tools.bench`` and any Executor
or ShardedTrainer run with sampling on write them) and prints them worst
MFU first, each with its roofline bound, arithmetic intensity, attained
fraction and tile configuration::

    python -m mxnet_tpu_torch.tools.perf_top [PATH] [--top N]
        [--kind block|kernel|program] [--min-count N] [--json] [--strict]

``PATH`` defaults to ``$MXNET_TPU_COSTDB``.  ``--suggest [--cache DIR]``
joins the worst records with the tuning cache
(:mod:`mxnet_tpu_torch.autotune.cache`, default
``$MXNET_TPU_TUNE_CACHE``): per block or kernel record ``untuned``,
``already-tuned`` or ``better-available`` with the measured delta, and per
graph ``plan-untuned`` (no ``graph_plan`` entry for its digest, mesh and
layout) or ``plan-stale`` (the run dispatched another plan than the one
committed).  Exit codes: 0 ok, 2 no readable records, or an explicit
``--cache`` that does not exist or holds no entry.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def load(path, strict=False):
    """Records from a costdb file/directory, via the canonical reader
    (schema-validated; bad lines skipped unless ``strict``)."""
    from ..telemetry import costdb
    return costdb.read_records(path, strict=strict)


def rank(records, kind=None, min_count=0):
    """Measured records (non-null mfu), worst MFU first.  ``kind``
    filters (None = blocks+kernels+programs all eligible);
    ``min_count`` drops records observed fewer times (noise guard)."""
    out = [r for r in records
           if r.get("mfu") is not None
           and (kind is None or r.get("kind") == kind)
           and (r.get("count") or 0) >= min_count]
    out.sort(key=lambda r: (r["mfu"], r.get("name", "")))
    return out


def _fmt_cfg(cfg):
    if not cfg:
        return "-"
    return ",".join("%s=%s" % (k, v) for k, v in sorted(cfg.items()))


def _fmt_num(x, unit=""):
    if x is None:
        return "-"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                          (1e3, "k")):
        if abs(x) >= scale:
            return "%.2f%s%s" % (x / scale, suffix, unit)
    return "%.3g%s" % (x, unit)


def render(ranked, top):
    """Human table, worst first."""
    lines = ["%-28s %-8s %-12s %6s  %-9s %8s %8s %9s  %s"
             % ("name", "kind", "block_kind", "mfu%", "bound",
                "ai", "flops", "wall", "block config")]
    for r in ranked[:top]:
        lines.append(
            "%-28s %-8s %-12s %6.2f  %-9s %8s %8s %9s  %s"
            % (r["name"][:28], r["kind"],
               str(r.get("block_kind") or "-")[:12],
               100.0 * r["mfu"], r.get("bound") or "-",
               _fmt_num(r.get("ai")), _fmt_num(r.get("flops")),
               _fmt_num(r.get("wall_s"), "s"),
               _fmt_cfg(r.get("block_config"))))
    return "\n".join(lines)


def _cache_entries(cache_path):
    """Tuning-cache entries for --suggest.  An explicit ``--cache`` that
    does not exist or holds no readable entry raises ValueError (a usage
    error); ``$MXNET_TPU_TUNE_CACHE`` not there yet reads as nothing tuned
    (with a note on stderr); no path at all gives []."""
    from .. import autotune
    explicit = bool(cache_path)
    path = cache_path or os.environ.get("MXNET_TPU_TUNE_CACHE")
    if not path:
        return []
    if not os.path.exists(path):
        if explicit:
            raise ValueError("--suggest cache %r does not exist" % path)
        print("perf_top: note: MXNET_TPU_TUNE_CACHE=%r does not exist "
              "yet (nothing tuned) — every row reads untuned" % path,
              file=sys.stderr)
        return []
    entries, skipped = autotune.read_entries(path)
    if not entries and explicit:
        raise ValueError(
            "--suggest cache %r holds no readable mxtpu-tunecache/1 "
            "entry%s" % (path,
                         " (%d corrupt/foreign line(s) skipped)"
                         % skipped if skipped else ""))
    return entries


def _match_entry(rec, entries):
    """The tuning-cache entry for a costdb block or kernel record's key:
    op name, shapes and dtypes must agree (a block record matches its
    ``block:<kind>`` key by its traced shapes)."""
    name = str(rec.get("name"))
    shapes = json.dumps(rec.get("shapes") or [])
    dtypes = json.dumps([str(d) for d in (rec.get("dtypes") or [])])
    want_ops = {name}
    if rec.get("kind") == "block" and rec.get("block_kind"):
        want_ops.add("block:%s" % rec["block_kind"])
    for e in entries:
        if e["op"] in want_ops \
                and json.dumps(e.get("shapes") or []) == shapes \
                and json.dumps([str(d) for d in
                                (e.get("dtypes") or [])]) == dtypes:
            return e
    return None


def _plan_rows(ranked, entries):
    """One ``plan`` row per graph that owns worst-MFU block records but
    whose ``graph_plan`` entry (keyed by digest, mesh and layout) is missing
    (``plan-untuned``) or names another plan than the run dispatched
    (``plan-stale``); each carries the graph's worst block."""
    plan_entries = [e for e in entries if e.get("op") == "graph_plan"
                    and isinstance(e.get("extra"), dict)]

    def entry_for(rec):
        graph = rec.get("graph")
        mesh = json.dumps(rec.get("mesh"), sort_keys=True)
        layout = rec.get("layout")
        for e in plan_entries:
            if e["extra"].get("graph") != graph:
                continue
            if json.dumps(e.get("mesh"), sort_keys=True) != mesh:
                continue
            if layout and e["extra"].get("layout") not in (None, layout):
                continue
            return e
        return None

    rows, seen = [], set()
    for r in ranked:
        graph = r.get("graph")
        if r.get("kind") != "block" or not graph:
            continue
        key = (graph, json.dumps(r.get("mesh"), sort_keys=True),
               r.get("layout"))
        if key in seen:
            continue
        seen.add(key)
        e = entry_for(r)
        if e is None:
            rows.append({
                "kind": "plan", "name": graph, "mfu": r["mfu"],
                "worst_block": r["name"], "status": "plan-untuned",
                "hint": "no graph_plan entry for this graph/mesh — "
                        "tools.plan_search can search it"})
            continue
        committed = (e.get("config") or {}).get("plan_id")
        dispatched = r.get("plan")
        if dispatched and committed and dispatched != committed:
            rows.append({
                "kind": "plan", "name": graph, "mfu": r["mfu"],
                "worst_block": r["name"], "status": "plan-stale",
                "committed_plan": committed,
                "dispatched_plan": dispatched,
                "hint": "run dispatched %s but the cache commits %s — "
                        "re-run with the cache armed or re-search"
                        % (dispatched, committed)})
    return rows


def suggest(ranked, entries):
    """For each worst-MFU block or kernel record: does the tuning cache
    hold a config for its key, and what did it measure against the built-in
    choice?  One row a record, after the graph-level ``plan`` rows
    (:func:`_plan_rows`)."""
    from ..autotune import same_config
    rows = _plan_rows(ranked, entries)
    for r in ranked:
        if r.get("kind") not in ("block", "kernel"):
            continue
        e = _match_entry(r, entries)
        if e is None:
            rows.append({"name": r["name"], "kind": r["kind"],
                         "mfu": r["mfu"],
                         "current_config": r.get("block_config"),
                         "status": "untuned",
                         "hint": "no cache entry for this key — "
                                 "tools.autotune can search it"})
            continue
        tw, hw = e.get("wall_s"), e.get("heuristic_wall_s")
        delta = (hw - tw) / hw if (tw and hw) else None
        same = same_config(r.get("block_config"), e.get("config"))
        rows.append({
            "name": r["name"], "kind": r["kind"], "mfu": r["mfu"],
            "current_config": r.get("block_config"),
            "tuned_config": e.get("config"),
            "tuned_wall_s": tw, "heuristic_wall_s": hw,
            "expected_delta_frac": delta,
            "status": "already-tuned" if same else "better-available",
        })
    return rows


def render_suggestions(rows):
    lines = ["", "tuning suggestions (cache vs dispatched config):",
             "%-28s %-8s %6s  %-16s %-24s %-24s %s"
             % ("name", "kind", "mfu%", "status", "current", "tuned",
                "expected")]
    for r in rows:
        exp = "-"
        if r.get("expected_delta_frac") is not None:
            exp = "%+.1f%% vs heuristic" \
                % (100.0 * r["expected_delta_frac"])
        elif r.get("hint"):
            exp = r["hint"]
        current = _fmt_cfg(r.get("current_config"))
        if r["kind"] == "plan":
            current = "worst: %s" % r.get("worst_block")
        lines.append("%-28s %-8s %6.2f  %-16s %-24s %-24s %s"
                     % (r["name"][:28], r["kind"],
                        100.0 * r["mfu"], r["status"],
                        current[:24],
                        _fmt_cfg(r.get("tuned_config"))[:24], exp))
    return "\n".join(lines)


def _doc(ranked, records, skipped, top):
    """The --json document: worst-first entries + the headline worst
    block (fusion blocks that underperform their roofline are exactly
    the entries with attained_frac < 1, worst MFU first)."""
    worst_block = next((r for r in ranked
                        if r.get("kind") in ("block", "kernel")), None)
    return {
        "schema": "mxtpu-perftop/1",
        "records": len(records),
        "measured": len(ranked),
        "skipped": skipped,
        "worst": None if worst_block is None else {
            "name": worst_block["name"],
            "kind": worst_block["kind"],
            "block_kind": worst_block.get("block_kind"),
            "mfu": worst_block["mfu"],
            "bound": worst_block.get("bound"),
            "attained_frac": worst_block.get("attained_frac"),
            "block_config": worst_block.get("block_config"),
            "program": worst_block.get("program"),
        },
        "entries": ranked[:top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="perf_top",
        description="rank costdb records, worst MFU first")
    ap.add_argument("path", nargs="?",
                    default=os.environ.get("MXNET_TPU_COSTDB"),
                    help="costdb-*.jsonl file or directory "
                         "(default: $MXNET_TPU_COSTDB)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--kind", choices=("block", "kernel", "program"),
                    default=None,
                    help="restrict to one record kind (default: all)")
    ap.add_argument("--min-count", type=int, default=0,
                    help="drop records measured fewer than N times")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any malformed record")
    ap.add_argument("--suggest", action="store_true",
                    help="join against the tuning cache: per worst-MFU "
                         "block, is a better-measured config cached "
                         "for its key, and what delta did it measure")
    ap.add_argument("--cache", default=None,
                    help="tuning-cache path for --suggest (default: "
                         "$MXNET_TPU_TUNE_CACHE)")
    args = ap.parse_args(argv)

    if not args.path:
        print("perf_top: no PATH and MXNET_TPU_COSTDB is unset",
              file=sys.stderr)
        return 2
    if not os.path.exists(args.path):
        print("perf_top: %r does not exist" % args.path,
              file=sys.stderr)
        return 2
    try:
        records, skipped = load(args.path, strict=args.strict)
    except ValueError as e:
        print("perf_top: %s" % e, file=sys.stderr)
        return 2
    if not records:
        print("perf_top: no costdb records under %r" % args.path,
              file=sys.stderr)
        return 2
    ranked = rank(records, kind=args.kind, min_count=args.min_count)
    sugg = None
    if args.suggest:
        try:
            entries = _cache_entries(args.cache)
        except ValueError as e:
            print("perf_top: %s" % e, file=sys.stderr)
            return 2
        sugg = suggest(ranked[:args.top], entries)
    if args.as_json:
        doc = _doc(ranked, records, skipped, args.top)
        if sugg is not None:
            doc["suggestions"] = sugg
        print(json.dumps(doc, sort_keys=True))
        return 0
    print("costdb: %d record(s), %d measured%s"
          % (len(records), len(ranked),
             ", %d malformed line(s) skipped" % skipped if skipped
             else ""))
    if ranked:
        print(render(ranked, args.top))
        worst = ranked[0]
        print("\nworst MFU: %s (%s%s) at %.2f%% — %s-bound"
              % (worst["name"], worst["kind"],
                 "/" + worst["block_kind"] if worst.get("block_kind")
                 else "",
                 100.0 * worst["mfu"], worst.get("bound") or "un"))
    if sugg:
        print(render_suggestions(sugg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
