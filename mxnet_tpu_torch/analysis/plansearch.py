"""Cost-model-guided whole-graph plan search.

The counterpart of ``mxnet_tpu/analysis/plansearch.py``.  The fusion
planner (:mod:`.fusion`) is greedy: the longest chain wins, layouts are
local, and K5 is taken wherever a block allows it.  This module searches
one decision vector over the greedy plan's chains instead:

* **search space**: per chain ``fuse``/``conv_bn``/``bn_act``/``off``
  (``fusion.CHAIN_CHOICES``), per region the layout (``NCHW``/``NHWC``,
  the boundary transposes :func:`fusion.apply_block` inserts costed at
  peak bandwidth), and per block a veto of K5.  Chains are keyed by the
  greedy terminal's topological index, so a committed vector survives
  rebuilds whose auto-generated names differ;
* **objective**: the predicted step wall of the learned cost model
  (:mod:`mxnet_tpu_torch.autotune.model`) over the analytic flops and
  bytes of each unit (the formulas ``fusion._note_block_cost`` and
  ``analysis.perf.node_cost_estimate`` note), the roofline's attainable
  time where no model predicts (:func:`predict_plan_wall`);
* **search**: a deterministic beam over single-decision moves, the greedy
  plan always seeded, so the best predicted wall is never worse than
  greedy's (:func:`search_plan`);
* **measurement**: greedy, and the best predicted candidates no worse than
  greedy, each timed over one eager forward and backward of the graph with
  its decisions active (:func:`measure_decisions`, by
  ``autotune.measure``);
* **commit**: the measured winner is a ``graph_plan`` entry in the
  ``mxtpu-tunecache/1`` cache, keyed by graph digest, layout, mesh and
  backend.  ``Executor`` and ``ShardedTrainer`` consult it at bind time
  (:func:`committed_decisions`) and plan every run by it: greedy on a
  miss, as for kernel tiles.

Command line: ``python -m mxnet_tpu_torch.tools.plan_search``.  Variables:
``MXNET_TPU_PLAN_SEARCH`` (off|cache), ``MXNET_TPU_PLAN_BUDGET``,
``MXNET_TPU_PLAN_BEAM``.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from . import fusion as _fusion

__all__ = [
    "OP", "plan_mode", "plan_budget", "plan_beam",
    "lookup_entry", "committed_decisions", "stats", "reset_stats",
    "predict_plan_wall", "chain_moves", "search_plan",
    "build_step_values", "measure_decisions", "search_and_commit",
]

#: the tuning-cache op name of a graph-level plan entry
OP = "graph_plan"

_MODES = ("off", "cache")


def plan_mode():
    """``MXNET_TPU_PLAN_SEARCH``: ``off`` (no bind-time lookup) | ``cache``
    (the default: consult the tuning cache at bind time, greedy on a miss).
    Unknown values read as ``cache``; a search is never implicit."""
    v = os.environ.get("MXNET_TPU_PLAN_SEARCH", "cache").strip().lower()
    return v if v in _MODES else "cache"


def _env_int(value, default):
    try:
        return max(1, int(value or default))
    except ValueError:
        return default


def plan_budget():
    """``MXNET_TPU_PLAN_BUDGET``: the most candidate plans the beam scores
    (default 64)."""
    return _env_int(os.environ.get("MXNET_TPU_PLAN_BUDGET", ""), 64)


def plan_beam():
    """``MXNET_TPU_PLAN_BEAM``: the beam's width (default 8)."""
    return _env_int(os.environ.get("MXNET_TPU_PLAN_BEAM", ""), 8)


# -------------------------------------------------------- cache lookup

_STATS_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}


def reset_stats():
    """Zero the bind-time hit and miss counts."""
    with _STATS_LOCK:
        _STATS.update(hits=0, misses=0)


def stats():
    """This process's bind-time plan lookups: ``{"hits", "misses"}``."""
    with _STATS_LOCK:
        return dict(_STATS)


def lookup_entry(graph, layout, mesh=None, backend=None):
    """The raw ``graph_plan`` entry for (graph digest, layout, mesh,
    backend), or None; no mode gate, no counts."""
    from .. import autotune
    return autotune.lookup(OP, [], [], mesh=mesh, backend=backend,
                           extra={"graph": str(graph),
                                  "layout": str(layout)})


def committed_decisions(topo, entries, layout, mesh=None, backend=None):
    """The bind-time consult: the committed plan's decision vector for
    this graph (``{}`` when the committed winner is the greedy plan), or
    None on a miss or with ``MXNET_TPU_PLAN_SEARCH=off``; the caller plans
    greedily on None.  Counts ``mxtpu_plan_cache_{hit,miss}_total`` and
    writes a ``plan_lookup`` flight event with the digest and the plan's
    identity."""
    if plan_mode() == "off":
        return None
    from ..telemetry import counter, flight
    graph = _fusion.graph_digest(topo, entries)
    entry = lookup_entry(graph, layout, mesh=mesh, backend=backend)
    hit = entry is not None
    decisions = None
    if hit:
        decisions = (entry.get("config") or {}).get("decisions")
        decisions = dict(decisions) if isinstance(decisions, dict) else {}
    with _STATS_LOCK:
        _STATS["hits" if hit else "misses"] += 1
    counter("mxtpu_plan_cache_hit_total" if hit
            else "mxtpu_plan_cache_miss_total").inc()
    flight.record("plan_lookup", graph=graph, layout=str(layout), hit=hit,
                  plan=_fusion.decisions_id(decisions) if hit else None)
    return decisions


# --------------------------------------------------------- the objective

def _size(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _out_shape(node_shapes, node, idx=0):
    sh = node_shapes.get(id(node))
    if not sh or len(sh) <= idx:
        return None
    return tuple(int(d) for d in sh[idx])


def _in_shape(node_shapes, node, slot):
    src, idx = node.inputs[slot]
    return _out_shape(node_shapes, src, idx)


def _block_cost(blk, node_shapes, itemsize=4):
    """Analytic ``(flops, bytes)`` of one fused block from the inferred
    shapes (the formulas of ``fusion._note_block_cost``); a K5 block saves
    the separate statistics pass over its output, one output read.  None
    when a shape is unresolved."""
    out = _out_shape(node_shapes, blk.terminal)
    if out is None:
        return None
    out_size = _size(out)
    if blk.kind == "bn_act":
        x = _in_shape(node_shapes, blk.bn, 0)
        if x is None:
            return None
        return (10.0 * out_size, float(itemsize) * (_size(x) + out_size))
    head = blk.conv if blk.conv is not None else blk.fc
    x = _in_shape(node_shapes, head, 0)
    w = _in_shape(node_shapes, head, 1)
    if x is None or w is None:
        return None
    n_out = int(head.attrs.get("num_filter")
                or head.attrs.get("num_hidden") or w[0])
    flops = 2.0 * out_size * _size(w) / max(1, n_out) + 10.0 * out_size
    bytes_ = float(itemsize) * (_size(x) + _size(w) + out_size)
    if blk.pallas:
        bytes_ -= float(itemsize) * out_size
    return flops, max(bytes_, float(itemsize))


def predict_plan_wall(topo, entries, plan, node_shapes, model=None,
                      backend=None):
    """Predicted step wall of one plan: the cost model's prediction (the
    roofline's attainable time where ``model`` is None or does not
    predict) summed over every fused block and every unfused node the
    analytic estimator models, plus the boundary transposes of regions in
    the other layout at peak bandwidth.  Returns ``(total_s, units)``, a
    unit dict per costed block or node."""
    from ..telemetry import costdb
    from .perf import node_cost_estimate

    backend = backend or costdb.backend_name()
    pf = costdb.peak_flops(backend)
    pbw = costdb.peak_bandwidth(backend)
    units = []
    total = 0.0

    def predicted(flops, bytes_):
        att = costdb._attainable_s(flops, bytes_ or None, pf, pbw)
        pred = None
        if model is not None:
            pred = model.predict(flops=flops, bytes_accessed=bytes_,
                                 backend=backend)
        return (pred if pred is not None else att), att

    for node in topo:
        if node.is_variable or node.op is None or id(node) in plan.skip:
            continue
        blk = plan.blocks.get(id(node))
        if blk is not None:
            cost = _block_cost(blk, node_shapes)
            if cost is None:
                continue
            flops, bytes_ = cost
            pred, att = predicted(flops, bytes_)
            relayout_s = 0.0
            if blk.kind != "fc_act" and blk.layout != plan.layout:
                x = _in_shape(node_shapes, blk.conv or blk.bn, 0)
                out = _out_shape(node_shapes, blk.terminal)
                # apply_block transposes 4-d image activations only
                if x is not None and out is not None and pbw > 0 \
                        and len(x) == 4 and len(out) == 4:
                    # one transpose in, one out: each read and written
                    relayout_s = 2.0 * 4.0 * (_size(x) + _size(out)) / pbw
            if pred is not None:
                total += pred + relayout_s
                units.append({
                    "unit": "block", "name": blk.name, "kind": blk.kind,
                    "chain": blk.chain, "layout": blk.layout,
                    "pallas": bool(blk.pallas), "flops": flops,
                    "bytes": bytes_, "attainable_s": att,
                    "predicted_s": pred, "relayout_s": relayout_s})
            continue
        sh = node_shapes.get(id(node))
        out_shapes = [tuple(int(d) for d in s) for s in sh] if sh else []
        in_shapes = []
        for slot in range(len(node.inputs)):
            s = _in_shape(node_shapes, node, slot)
            if s is None:
                in_shapes = None
                break
            in_shapes.append(s)
        if in_shapes is None or not out_shapes:
            continue
        est = node_cost_estimate(node, in_shapes, out_shapes)
        if est is None:
            if node.op.name != "Activation":
                continue
            # an activation a split or off decision leaves outside a
            # region: one more elementwise pass over it, the traffic that
            # fusing it into an epilogue saves
            out_size = _size(out_shapes[0])
            est = (float(out_size), 8.0 * out_size)
        flops, bytes_ = est
        pred, att = predicted(flops, bytes_)
        if pred is not None:
            total += pred
            units.append({
                "unit": "node", "name": node.name, "kind": node.op.name,
                "chain": None, "layout": None, "pallas": False,
                "flops": flops, "bytes": bytes_, "attainable_s": att,
                "predicted_s": pred, "relayout_s": 0.0})
    return total, units


# --------------------------------------------------------------- search

def chain_moves(topo, entries, layout, is_train=True, node_shapes=None):
    """The single-decision moves of this graph's search space, from the
    greedy plan: per chain its other ``CHAIN_CHOICES``, a layout flip for
    an image chain (with ``node_shapes``, only where the activation is
    4-d), a K5 veto where greedy takes K5.  Returns ``(greedy_plan,
    moves)``, each move a ``(category, chain_id, value)`` triple."""
    greedy = _fusion.plan_block_fusion(topo, entries, layout=layout,
                                       is_train=is_train, record=False,
                                       decisions={})
    moves = []
    other = "NCHW" if layout == "NHWC" else "NHWC"
    for blk in greedy.blocks.values():
        cid = blk.chain
        for choice in _fusion.CHAIN_CHOICES.get(blk.kind, ()):
            if choice != "fuse":
                moves.append(("chains", cid, choice))
        if blk.kind != "fc_act":
            x = None
            if node_shapes is not None:
                x = _in_shape(node_shapes, blk.conv or blk.bn, 0)
            if node_shapes is None or (x is not None and len(x) == 4):
                moves.append(("layouts", cid, other))
        if blk.pallas:
            moves.append(("pallas", cid, 0))
    return greedy, moves


def _with_move(decisions, cat, cid, val):
    """The vector with one move applied (the same value again takes it
    back off: the beam can retreat toward greedy)."""
    nd = {k: dict(v) for k, v in decisions.items()}
    if nd.get(cat, {}).get(cid) == val:
        del nd[cat][cid]
        if not nd[cat]:
            del nd[cat]
    else:
        nd.setdefault(cat, {})[cid] = val
    return nd


def _canon(decisions):
    return json.dumps(decisions, sort_keys=True)


def search_plan(topo, entries, layout="NHWC", is_train=True,
                node_shapes=None, model=None, budget=None, beam=None,
                backend=None):
    """Beam search over the plan decisions, scored by
    :func:`predict_plan_wall`, the greedy plan (the empty vector) always
    seeded.  Returns the candidates, best predicted first:
    ``{"decisions", "plan_id", "predicted_s", "blocks", "units"}``."""
    if node_shapes is None:
        raise ValueError("search_plan needs node_shapes (use "
                         "analysis.infer_node_shapes)")
    budget = int(budget or plan_budget())
    beam = int(beam or plan_beam())
    _greedy, moves = chain_moves(topo, entries, layout, is_train=is_train,
                                 node_shapes=node_shapes)
    evaluated = {}

    def score(decisions):
        key = _canon(decisions)
        if key not in evaluated:
            plan = _fusion.plan_block_fusion(
                topo, entries, layout=layout, is_train=is_train,
                record=False, decisions=dict(decisions))
            total, units = predict_plan_wall(topo, entries, plan,
                                             node_shapes, model=model,
                                             backend=backend)
            evaluated[key] = {"decisions": decisions,
                              "plan_id": _fusion.decisions_id(decisions),
                              "predicted_s": total,
                              "blocks": len(plan.blocks), "units": units}
        return evaluated[key]

    score({})
    frontier = [{}]
    while len(evaluated) < budget and moves:
        fresh = []
        for d in frontier:
            for (cat, cid, val) in moves:
                nd = _with_move(d, cat, cid, val)
                if _canon(nd) not in evaluated:
                    fresh.append(nd)
                    score(nd)
                    if len(evaluated) >= budget:
                        break
            if len(evaluated) >= budget:
                break
        if not fresh:
            break
        ranked = sorted(evaluated.values(),
                        key=lambda r: (r["predicted_s"], r["plan_id"]))
        new_frontier = [r["decisions"] for r in ranked[:beam]]
        if [_canon(d) for d in new_frontier] == \
                [_canon(d) for d in frontier]:
            break
        frontier = new_frontier
    return sorted(evaluated.values(),
                  key=lambda r: (r["predicted_s"], r["plan_id"]))


# ---------------------------------------------------------- measurement

def build_step_values(symbol, data_shapes, layout="NHWC", seed=0):
    """Seeded argument and aux values (numpy, f32) for measuring a training
    step of ``symbol`` at ``data_shapes`` (reference NCHW shapes; a 4-d data
    input is transposed to NHWC when ``layout`` asks, as the trainer takes
    it in), the JAX package's draws.  Returns ``(arg_nodes, aux_nodes,
    vals)``, ``vals`` the args then the aux."""
    from ..symbol import _classify_vars

    topo = symbol._topo()
    arg_nodes, aux_nodes = _classify_vars(topo)
    arg_shapes, _out, aux_shapes = symbol.infer_shape(**data_shapes)
    rng = np.random.RandomState(seed)
    vals = []
    for node, shape in zip(arg_nodes, arg_shapes):
        name = node.name
        if name in data_shapes and "label" in name:
            v = rng.randint(0, 2, shape).astype(np.float32)
        elif name in data_shapes:
            v = rng.uniform(-1, 1, shape).astype(np.float32)
            if layout == "NHWC" and len(shape) == 4:
                v = np.transpose(v, (0, 2, 3, 1)).copy()
        elif "gamma" in name or "var" in name:
            v = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            v = (rng.uniform(-0.5, 0.5, shape) * 0.2).astype(np.float32)
        vals.append(v)
    # moving mean 0 and variance 1 keep the BatchNorm numerics tame
    for node, shape in zip(aux_nodes, aux_shapes):
        vals.append(np.ones(shape, np.float32) if "var" in node.name
                    else np.zeros(shape, np.float32))
    return arg_nodes, aux_nodes, vals


def _step_fn(symbol, data_names, decisions, layout, values, device, dtype):
    """One eager forward and backward of ``symbol`` with ``decisions``
    active, on ``values`` moved to ``device`` (floating ones in ``dtype``,
    4-d weights channels-last under NHWC, as the trainer's compute view
    holds them); the loss heads' cotangents are ones."""
    from ..ops.fused import block_fusion
    from ..ops.nn import image_layout
    from ..symbol import eval_graph

    topo, entries = symbol._topo(), symbol._entries
    arg_nodes, aux_nodes, vals = values
    nodes = list(arg_nodes) + list(aux_nodes)
    n_args = len(arg_nodes)
    tensors = []
    for i, (node, v) in enumerate(zip(nodes, vals)):
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if i < n_args and "label" not in node.name:
            t = t.to(dtype)
            if layout == "NHWC" and t.dim() == 4 and device.type == "cuda" \
                    and node.name not in data_names:
                t = t.contiguous(memory_format=torch.channels_last)
            t.requires_grad_(True)
        tensors.append(t)
    leaves = [t for t in tensors if t.requires_grad]
    head_is_loss = [bool(n.op is not None and n.op.is_loss)
                    for (n, _i) in entries]
    var_values = {id(n): t for n, t in zip(nodes, tensors)}
    batch = tensors[0].shape[0] if tensors and tensors[0].dim() else None
    decisions = dict(decisions) if decisions else {}

    def step():
        with image_layout(layout), block_fusion(True), \
                _fusion.plan_decisions(decisions):
            heads, _aux = eval_graph(topo, entries, var_values,
                                     is_train=True, device=device,
                                     batch_size=batch)
        outs = [h for h, il in zip(heads, head_is_loss) if il]
        grads = torch.autograd.grad(outs, leaves,
                                    [torch.ones_like(h) for h in outs],
                                    allow_unused=True)
        return heads, grads

    return step


def measure_decisions(symbol, data_shapes, decisions, layout="NHWC",
                      repeats=2, seed=0, values=None, device=None,
                      dtype="float32"):
    """Measured wall seconds of one eager forward and backward training
    step of ``symbol`` with ``decisions`` active, by ``autotune.measure``
    (synchronized, min of ``repeats``, the first call untimed).
    ``values``: :func:`build_step_values`' output, so that every candidate
    measures on the same inputs.  ``device``: the card unless the caller
    asks for the CPU; ``dtype``: the parameters' and data's."""
    from .. import autotune
    device = torch.device(device if device is not None else "cuda")
    if values is None:
        values = build_step_values(symbol, data_shapes, layout=layout,
                                   seed=seed)
    step = _step_fn(symbol, set(data_shapes), decisions, layout, values,
                    device,
                    {"float32": torch.float32,
                     "bfloat16": torch.bfloat16}[str(dtype)])
    return autotune.measure(step, (), repeats=repeats)


# ----------------------------------------------------- search and commit

def search_and_commit(symbol, data_shapes, layout="NHWC", model=None,
                      budget=None, beam=None, topk=3, repeats=2,
                      mesh=None, commit=True, cache=None, force=False,
                      measure=True, node_shapes=None, say=None,
                      device=None, dtype="float32"):
    """Search, measure greedy and the ``topk`` best predicted candidates
    (those predicted no worse than greedy: a plan predicted worse is never
    committed, so measuring one is wasted), commit the measured winner to
    the tuning cache keyed by (graph digest, layout, mesh, backend).  An
    entry already there short-circuits everything unless ``force``.
    Returns the report (``mxtpu-plansearch/1``)."""
    from .. import autotune
    from ..telemetry import costdb
    from .verifier import infer_node_shapes

    say = say or (lambda s: None)
    device = torch.device(device if device is not None else "cuda")
    backend = costdb.backend_name(device)
    topo, entries = symbol._topo(), symbol._entries
    graph = _fusion.graph_digest(topo, entries)
    doc = {"schema": "mxtpu-plansearch/1", "graph": graph,
           "layout": layout, "mesh": dict(mesh) if mesh else None,
           "backend": backend, "cached": False, "searched": 0,
           "measured": 0}
    extra = {"graph": graph, "layout": str(layout)}
    if cache is not None:
        existing = cache.lookup(OP, [], [], mesh=mesh, backend=backend,
                                extra=extra)
    else:
        existing = lookup_entry(graph, layout, mesh=mesh, backend=backend)
    if existing is not None and not force:
        cfg = existing.get("config") or {}
        say("plan_search: graph %s cached (plan %s, wall %.3g ms)"
            % (graph, cfg.get("plan_id"),
               1e3 * (existing.get("wall_s") or 0)))
        doc.update(cached=True, entry=existing, plan_id=cfg.get("plan_id"),
                   predicted_s=cfg.get("predicted_s"),
                   greedy_predicted_s=cfg.get("greedy_predicted_s"),
                   wall_s=existing.get("wall_s"),
                   greedy_wall_s=existing.get("heuristic_wall_s"))
        return doc

    if node_shapes is None:
        _topo2, node_shapes = infer_node_shapes(symbol, data_shapes)
    ranked = search_plan(topo, entries, layout=layout,
                         node_shapes=node_shapes, model=model,
                         budget=budget, beam=beam, backend=backend)
    doc["searched"] = len(ranked)
    greedy = next(r for r in ranked if not r["decisions"])
    best_pred = ranked[0]
    say("plan_search: graph %s: %d candidate(s) scored; greedy predicted "
        "%.3g ms, best predicted %.3g ms (%s)"
        % (graph, len(ranked), 1e3 * greedy["predicted_s"],
           1e3 * best_pred["predicted_s"], best_pred["plan_id"]))
    bar = greedy["predicted_s"] * (1.0 + 1e-9)
    candidates, seen = [], set()
    for r in [greedy] + [r for r in ranked[:max(1, int(topk))]
                         if r["predicted_s"] <= bar]:
        key = _canon(r["decisions"])
        if key not in seen:
            seen.add(key)
            candidates.append(r)

    greedy_wall = None
    if measure:
        values = build_step_values(symbol, data_shapes, layout=layout)
        measured = []
        for r in candidates:
            wall = measure_decisions(symbol, data_shapes, r["decisions"],
                                     layout=layout, repeats=repeats,
                                     values=values, device=device,
                                     dtype=dtype)
            say("plan_search:   %-14s predicted %.3g ms measured %.3g ms"
                % (r["plan_id"], 1e3 * r["predicted_s"], 1e3 * wall))
            measured.append(dict(r, wall_s=wall))
        doc["measured"] = len(measured)
        greedy_wall = next(m for m in measured
                           if not m["decisions"])["wall_s"]
        winner = min(measured, key=lambda m: m["wall_s"])
        doc["candidates"] = [
            {k: m[k] for k in ("plan_id", "predicted_s", "wall_s")}
            for m in measured]
    else:
        winner = dict(best_pred, wall_s=None)

    doc.update(plan_id=winner["plan_id"], predicted_s=winner["predicted_s"],
               greedy_predicted_s=greedy["predicted_s"],
               wall_s=winner.get("wall_s"), greedy_wall_s=greedy_wall)
    if commit:
        c = cache if cache is not None else autotune.CACHE
        entry = c.put(
            OP, [], [],
            config={"decisions": winner["decisions"],
                    "plan_id": winner["plan_id"],
                    "predicted_s": winner["predicted_s"],
                    "greedy_predicted_s": greedy["predicted_s"]},
            wall_s=winner.get("wall_s"), mesh=mesh, backend=backend,
            extra=extra,
            heuristic_config={"decisions": {}, "plan_id": "greedy"},
            heuristic_wall_s=greedy_wall,
            candidates=doc.get("measured") or doc["searched"],
            source="plan-search")
        doc["entry"] = entry
        say("plan_search: committed %s for graph %s (measured %.3g ms%s)"
            % (winner["plan_id"], graph, 1e3 * (winner.get("wall_s") or 0),
               ", greedy %.3g ms" % (1e3 * greedy_wall)
               if greedy_wall else ""))
    return doc
