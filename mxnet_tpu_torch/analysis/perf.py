"""MXG010: predicted-slow graph nodes, named before any op runs.

The counterpart of ``mxnet_tpu/analysis/perf.py``.  The verifier's shape
pass knows every node's input and output shapes, so each heavy node gets
an analytic flops/bytes estimate (the formulas the cost database's block
and kernel records carry), a roofline-attainable lower bound against the
costdb peak table, and a wall-time *prediction* from a fitted
:class:`mxnet_tpu_torch.autotune.CostModel`.  A node whose predicted wall
exceeds ``factor`` x its attainable time is reported as **MXG010**
(warning) with both numbers.

Opt-in: the check runs only when a cost model is supplied —
``verify_symbol(..., cost_model=...)`` or ``python -m
mxnet_tpu_torch.analysis --cost-model model.json``.  Fit and check
against the same peak table (``MXNET_TPU_PEAK_FLOPS``/``MXNET_TPU_PEAK_BW``
pin it).  :func:`node_cost_estimate` also gives the port's program
records their analytic flops and bytes (:mod:`..telemetry.costdb`).

:func:`check_predicted_plan` (the ``--plan`` mode) predicts the plan the
tuning cache commits for the graph (:mod:`.plansearch`; greedy on a
miss) instead of the default per-node lowering.
"""
from __future__ import annotations

__all__ = ["node_cost_estimate", "graph_cost", "check_predicted_slow",
           "check_predicted_plan"]

#: ops the analytic estimator covers; everything else is skipped (an
#: elementwise op's wall is noise next to the convs/GEMMs MXG010 hunts)
_HEAVY_OPS = ("Convolution", "FullyConnected", "BatchNorm",
              "_contrib_FlashAttention", "_contrib_RingAttention")


def _nbytes(shape, itemsize=4):
    n = itemsize
    for d in shape:
        n *= int(d)
    return n


def node_cost_estimate(node, in_shapes, out_shapes, itemsize=4):
    """Analytic ``(flops, bytes_accessed)`` for one op node, or None
    when the op is not modeled (the JAX formulas).  They mirror the
    costdb block and kernel estimates (``fusion._note_block_cost``, the
    kernel wrappers' notes), so the static prediction and the measured
    record describe the same quantity."""
    op = node.op.name
    if op not in _HEAVY_OPS or not in_shapes or not out_shapes:
        return None
    out = out_shapes[0]
    out_size = 1
    for d in out:
        out_size *= int(d)
    io_bytes = sum(_nbytes(s, itemsize) for s in in_shapes) \
        + _nbytes(out, itemsize)
    if op in ("Convolution", "FullyConnected"):
        if len(in_shapes) < 2:
            return None
        w = in_shapes[1]
        w_size = 1
        for d in w:
            w_size *= int(d)
        n_out = int(node.attrs.get("num_filter")
                    or node.attrs.get("num_hidden") or w[0])
        flops = 2.0 * out_size * w_size / max(1, n_out)
        return flops, float(io_bytes)
    if op == "BatchNorm":
        return 10.0 * out_size, float(io_bytes)
    # flash/ring attention over (B, T, H, D): 2 matmuls of
    # 2*T*T*D MACs each per (batch, head)
    q = in_shapes[0]
    if len(q) != 4:
        return None
    b, t, h, d = (int(x) for x in q)
    return 4.0 * b * h * t * t * d, float(io_bytes)


def graph_cost(sym, shapes, types=None, passes=1):
    """Analytic ``(flops, bytes_accessed)`` of one run of ``sym`` at the
    input ``shapes``: :func:`node_cost_estimate` summed over the modeled
    nodes (each at its outputs' itemsize, as :func:`check_predicted_slow`
    prices them), times ``passes`` (3 for a training step: the forward
    and a backward of twice its work).  The port's program records carry
    it where the JAX records carry XLA's ``cost_analysis``; run it under
    the image layout the program runs in."""
    from .verifier import Report, _shape_pass, _topo_from_entries
    topo = _topo_from_entries(sym._entries)
    _resolved, structs = _shape_pass(sym, topo, dict(shapes),
                                     dict(types or {}), Report())
    flops = bytes_ = 0.0
    for node in topo:
        if node.is_variable:
            continue
        sts = structs.get(id(node))
        if not sts:
            continue
        ins = []
        for (src, idx) in node.inputs:
            st = structs.get(id(src))
            if st is None or len(st) <= idx:
                ins = None
                break
            ins.append(tuple(st[idx].shape))
        if ins is None:
            continue
        itemsize = max(st.dtype.itemsize for st in sts)
        est = node_cost_estimate(node, ins, [tuple(st.shape) for st in sts],
                                 itemsize=itemsize)
        if est is not None:
            flops += est[0]
            bytes_ += est[1]
    return flops * passes, bytes_ * passes


def check_predicted_slow(topo, structs, cost_model, factor=3.0,
                         report=None):
    """Run MXG010 over a verified graph: for each modeled node with
    resolved shapes, predict its wall with ``cost_model`` (a
    :class:`mxnet_tpu_torch.autotune.CostModel` or saved-model path) and
    flag it when ``predicted > factor * attainable``.  Appends to ``report``
    (or a fresh one) and returns it."""
    from ..autotune import model as _model
    from ..telemetry import costdb
    from .verifier import Report

    report = report if report is not None else Report()
    model = _model.load_model(cost_model)
    factor = float(factor)
    backend = costdb.backend_name()
    pf, pbw = costdb.peak_flops(backend), costdb.peak_bandwidth(backend)

    for node in topo:
        if node.is_variable or node.op is None:
            continue
        sts = structs.get(id(node))
        if not sts:
            continue
        in_sts = []
        missing = False
        for (src, idx) in node.inputs:
            st = structs.get(id(src))
            if st is None or len(st) <= idx:
                missing = True
                break
            in_sts.append(st[idx])
        if missing:
            continue
        itemsize = max([getattr(getattr(st, "dtype", None), "itemsize",
                                4) or 4 for st in sts] or [4])
        est = node_cost_estimate(
            node, [tuple(st.shape) for st in in_sts],
            [tuple(st.shape) for st in sts], itemsize=itemsize)
        if est is None:
            continue
        flops, bytes_ = est
        attainable = costdb._attainable_s(flops, bytes_ or None, pf,
                                          pbw)
        predicted = model.predict(flops=flops, bytes_accessed=bytes_,
                                  backend=backend)
        if not attainable or not predicted:
            continue
        if predicted > factor * attainable:
            report.add(
                "MXG010", "warning",
                "cost model predicts %.3g ms against a roofline-"
                "attainable %.3g ms (%.1fx > the %.1fx budget); this "
                "node is expected to run far off the roofline — "
                "candidate for tuning (tools/autotune.py) or fusion"
                % (predicted * 1e3, attainable * 1e3,
                   predicted / attainable, factor),
                node=node.name, op=node.op.name)
    return report


def check_predicted_plan(topo, entries, structs, cost_model, factor=3.0,
                         report=None, layout="NCHW", mesh=None):
    """MXG010 ``--plan`` mode: predictions for the committed plan rather
    than the default lowering.  The graph's ``graph_plan`` tuning-cache
    entry (:mod:`.plansearch`; the greedy plan on a miss) is planned as a
    bind would plan it; every costed unit (fused blocks, unfused heavy
    nodes, the boundary transposes of regions in the other layout) is
    predicted with ``cost_model``, and units predicted above ``factor``
    times their roofline's attainable time are reported with the plan's
    identity, so that a slow prediction names the plan that owns it."""
    from ..autotune import model as _model
    from . import fusion as _fusion
    from . import plansearch as _plansearch
    from .verifier import Report

    report = report if report is not None else Report()
    model = _model.load_model(cost_model)
    factor = float(factor)
    decisions = _plansearch.committed_decisions(topo, entries, layout,
                                                mesh=mesh)
    plan = _fusion.plan_block_fusion(topo, entries, layout=layout,
                                     record=False,
                                     decisions=dict(decisions)
                                     if decisions else {})
    node_shapes = {}
    for nid, sts in structs.items():
        if sts is None:
            continue
        node_shapes[nid] = tuple(tuple(int(d) for d in st.shape)
                                 for st in sts)
    _total, units = _plansearch.predict_plan_wall(
        topo, entries, plan, node_shapes, model=model)
    source = "searched" if decisions else "greedy"
    for u in units:
        att = u["attainable_s"]
        predicted = (u["predicted_s"] or 0.0) + (u["relayout_s"] or 0.0)
        if not att or not predicted:
            continue
        if predicted > factor * att:
            report.add(
                "MXG010", "warning",
                "committed plan %s (%s): cost model predicts %.3g ms "
                "against a roofline-attainable %.3g ms (%.1fx > the "
                "%.1fx budget) for this %s — candidate for plan "
                "re-search (tools/plan_search.py) or kernel tuning"
                % (plan.plan_id, source, predicted * 1e3, att * 1e3,
                   predicted / att, factor, u["unit"]),
                node=u["name"], op=u["kind"])
    return report
