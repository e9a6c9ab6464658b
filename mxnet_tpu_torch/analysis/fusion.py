"""Block-granularity fusion: the planner that lowers conv->BN->ReLU,
conv->BN, BN->ReLU and FullyConnected->activation chains to one region
each, and the plan search's decision vector.

The counterpart of ``mxnet_tpu/analysis/fusion.py``.
:func:`plan_block_fusion` pattern-matches the chains over a Symbol DAG in
topological order; :func:`mxnet_tpu_torch.symbol.eval_graph` skips their
interior nodes and evaluates each block at its terminal node through
:func:`apply_block`, which calls the regions of
:mod:`mxnet_tpu_torch.ops.fused` (each an ``autograd.Function`` with a
hand-written backward).

=============  =====================================================
kind           pattern (every interior node single-consumer)
=============  =====================================================
conv_bn_act    Convolution(2-d) -> BatchNorm -> Activation(relu)
conv_bn        Convolution(2-d) -> BatchNorm (no relu consumer)
bn_act         BatchNorm -> Activation(relu), producer not a fusable
               conv
fc_act         FullyConnected -> Activation(relu|sigmoid|tanh)
=============  =====================================================

BatchNorm nodes must use the reference channel axis (``axis=1``) and not
request ``output_mean_var``; other candidates are recorded as fallbacks
and run unfused.  ``FusedBlock.pallas`` keeps the JAX package's name for
the K5 route (``matmul_stats``): a 1x1 stride-1 conv head, NHWC, training
statistics; a committed ``{"pallas": 0}`` under the block's tuning-cache
key (:func:`_tuned_pallas`) vetoes it for that shape.

**Plan decisions** (:mod:`.plansearch`): a decision vector, active inside
:class:`plan_decisions`, changes the greedy plan per chain (keyed by the
greedy terminal's topological index): ``chains`` (``fuse``, the
``conv_bn``/``bn_act`` splits of a conv_bn_act chain, or ``off``),
``layouts`` (a region in the other image layout: :func:`apply_block`
transposes its activation in and back out) and ``pallas`` (a veto of K5).
:func:`graph_digest` is the graph's structural identity (names left out),
equal to the JAX package's for the same Symbol; :func:`decisions_id` a
decision vector's.  Inside a sampled cost-database dispatch
:func:`apply_block` notes each block with the JAX flops and bytes
estimates, the lowering that ran and the plan's identity
(:func:`_note_block_cost`).  The JAX module's ``mxtpu_fusion_*`` metrics
are not emitted: the port plans at every eager run.
"""
from __future__ import annotations

import collections
import hashlib
import json

from ..telemetry import costdb as _costdb

__all__ = ["FusedBlock", "FusionPlan", "plan_block_fusion", "apply_block",
           "last_plan_summary", "FC_FUSABLE_ACTS", "graph_digest",
           "decisions_id", "plan_decisions", "active_decisions",
           "CHAIN_CHOICES"]

FC_FUSABLE_ACTS = ("relu", "sigmoid", "tanh")

#: per chain kind, the decisions the plan search explores: "fuse" is the
#: greedy plan's; "conv_bn" and "bn_act" split a conv_bn_act chain at its
#: BatchNorm; "off" leaves the chain unfused
CHAIN_CHOICES = {
    "conv_bn_act": ("fuse", "conv_bn", "bn_act", "off"),
    "conv_bn": ("fuse", "off"),
    "bn_act": ("fuse", "off"),
    "fc_act": ("fuse", "off"),
}

# summary of the most recent plan, for ShardedTrainer.fusion_summary()
_LAST_SUMMARY = None

# the active decision vector: None is the greedy plan, a dict the vector a
# committed graph_plan entry carries.  Executor and ShardedTrainer enter
# plan_decisions around every eval_graph run, so that the forward, the
# backward and a captured forward plan alike.
_DECISIONS = {"v": None}


class plan_decisions:
    """Context manager activating a decision vector for the graphs run
    inside it (``None`` or ``{}``: the greedy plan)."""

    def __init__(self, decisions):
        self.decisions = decisions

    def __enter__(self):
        self._prev = _DECISIONS["v"]
        _DECISIONS["v"] = self.decisions
        return self

    def __exit__(self, *exc):
        _DECISIONS["v"] = self._prev
        return False


def active_decisions():
    """The decision vector :class:`plan_decisions` activated, or None."""
    return _DECISIONS["v"]


# graph_digest of recent graphs: id(topo) -> (topo, entries, digest).  The
# port plans at every eager run, and a digest is a JSON dump and a sha1 of
# the whole graph; the topo lists of an Executor or a trainer live as long
# as it does, and the entry holds them so that their ids are not reused.
_DIGESTS = collections.OrderedDict()
_DIGESTS_CAP = 32


def graph_digest(topo, entries):
    """Stable 12-hex identity of the graph's structure: op names, attrs,
    input wiring and head entries, node names left out (the JAX package's
    digest, equal for the same Symbol).  The plan search's tuning-cache
    entries are keyed by it."""
    got = _DIGESTS.get(id(topo))
    if got is not None and got[0] is topo and got[1] == list(entries):
        return got[2]
    idx = {id(n): i for i, n in enumerate(topo)}
    items = []
    for n in topo:
        if n.is_variable:
            items.append("var")
            continue
        items.append([
            n.op.name,
            sorted((str(k), repr(v)) for k, v in n.attrs.items()),
            [[idx[id(src)], int(i)] for (src, i) in n.inputs],
        ])
    items.append([[idx[id(n)], int(i)] for (n, i) in entries])
    blob = json.dumps(items, sort_keys=True, default=repr)
    digest = hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]
    _DIGESTS[id(topo)] = (topo, list(entries), digest)
    while len(_DIGESTS) > _DIGESTS_CAP:
        _DIGESTS.popitem(last=False)
    return digest


def decisions_id(decisions):
    """Short identity of a decision vector (``greedy`` for an empty or
    absent one), which cost records and flight events carry."""
    if not decisions:
        return "greedy"
    blob = json.dumps(decisions, sort_keys=True, default=repr)
    return "plan-" + hashlib.sha1(blob.encode("utf-8")).hexdigest()[:10]


class FusedBlock:
    """One matched chain: the member nodes and how to evaluate them."""
    __slots__ = ("kind", "terminal", "conv", "bn", "fc", "act", "pallas",
                 "layout", "chain", "graph", "plan_id")

    def __init__(self, kind, terminal, conv=None, bn=None, fc=None,
                 act=None, pallas=False, layout="NCHW", chain=None,
                 graph=None, plan_id=None):
        self.kind = kind
        self.terminal = terminal      # the node whose value the region yields
        self.conv = conv
        self.bn = bn
        self.fc = fc
        self.act = act                # act_type string or None
        self.pallas = bool(pallas)    # the K5 route
        self.layout = layout
        self.chain = chain            # the chain id: the greedy terminal's
        self.graph = graph            # topo index, as a string; the graph
        self.plan_id = plan_id        # digest and the plan's identity

    @property
    def name(self):
        return self.terminal.name

    def interior(self):
        """Member nodes other than the terminal (skipped at eval)."""
        return [n for n in (self.conv, self.bn, self.fc)
                if n is not None and n is not self.terminal]


class FusionPlan:
    """The pass output: blocks keyed by terminal node id, the interior
    node-id skip set, the fallback records and the layout accounting."""

    def __init__(self, layout, is_train, decisions=None, graph=None):
        self.layout = layout
        self.is_train = bool(is_train)
        self.decisions = decisions    # the plan search's vector (or None)
        self.graph = graph            # the graph digest (None: not taken)
        self.plan_id = decisions_id(decisions)
        self.blocks = {}          # id(terminal) -> FusedBlock
        self.skip = set()         # interior node ids
        self.fallbacks = []       # (node_name, reason)
        self.interior_edges = 0   # layout boundaries removed in-block
        self.adjacent_edges = 0   # block-to-block boundaries in one layout
        self.relayout_edges_added = 0  # transposes of overridden regions
        self.overrides = 0             # decisions that changed a block

    @property
    def relayouts_eliminated(self):
        return self.interior_edges + self.adjacent_edges

    def add(self, block):
        block.graph = self.graph
        block.plan_id = self.plan_id
        self.blocks[id(block.terminal)] = block
        interior = block.interior()
        self.skip.update(id(n) for n in interior)
        self.interior_edges += len(interior)
        if block.kind != "fc_act" and block.layout != self.layout:
            # a region in the other layout transposes its input in and
            # its output back (apply_block); an upper bound, since a non-4d
            # activation transposes nothing (the search offers layout
            # moves only for 4-d ones)
            self.relayout_edges_added += 2

    def fallback(self, node, reason):
        self.fallbacks.append((node.name, reason))

    def summary(self):
        kinds, reasons = {}, {}
        for blk in self.blocks.values():
            kinds[blk.kind] = kinds.get(blk.kind, 0) + 1
        for _name, reason in self.fallbacks:
            reasons[reason] = reasons.get(reason, 0) + 1
        return {"layout": self.layout, "is_train": self.is_train,
                "blocks": len(self.blocks), "kinds": kinds,
                "pallas_blocks": sum(1 for b in self.blocks.values()
                                     if b.pallas),
                "relayouts_eliminated": self.relayouts_eliminated,
                "relayout_edges_added": self.relayout_edges_added,
                "fallbacks": reasons, "graph": self.graph,
                "plan_id": self.plan_id, "searched": bool(self.decisions),
                "overrides": self.overrides}


def _consumers(topo, entries):
    """id(node) -> list of (consumer node, input slot); graph heads count
    as consumers (a head output must stay visible)."""
    out = {}
    for node in topo:
        for slot, (src, _idx) in enumerate(node.inputs):
            out.setdefault(id(src), []).append((node, slot))
    for (node, _i) in entries:
        out.setdefault(id(node), []).append((None, -1))
    return out


def _single_consumer(consumers, node):
    """The unique (consumer, slot) of ``node``, or None."""
    cs = consumers.get(id(node), ())
    if len(cs) != 1 or cs[0][0] is None:
        return None
    return cs[0]


def _is_op(node, name):
    return not node.is_variable and node.op.name == name


def _bn_fusable(bn, plan):
    """BatchNorm eligibility shared by every BN-bearing chain."""
    if bn.attrs.get("output_mean_var"):
        plan.fallback(bn, "bn_output_mean_var")
        return False
    if int(bn.attrs.get("axis", 1)) != 1:
        plan.fallback(bn, "bn_axis")
        return False
    return True


def _conv_fusable(conv, layout, plan, claimed):
    """Convolution eligibility as the head of a conv_bn* chain."""
    if id(conv) in claimed:
        plan.fallback(conv, "claimed_by_other_pass")
        return False
    if len(tuple(conv.attrs.get("kernel") or ())) != 2:
        plan.fallback(conv, "conv_ndim")
        return False
    if conv.attrs.get("layout") and conv.attrs["layout"] != layout:
        plan.fallback(conv, "conv_layout_pinned")
        return False
    return True


def _pallas_eligible(blk, is_train):
    """Whether a block takes K5: an eligible 1x1 conv head, NHWC, and
    training-mode BN statistics."""
    if blk.conv is None or blk.bn is None \
            or blk.kind not in ("conv_bn", "conv_bn_act"):
        return False
    from ..ops.fused import conv_eligible
    return bool(conv_eligible(blk.conv) and blk.layout == "NHWC"
                and is_train and not blk.bn.attrs.get("use_global_stats"))


def _apply_decision(blk, cid, decisions, plan, is_train):
    """The greedy block ``blk`` of chain ``cid`` under the decision vector:
    per-chain fuse, split or off, per-region layout, K5 veto.  Returns the
    block to plan (perhaps a shorter chain) or None (the chain unfused).
    An unknown or ineligible choice reads as "fuse": a stale vector
    degrades and never breaks a run."""
    if not decisions:
        blk.chain = cid
        return blk
    choice = str((decisions.get("chains") or {}).get(cid, "fuse"))
    if choice not in CHAIN_CHOICES.get(blk.kind, ("fuse",)):
        choice = "fuse"
    if choice == "off":
        plan.overrides += 1
        return None
    if choice == "conv_bn" and blk.kind == "conv_bn_act":
        blk = FusedBlock("conv_bn", terminal=blk.bn, conv=blk.conv,
                         bn=blk.bn, act=None, layout=blk.layout)
        # the split keeps the K5 route a conv_bn chain matched as such gets
        blk.pallas = _pallas_eligible(blk, is_train)
        plan.overrides += 1
    elif choice == "bn_act" and blk.kind == "conv_bn_act":
        blk = FusedBlock("bn_act", terminal=blk.terminal, bn=blk.bn,
                         act=blk.act, layout=blk.layout)
        plan.overrides += 1
    layout = (decisions.get("layouts") or {}).get(cid)
    if layout in ("NCHW", "NHWC") and layout != blk.layout \
            and blk.kind != "fc_act":
        blk.layout = layout
        plan.overrides += 1
        # eligibility follows the region's layout
        blk.pallas = _pallas_eligible(blk, is_train)
    veto = (decisions.get("pallas") or {}).get(cid)
    if veto is not None and not veto and blk.pallas:
        blk.pallas = False
        plan.overrides += 1
    blk.chain = cid
    return blk


def plan_block_fusion(topo, entries, layout="NCHW", is_train=True,
                      exclude=(), record=True, decisions=None):
    """Match fusable chains over ``topo`` and return a
    :class:`FusionPlan` (the JAX package's plan).  ``exclude``: node ids
    another pass claimed, whose chains fall back.  ``decisions``: the plan
    search's vector (default: the :class:`plan_decisions` context; None is
    the greedy plan).  With ``record`` the summary is kept for
    :func:`last_plan_summary` (the static analyses plan without it)."""
    global _LAST_SUMMARY
    if decisions is None:
        decisions = active_decisions()
    digest = graph_digest(topo, entries) if (record or decisions) else None
    plan = FusionPlan(layout, is_train, decisions=decisions, graph=digest)
    consumers = _consumers(topo, entries)
    claimed = set(exclude)
    topo_index = {id(n): i for i, n in enumerate(topo)}

    def conv_chain(bn, act_node, act_type):
        """Try conv->bn(->act); returns the block or None."""
        src, idx = bn.inputs[0]
        if not _is_op(src, "Convolution") or idx != 0:
            return None
        nxt = _single_consumer(consumers, src)
        if nxt is None or nxt[0] is not bn:
            plan.fallback(src, "conv_multi_consumer")
            return None
        if not _conv_fusable(src, layout, plan, claimed):
            return None
        blk = FusedBlock("conv_bn_act" if act_node is not None
                         else "conv_bn",
                         terminal=act_node if act_node is not None else bn,
                         conv=src, bn=bn, act=act_type, layout=layout)
        blk.pallas = _pallas_eligible(blk, is_train)
        return blk

    for node in topo:
        if node.is_variable or id(node) in claimed:
            continue
        blk = None
        if _is_op(node, "Activation"):
            act_type = node.attrs.get("act_type", "relu")
            src, idx = node.inputs[0]
            if src.is_variable or idx != 0 or id(src) in claimed \
                    or id(src) in plan.skip or id(src) in plan.blocks:
                continue
            one = _single_consumer(consumers, src)
            if one is None or one[0] is not node:
                continue
            if _is_op(src, "BatchNorm") and act_type == "relu":
                if not _bn_fusable(src, plan):
                    continue
                blk = conv_chain(src, node, act_type)
                if blk is None:
                    blk = FusedBlock("bn_act", terminal=node, bn=src,
                                     act=act_type, layout=layout)
            elif _is_op(src, "FullyConnected") \
                    and act_type in FC_FUSABLE_ACTS:
                blk = FusedBlock("fc_act", terminal=node, fc=src,
                                 act=act_type, layout=layout)
            elif _is_op(src, "BatchNorm"):
                plan.fallback(node, "act_type")
        elif _is_op(node, "BatchNorm"):
            if id(node) in plan.skip or id(node) in plan.blocks:
                continue
            # BN whose single consumer is a fusable relu is deferred to
            # the Activation visit above (the longer chain wins)
            one = _single_consumer(consumers, node)
            if one is not None and _is_op(one[0], "Activation") \
                    and one[0].attrs.get("act_type") == "relu" \
                    and one[1] == 0:
                continue
            if not _bn_fusable(node, plan):
                continue
            blk = conv_chain(node, None, None)
        if blk is not None:
            # the chain id is the greedy terminal's topo position, so that
            # a committed vector survives rebuilds with other auto names
            blk = _apply_decision(blk, str(topo_index[id(node)]), decisions,
                                  plan, is_train)
        if blk is not None:
            # a block's members must not collide with earlier claims
            members = blk.interior() + [blk.terminal]
            if any(id(m) in plan.skip or id(m) in plan.blocks
                   for m in members):
                continue
            plan.add(blk)

    # adjacent fused regions sharing an image-layout boundary: fc_act
    # blocks neither carry an image layout out nor read one in, and both
    # sides must sit in the ambient layout (a region in the other layout
    # round-trips through the ambient one at every boundary)
    image_terminal = {tid: b.layout for tid, b in plan.blocks.items()
                      if b.kind != "fc_act"}
    for blk in plan.blocks.values():
        if blk.fc is not None or blk.layout != plan.layout:
            continue
        first = blk.conv or blk.bn
        if image_terminal.get(id(first.inputs[0][0])) == plan.layout:
            plan.adjacent_edges += 1

    if record:
        _LAST_SUMMARY = plan.summary()
    return plan


def last_plan_summary():
    """Summary dict of the most recent plan in this process (None before
    any fused run).  See :meth:`FusionPlan.summary`."""
    return _LAST_SUMMARY


def _relayout(x, dst_layout):
    """The boundary transpose of a 4-d image activation into
    ``dst_layout`` (a region the plan put in the other layout pays two:
    ``plan.relayout_edges_added`` counts them and the plan search's
    objective costs them at peak bandwidth)."""
    if x is None or x.dim() != 4:
        return x
    return x.permute(0, 2, 3, 1) if dst_layout == "NHWC" \
        else x.permute(0, 3, 1, 2)


def apply_block(blk, vals, is_train):
    """Evaluate one planned block from the ``eval_graph`` value map.
    Returns ``(out, bn_node or None, [new_mm, new_mv] or None)``; the
    caller threads the BN aux updates as the unfused op would.  A block
    whose layout differs from the ambient image layout (a plan decision)
    transposes its activation into the region's layout and its output
    back."""
    from ..ops import fused as _fused
    from ..ops.nn import current_image_layout

    def val(node, slot):
        src, idx = node.inputs[slot]
        return vals[id(src)][idx]

    ambient = current_image_layout()
    if blk.kind in ("conv_bn_act", "conv_bn"):
        conv, bn = blk.conv, blk.bn
        b = None if conv.attrs.get("no_bias") else val(conv, 2)
        x, w = val(conv, 0), val(conv, 1)
        if blk.layout != ambient:
            x = _relayout(x, blk.layout)
        pallas = _tuned_pallas(blk, x, w)
        out, new_mm, new_mv = _fused.fused_block_conv_bn_act(
            conv.attrs, bn.attrs, blk.layout, is_train, blk.act, pallas,
            x, w, b, val(bn, 1), val(bn, 2), val(bn, 3), val(bn, 4))
        if _costdb.SAMPLING:
            _note_block_cost(blk, out, x, w, pallas=pallas)
        if blk.layout != ambient:
            out = _relayout(out, ambient)
        return out, bn, [new_mm, new_mv]
    if blk.kind == "bn_act":
        bn = blk.bn
        x = val(bn, 0)
        if blk.layout != ambient:
            x = _relayout(x, blk.layout)
        ch = 3 if (blk.layout == "NHWC" and x.dim() == 4) else 1
        out, new_mm, new_mv = _fused.fused_block_bn_act(
            bn.attrs, ch, is_train, blk.act, x, val(bn, 1), val(bn, 2),
            val(bn, 3), val(bn, 4))
        if _costdb.SAMPLING:
            _note_block_cost(blk, out, x, None)
        if blk.layout != ambient:
            out = _relayout(out, ambient)
        return out, bn, [new_mm, new_mv]
    if blk.kind == "fc_act":
        fc = blk.fc
        b = None if fc.attrs.get("no_bias") else val(fc, 2)
        x, w = val(fc, 0), val(fc, 1)
        out = _fused.fused_block_fc_act(fc.attrs, blk.act, x, w, b)
        if _costdb.SAMPLING:
            _note_block_cost(blk, out, x, w)
        return out, None, None
    raise ValueError("unknown fused block kind %r" % (blk.kind,))


def _dt(a):
    return str(a.dtype).replace("torch.", "")


def _tuned_pallas(blk, x, w):
    """The block's lowering, the tuning cache first: a committed
    ``{"pallas": 0}`` under ``block:<kind>`` at these activation and weight
    shapes (a ``tools.autotune`` A/B) turns K5 off for them.  The cache
    can veto K5, never force it onto a block that does not take it; K5's
    own tile is tuned apart, under the ``matmul_stats`` key it launches
    with."""
    if not blk.pallas:
        return False
    from .. import autotune
    cfg = autotune.block_config(
        blk.kind, [tuple(x.shape), tuple(w.shape)], [_dt(x), _dt(w)],
        extra={"layout": blk.layout, "act": blk.act or ""},
        backend=_costdb.backend_name(x.device))
    return not (cfg and not cfg.get("pallas", True))


def _note_block_cost(blk, out, x, w, pallas=None):
    """Note the applied block in the cost database with the JAX
    estimates: conv and FC share one formula, every output element
    costing ``w.numel() / n_out`` MACs plus a ~10 flop BN/activation
    epilogue, ``n_out`` from the op's attributes; ``bn_act`` is 10 flops an
    element.  Bytes: x, w and the output once each.  ``pallas``: the
    lowering that ran (default: the plan's); the plan's graph digest and
    identity annotate the record."""
    if pallas is None:
        pallas = blk.pallas

    def nbytes(a):
        return a.numel() * a.element_size()

    shapes = [tuple(x.shape)] + ([tuple(w.shape)] if w is not None else [])
    dtypes = [_dt(x)] + ([_dt(w)] if w is not None else [])
    if w is not None:
        node = blk.conv if blk.conv is not None else blk.fc
        n_out = int(node.attrs.get("num_filter")
                    or node.attrs.get("num_hidden") or w.shape[0])
        flops = 2.0 * out.numel() * w.numel() / n_out + 10.0 * out.numel()
        bytes_ = nbytes(x) + nbytes(w) + nbytes(out)
    else:
        flops = 10.0 * out.numel()
        bytes_ = nbytes(x) + nbytes(out)
    _costdb.note_block(blk.name, blk.kind, shapes, dtypes, flops=flops,
                       bytes_accessed=bytes_, layout=blk.layout,
                       pallas=pallas, graph=blk.graph, plan=blk.plan_id)
