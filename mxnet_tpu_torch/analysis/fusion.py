"""Block-granularity fusion: the planner that lowers conv->BN->ReLU,
conv->BN, BN->ReLU and FullyConnected->activation chains to one region
each.

The counterpart of ``mxnet_tpu/analysis/fusion.py``, greedy plan only.
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
statistics.  The JAX module's metrics, cost database, autotune veto and
plan search are not ported.
"""
from __future__ import annotations

__all__ = ["FusedBlock", "FusionPlan", "plan_block_fusion", "apply_block",
           "last_plan_summary", "FC_FUSABLE_ACTS"]

FC_FUSABLE_ACTS = ("relu", "sigmoid", "tanh")

# summary of the most recent plan, for ShardedTrainer.fusion_summary()
_LAST_SUMMARY = None


class FusedBlock:
    """One matched chain: the member nodes and how to evaluate them."""
    __slots__ = ("kind", "terminal", "conv", "bn", "fc", "act", "pallas",
                 "layout")

    def __init__(self, kind, terminal, conv=None, bn=None, fc=None,
                 act=None, pallas=False, layout="NCHW"):
        self.kind = kind
        self.terminal = terminal      # the node whose value the region yields
        self.conv = conv
        self.bn = bn
        self.fc = fc
        self.act = act                # act_type string or None
        self.pallas = bool(pallas)    # the K5 route
        self.layout = layout

    @property
    def name(self):
        return self.terminal.name

    def interior(self):
        """Member nodes other than the terminal (skipped at eval)."""
        return [n for n in (self.conv, self.bn, self.fc)
                if n is not None and n is not self.terminal]


class FusionPlan:
    """The pass output: blocks keyed by terminal node id, the interior
    node-id skip set and the fallback records."""

    def __init__(self, layout, is_train):
        self.layout = layout
        self.is_train = bool(is_train)
        self.blocks = {}          # id(terminal) -> FusedBlock
        self.skip = set()         # interior node ids
        self.fallbacks = []       # (node_name, reason)
        self.interior_edges = 0   # layout boundaries removed in-block
        self.adjacent_edges = 0   # block-to-block boundaries in one layout

    @property
    def relayouts_eliminated(self):
        return self.interior_edges + self.adjacent_edges

    def add(self, block):
        self.blocks[id(block.terminal)] = block
        interior = block.interior()
        self.skip.update(id(n) for n in interior)
        self.interior_edges += len(interior)

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
                "fallbacks": reasons}


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


def _conv_fusable(conv, layout, plan):
    """Convolution eligibility as the head of a conv_bn* chain."""
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


def plan_block_fusion(topo, entries, layout="NCHW", is_train=True):
    """Match fusable chains over ``topo`` and return a
    :class:`FusionPlan` (the JAX package's greedy plan); its summary is
    kept for :func:`last_plan_summary`."""
    global _LAST_SUMMARY
    plan = FusionPlan(layout, is_train)
    consumers = _consumers(topo, entries)

    def conv_chain(bn, act_node, act_type):
        """Try conv->bn(->act); returns the block or None."""
        src, idx = bn.inputs[0]
        if not _is_op(src, "Convolution") or idx != 0:
            return None
        nxt = _single_consumer(consumers, src)
        if nxt is None or nxt[0] is not bn:
            plan.fallback(src, "conv_multi_consumer")
            return None
        if not _conv_fusable(src, layout, plan):
            return None
        blk = FusedBlock("conv_bn_act" if act_node is not None
                         else "conv_bn",
                         terminal=act_node if act_node is not None else bn,
                         conv=src, bn=bn, act=act_type, layout=layout)
        blk.pallas = _pallas_eligible(blk, is_train)
        return blk

    for node in topo:
        if node.is_variable:
            continue
        blk = None
        if _is_op(node, "Activation"):
            act_type = node.attrs.get("act_type", "relu")
            src, idx = node.inputs[0]
            if src.is_variable or idx != 0 or id(src) in plan.skip \
                    or id(src) in plan.blocks:
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
            # a block's members must not collide with earlier claims
            members = blk.interior() + [blk.terminal]
            if any(id(m) in plan.skip or id(m) in plan.blocks
                   for m in members):
                continue
            plan.add(blk)

    # adjacent fused regions sharing an image-layout boundary: fc_act
    # blocks neither carry an image layout out nor read one in
    image_terminal = {tid for tid, b in plan.blocks.items()
                      if b.kind != "fc_act"}
    for blk in plan.blocks.values():
        if blk.fc is not None:
            continue
        first = blk.conv or blk.bn
        if id(first.inputs[0][0]) in image_terminal:
            plan.adjacent_edges += 1

    _LAST_SUMMARY = plan.summary()
    return plan


def last_plan_summary():
    """Summary dict of the most recent plan in this process (None before
    any fused run).  See :meth:`FusionPlan.summary`."""
    return _LAST_SUMMARY


def apply_block(blk, vals, is_train):
    """Evaluate one planned block from the ``eval_graph`` value map.
    Returns ``(out, bn_node or None, [new_mm, new_mv] or None)``; the
    caller threads the BN aux updates as the unfused op would."""
    from ..ops import fused as _fused

    def val(node, slot):
        src, idx = node.inputs[slot]
        return vals[id(src)][idx]

    if blk.kind in ("conv_bn_act", "conv_bn"):
        conv, bn = blk.conv, blk.bn
        b = None if conv.attrs.get("no_bias") else val(conv, 2)
        out, new_mm, new_mv = _fused.fused_block_conv_bn_act(
            conv.attrs, bn.attrs, blk.layout, is_train, blk.act, blk.pallas,
            val(conv, 0), val(conv, 1), b, val(bn, 1), val(bn, 2),
            val(bn, 3), val(bn, 4))
        return out, bn, [new_mm, new_mv]
    if blk.kind == "bn_act":
        bn = blk.bn
        x = val(bn, 0)
        ch = 3 if (blk.layout == "NHWC" and x.dim() == 4) else 1
        out, new_mm, new_mv = _fused.fused_block_bn_act(
            bn.attrs, ch, is_train, blk.act, x, val(bn, 1), val(bn, 2),
            val(bn, 3), val(bn, 4))
        return out, bn, [new_mm, new_mv]
    if blk.kind == "fc_act":
        fc = blk.fc
        b = None if fc.attrs.get("no_bias") else val(fc, 2)
        out = _fused.fused_block_fc_act(fc.attrs, blk.act, val(fc, 0),
                                        val(fc, 1), b)
        return out, None, None
    raise ValueError("unknown fused block kind %r" % (blk.kind,))
