"""Static graph verifier: pre-dispatch defect detection for Symbol graphs.

The counterpart of ``mxnet_tpu/analysis/verifier.py``: the same rules,
severities, node attribution and entry points, so the two packages give
equal reports on one graph.  The JAX shape pass runs ``jax.eval_shape``
over each op's fcompute; here each op's fcompute runs through
:func:`~mxnet_tpu_torch.ops.registry.apply_op` on ``torch.device("meta")``
tensors, which carry shapes and dtypes and no data, with the param-shape
hooks of :mod:`mxnet_tpu_torch.ops.shapes` run just in time at each
consumer, as in JAX.  Dtypes in messages are spelled as numpy (and JAX)
spell them (``float32``, ``bfloat16``).

Check catalog (rule IDs are the JAX package's):

========  ========  ====================================================
rule      severity  meaning
========  ========  ====================================================
MXG001    error     cycle in the graph (names the nodes on the cycle)
MXG002    error     duplicate node name (name-keyed binding would alias)
MXG003    warning   dead node / unused input (unreachable from any head,
                    or a head variable no op consumes)
MXG004    error     op with parameter inputs but no param-shape rule in
                    ``ops.shapes`` and no explicit ``__shape__``
MXG005    error     shape/attr inconsistency — the op's fcompute rejects
                    its input shapes (message carries the op error)
MXG006    warning   implicit dtype promotion (mixed float widths feeding
                    one op)
MXG007    error     sharded-graph coverage: a shardable parameter gets no
                    rule from ``parallel.tp_rules`` and carries no
                    explicit ``__tp__ = 'replicate'`` annotation
MXG008    error     registry self-check finding (alias/hook/rule drift)
MXG009    warning   shape underdetermined — a rule exists but could not
                    produce the parameter's shape from what is known
MXG010    warning   predicted-slow node (opt-in, :mod:`.perf`)
MXG017-   (memory)  the static memory-liveness rules, opt-in via
MXG021              ``memory=`` (:mod:`.memlive`)
========  ========  ====================================================

The distributed pass (MXG011-016, JAX ``analysis/spmd.py``) is not
ported: ``verify_symbol(mesh=...)`` over more than one device raises
(ROADMAP Queue A item 4).

Entry points: :func:`verify_symbol`, :meth:`Symbol.verify`,
``Symbol.bind(..., strict=True)``, :func:`verify_json` and
``python -m mxnet_tpu_torch.analysis``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..base import MXNetError, torch_dtype

__all__ = ["Diagnostic", "Report", "verify_symbol", "verify_json",
           "verify_model", "infer_node_shapes"]

_SEVERITIES = ("error", "warning")


class Diagnostic:
    """One verifier finding, attributed to a node where possible."""
    __slots__ = ("rule", "severity", "node", "op", "message", "advice")

    def __init__(self, rule, severity, message, node=None, op=None,
                 advice=None):
        assert severity in _SEVERITIES, severity
        self.rule = rule
        self.severity = severity
        self.message = message
        self.node = node          # offending node name (str | None)
        self.op = op              # op name (str | None)
        self.advice = advice      # machine-readable payload (dict | None)

    def as_dict(self):
        """JSON-ready form (``python -m mxnet_tpu_torch.analysis --json``)."""
        d = {"rule": self.rule, "severity": self.severity,
             "node": self.node, "op": self.op, "message": self.message}
        if self.advice is not None:
            d["advice"] = self.advice
        return d

    def __repr__(self):
        return "<Diagnostic %s %s>" % (self.rule, self.node or "<graph>")

    def __str__(self):
        where = self.node or "<graph>"
        if self.op:
            where += " (op %s)" % self.op
        return "%s [%s] %s: %s" % (self.rule, self.severity, where,
                                   self.message)


class Report:
    """Verification result: an ordered list of diagnostics."""

    def __init__(self, diagnostics=()):
        self.diagnostics = list(diagnostics)

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self):
        return not self.errors

    def __bool__(self):
        return self.ok

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def __str__(self):
        if not self.diagnostics:
            return "verify: OK (no findings)"
        lines = ["verify: %d error(s), %d warning(s)"
                 % (len(self.errors), len(self.warnings))]
        lines.extend("  " + str(d) for d in self.diagnostics)
        return "\n".join(lines)

    def add(self, *args, **kwargs):
        d = Diagnostic(*args, **kwargs)
        self.diagnostics.append(d)
        try:
            from ..telemetry import counter
            counter("mxtpu_verify_findings_total").labels(
                rule=d.rule).inc()
        except Exception:  # a metric failure never masks the finding
            pass

    def raise_if_errors(self, context=""):
        if self.ok:
            return self
        head = "graph verification failed"
        if context:
            head += " (%s)" % context
        raise MXNetError(head + ":\n" + "\n".join(
            "  " + str(d) for d in self.errors))


# ------------------------------------------------------------ graph walking

def _collect_nodes(entries):
    """Every node reachable from ``entries`` — tolerates cycles (unlike
    Symbol._topo, which assumes a DAG and would not terminate)."""
    nodes, seen = [], set()
    stack = [n for (n, _i) in entries]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        nodes.append(node)
        stack.extend(src for (src, _i) in node.inputs)
    return nodes


def _find_cycle(entries):
    """Iterative three-color DFS; returns the node list of one cycle, or
    None.  Runs before any topo-order work — a cycle makes Symbol._topo
    spin forever, so this check gates everything else."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color, parent = {}, {}
    for root, _i in entries:
        if color.get(id(root), WHITE) != WHITE:
            continue
        stack = [(root, iter([s for (s, _) in root.inputs]))]
        color[id(root)] = GRAY
        while stack:
            node, it = stack[-1]
            advanced = False
            for src in it:
                c = color.get(id(src), WHITE)
                if c == GRAY:
                    # walk parent chain back to src to name the cycle
                    cyc, cur = [node], node
                    while id(cur) != id(src):
                        cur = parent[id(cur)]
                        cyc.append(cur)
                    return list(reversed(cyc))
                if c == WHITE:
                    color[id(src)] = GRAY
                    parent[id(src)] = node
                    stack.append((src, iter([s for (s, _) in src.inputs])))
                    advanced = True
                    break
            if not advanced:
                color[id(node)] = BLACK
                stack.pop()
    return None


def _topo_from_entries(entries):
    from ..symbol import _topo_order
    return _topo_order(entries)


# -------------------------------------------------------------- the checks

def _check_duplicate_names(nodes, report):
    by_name = {}
    for n in nodes:
        by_name.setdefault(n.name, []).append(n)
    for name, group in sorted(by_name.items()):
        if len(group) > 1:
            kinds = ["variable" if n.is_variable else n.op.name
                     for n in group]
            report.add("MXG002", "error",
                       "%d distinct nodes share the name %r (%s); "
                       "name-keyed binding (arg_dict, checkpoints) would "
                       "silently alias them" % (len(group), name,
                                                ", ".join(kinds)),
                       node=name)


def _check_dead_entries(entries, nodes, report):
    """Head variables nothing consumes, and duplicate head entries."""
    consumed = set()
    for n in nodes:
        for (src, _i) in n.inputs:
            consumed.add(id(src))
    seen_entries = set()
    for node, idx in entries:
        if (id(node), idx) in seen_entries:
            report.add("MXG003", "warning",
                       "output %r is listed more than once in the heads"
                       % node.output_names()[idx], node=node.name)
        seen_entries.add((id(node), idx))
        if node.is_variable and id(node) not in consumed:
            report.add("MXG003", "warning",
                       "input variable %r is consumed by no operator and "
                       "is returned unchanged (dead input)" % node.name,
                       node=node.name)


def dtype_name(dtype):
    """numpy's name of a dtype given as a string, a numpy dtype or a
    torch dtype (``float32``, ``bfloat16``, ``int64``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype if dtype == "bfloat16" else np.dtype(dtype).name
    name = getattr(dtype, "name", None)
    return name if isinstance(name, str) else np.dtype(dtype).name


class DType:
    """A dtype as the analyses read it: ``name`` (numpy's spelling),
    ``itemsize``, ``str()`` the name."""
    __slots__ = ("name", "itemsize", "floating")

    def __init__(self, tdtype):
        self.name = dtype_name(tdtype)
        self.itemsize = int(tdtype.itemsize)
        self.floating = bool(tdtype.is_floating_point)

    def __eq__(self, other):
        return isinstance(other, DType) and other.name == self.name

    def __hash__(self):
        return hash(self.name)

    def __str__(self):
        return self.name

    __repr__ = __str__


class ShapeDtype:
    """One output of a node in the shape pass: ``shape`` (a tuple of
    ints) and ``dtype`` (:class:`DType`); the counterpart of
    ``jax.ShapeDtypeStruct``."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype

    def __repr__(self):
        return "ShapeDtype(%s, %s)" % (self.shape, self.dtype)


def _var_dtype(node, type_overrides):
    if node.name in type_overrides:
        return dtype_name(type_overrides[node.name])
    return node.raw_attr.get("__dtype__", "float32")


def _auto_param_names(node):
    """The auto-created parameter/aux variable inputs of an op node:
    variables named ``<node>_<slot>`` (the Symbol._create convention)."""
    names = node.arg_names() + node.aux_names()
    out = []
    for slot, (src, _i) in zip(names, node.inputs):
        if src.is_variable and src.name == "%s_%s" % (node.name, slot):
            out.append((slot, src))
    return out


def _shape_pass(sym, topo, known_shapes, type_overrides, report):
    """Per-node abstract interpretation on the ``meta`` device.

    Walks topo order keeping a tuple of :class:`ShapeDtype` per node.
    Param-shape hooks run just-in-time at each consumer op, exactly as
    ``Symbol.infer_shape`` does, but a failure is localized to the node that
    raised instead of aborting the whole inference.  Returns
    ``({var_name: shape}, {id(node): tuple(ShapeDtype)})`` — the resolved
    variable shapes feed the TP pass, the per-node structs feed MXG010
    (:mod:`.perf`) and the memory-liveness pass (:mod:`.memlive`)."""
    with torch.no_grad():
        return _shape_pass_meta(topo, known_shapes, type_overrides, report)


def _shape_pass_meta(topo, known_shapes, type_overrides, report):
    from ..ops import shapes as _shapes
    from ..ops.registry import OpContext, apply_op

    meta = torch.device("meta")
    structs = {}          # id(node) -> tuple(ShapeDtype) | None
    tensors = {}          # id(node) -> tuple(meta tensor) | None
    var_shapes = {}       # id(var-node) -> shape
    var_reported = set()  # variables already attributed to a diagnostic
    resolved = {}         # var_name -> shape (the return value)

    # seed variable shapes: explicit kwargs first, then __shape__ attrs
    batch_size = None
    for node in topo:
        if not node.is_variable:
            continue
        shp = None
        if node.name in known_shapes:
            shp = tuple(known_shapes[node.name])
        elif "__shape__" in node.raw_attr:
            shp = tuple(json.loads(node.raw_attr["__shape__"]))
        if shp is not None:
            var_shapes[id(node)] = shp
            if batch_size is None and len(shp) > 0:
                batch_size = int(shp[0])

    def set_var(node):
        shp = var_shapes.get(id(node))
        if shp is None:
            structs[id(node)] = tensors[id(node)] = None
            return
        t = torch.empty(tuple(int(d) for d in shp),
                        dtype=torch_dtype(_var_dtype(node, type_overrides)),
                        device=meta)
        tensors[id(node)] = (t,)
        structs[id(node)] = (ShapeDtype(t.shape, DType(t.dtype)),)

    octx = OpContext(is_train=False, device=meta)
    for node in topo:
        if node.is_variable:
            set_var(node)
            if structs[id(node)] is not None:
                resolved[node.name] = tuple(var_shapes[id(node)])
            continue

        slot_names = node.arg_names() + node.aux_names()

        # just-in-time param-shape hook: fill variable inputs whose shape
        # is still unknown from the shapes known so far
        hook = _shapes.get_param_shapes(node.op.name)
        unknown_vars = [(nm, src) for nm, (src, _i)
                        in zip(slot_names, node.inputs)
                        if src.is_variable and id(src) not in var_shapes]
        if hook is not None and unknown_vars:
            known_in = {}
            for nm, (src, _i) in zip(slot_names, node.inputs):
                st = structs.get(id(src))
                if st is not None and len(st) > _i:
                    known_in[nm] = tuple(st[_i].shape)
                elif src.is_variable and id(src) in var_shapes:
                    known_in[nm] = tuple(var_shapes[id(src)])
            try:
                inferred = hook(node.attrs, known_in)
            except Exception as e:  # user code (CustomOpProp): a finding
                report.add("MXG005", "error",
                           "param-shape rule for op %s raised: %s"
                           % (node.op.name, e),
                           node=node.name, op=node.op.name)
                inferred = {}
            for nm, src in unknown_vars:
                if nm in inferred:
                    var_shapes[id(src)] = tuple(inferred[nm])
                    set_var(src)
                    resolved[src.name] = tuple(inferred[nm])

        # attribute still-unknown variable inputs
        missing = [(nm, src) for nm, src in unknown_vars
                   if id(src) not in var_shapes
                   and id(src) not in var_reported]
        auto_params = {nm for nm, _src in _auto_param_names(node)}
        if missing:
            for nm, src in missing:
                var_reported.add(id(src))
            auto_missing = [nm for nm, _s in missing if nm in auto_params]
            if hook is None and auto_missing:
                report.add(
                    "MXG004", "error",
                    "op %s auto-created parameter input(s) %s but has no "
                    "param-shape rule registered in ops.shapes and no "
                    "explicit __shape__; their shapes cannot be inferred"
                    % (node.op.name, auto_missing),
                    node=node.name, op=node.op.name)
            else:
                report.add(
                    "MXG009", "warning",
                    "shapes of input(s) %s of op %s are underdetermined "
                    "(provide them via infer kwargs or __shape__)"
                    % ([nm for nm, _s in missing], node.op.name),
                    node=node.name, op=node.op.name)

        # gather input tensors; skip eval if anything upstream is unknown
        ins, in_structs = [], []
        unknown_input = False
        for (src, idx) in node.inputs:
            ts = tensors.get(id(src))
            if ts is None or len(ts) <= idx:
                unknown_input = True
                break
            ins.append(ts[idx])
            in_structs.append(structs[id(src)][idx])
        if unknown_input:
            structs[id(node)] = tensors[id(node)] = None
            continue

        # dtype-promotion audit: mixed float widths feeding one op
        f_dtypes = sorted({st.dtype.name for st in in_structs
                           if st.dtype.floating})
        if len(f_dtypes) > 1:
            report.add("MXG006", "warning",
                       "inputs of op %s mix float dtypes %s; XLA will "
                       "promote implicitly (check intended precision)"
                       % (node.op.name, f_dtypes),
                       node=node.name, op=node.op.name)

        # deferred batch dims in source-op shapes (RNN begin_state zeros)
        node_attrs = node.attrs
        shp = node_attrs.get("shape")
        if (not node.inputs and isinstance(shp, (tuple, list))
                and any(s == 0 for s in shp)):
            if batch_size is None:
                report.add("MXG005", "error",
                           "source op %s has a deferred (0) dim in shape "
                           "%s but no input shape fixes the batch size"
                           % (node.op.name, tuple(shp)),
                           node=node.name, op=node.op.name)
                structs[id(node)] = tensors[id(node)] = None
                continue
            node_attrs = dict(node_attrs)
            node_attrs["shape"] = tuple(batch_size if s == 0 else int(s)
                                        for s in shp)

        try:
            outs = apply_op(node.op, node_attrs, octx, *ins)
        except Exception as e:  # any fcompute error is a node finding
            msg = str(e).strip().splitlines()
            report.add("MXG005", "error",
                       "op %s rejects input shapes %s: %s"
                       % (node.op.name,
                          [tuple(st.shape) for st in in_structs],
                          msg[0] if msg else repr(e)),
                       node=node.name, op=node.op.name)
            structs[id(node)] = tensors[id(node)] = None
            continue
        outs = tuple(outs)
        tensors[id(node)] = outs
        structs[id(node)] = tuple(ShapeDtype(o.shape, DType(o.dtype))
                                  for o in outs)
    return resolved, structs


def _check_tp_coverage(topo, arg_shapes, tp_size, report):
    """Sharded-graph coverage: every shardable parameter must either get
    a rule from ``derive_tp_rules`` or carry an explicit replicate
    annotation (``__tp__ = 'replicate'`` on the owning op node or the
    parameter variable)."""
    from ..parallel.tp_rules import derive_tp_rules, _weight_of
    rules = derive_tp_rules(topo, arg_shapes, tp_size)
    for node in topo:
        if node.is_variable or node.op is None:
            continue
        if node.op.name not in ("FullyConnected", "Convolution"):
            continue
        w, _b = _weight_of(node)
        if w is None or w in rules:
            continue
        ann = node.raw_attr.get("__tp__")
        if ann is None:
            for (src, _i) in node.inputs:
                if src.is_variable and src.name == w:
                    ann = src.raw_attr.get("__tp__")
                    break
        if ann == "replicate":
            continue
        if ann is not None:
            report.add("MXG007", "error",
                       "op %s has unknown __tp__ annotation %r (expected "
                       "'replicate')" % (node.op.name, ann),
                       node=node.name, op=node.op.name)
            continue
        shp = arg_shapes.get(w)
        report.add(
            "MXG007", "error",
            "parameter %r of op %s (shape %s) gets no tensor-parallel "
            "rule for tp_size=%d and carries no explicit "
            "__tp__='replicate' annotation; it would be silently "
            "replicated on every model shard"
            % (w, node.op.name, shp, tp_size),
            node=node.name, op=node.op.name)


def _registry_diagnostics(report):
    from ..ops import registry as _registry
    for problem in _registry.selfcheck():
        report.add("MXG008", "error", problem)


# ------------------------------------------------------------- entry points

def _mesh_devices(mesh):
    """Devices a mesh descriptor ({axis: size}) spans."""
    n = 1
    for size in dict(mesh).values():
        n *= int(size or 1)
    return n


def verify_symbol(sym, shapes=None, types=None, tp_size=1,
                  check_registry=False, report=None, cost_model=None,
                  slow_factor=3.0, plan=False, plan_layout="NCHW",
                  mesh=None, parallel=None, memory=None):
    """Verify a Symbol graph; returns a :class:`Report`.

    ``shapes``: {input_name: shape} (same keys as ``infer_shape`` kwargs;
    optional — without them only structural checks and __shape__-seeded
    inference run).  ``types``: {input_name: dtype}.  ``tp_size`` > 1
    additionally runs the sharding-coverage check against
    ``parallel.tp_rules``.  ``check_registry`` folds the op-registry
    self-check into the report.  ``cost_model`` (a fitted
    ``mxnet_tpu_torch.autotune.CostModel`` or a saved-model path)
    additionally runs MXG010: nodes whose predicted wall exceeds their
    roofline-attainable time by more than ``slow_factor`` are named
    before any compile (:mod:`.perf`).  ``plan=True`` switches MXG010
    to plan mode: predictions for the COMMITTED fusion/layout plan
    (the ``graph_plan`` tuning-cache entry at ``plan_layout``; greedy
    on miss) instead of the default per-node lowering.
    ``mesh`` ({axis: size} descriptor) over more than one device asks
    for the distributed-correctness pass (MXG011-016), not yet ported: it
    raises (Queue A item 4); a one-device mesh checks nothing more, and
    ``parallel`` is accepted for the JAX signature.
    ``memory`` (True or a dict of :func:`.memlive.check_memory`
    options) additionally runs the static memory-liveness pass
    (MXG017-021), reusing this call's shape pass; like MXG010 it is
    opt-in and never runs on a plain verify.
    """
    report = report if report is not None else Report()
    shapes = dict(shapes or {})
    types = dict(types or {})

    if check_registry:
        _registry_diagnostics(report)

    entries = sym._entries
    cycle = _find_cycle(entries)
    if cycle is not None:
        report.add("MXG001", "error",
                   "graph contains a cycle through nodes [%s]; no "
                   "execution order exists"
                   % " -> ".join(n.name for n in cycle),
                   node=cycle[0].name)
        # everything below needs a topo order — stop here
        return report

    nodes = _collect_nodes(entries)
    _check_duplicate_names(nodes, report)
    _check_dead_entries(entries, nodes, report)

    topo = _topo_from_entries(entries)
    arg_shapes, structs = _shape_pass(sym, topo, shapes, types, report)

    if tp_size and tp_size > 1:
        _check_tp_coverage(topo, arg_shapes, tp_size, report)
    if mesh and _mesh_devices(mesh) > 1:
        raise MXNetError(
            "verify_symbol(mesh=%r): the distributed-correctness pass "
            "(MXG011-016, analysis.spmd) is not yet ported to "
            "mxnet_tpu_torch (ROADMAP Queue A item 4)" % (dict(mesh),))
    if cost_model is not None:
        if plan:
            from .perf import check_predicted_plan
            check_predicted_plan(topo, sym._entries, structs,
                                 cost_model, factor=slow_factor,
                                 report=report, layout=plan_layout)
        else:
            from .perf import check_predicted_slow
            check_predicted_slow(topo, structs, cost_model,
                                 factor=slow_factor, report=report)
    if memory:
        from . import memlive as _memlive
        mopts = dict(memory) if isinstance(memory, dict) else {}
        if mesh and "mesh" not in mopts:
            mopts["mesh"] = dict(mesh)
        # hand over this call's shape pass: memlive would otherwise run it
        # over the whole graph again
        _memlive.check_memory(sym, shapes, types, report=report,
                              topo=topo, structs=structs, **mopts)
    return report


def infer_node_shapes(sym, shapes=None, types=None):
    """Per-node output shapes via the verifier's abstract-
    interpretation pass, without diagnostics: ``(topo,
    {id(node): tuple(shape tuples)})``.  Nodes whose shapes could not
    be resolved are absent."""
    entries = sym._entries
    topo = _topo_from_entries(entries)
    scratch = Report()
    _resolved, structs = _shape_pass(sym, topo, dict(shapes or {}),
                                     dict(types or {}), scratch)
    out = {}
    for nid, sts in structs.items():
        if sts is None:
            continue
        out[nid] = tuple(tuple(int(d) for d in st.shape) for st in sts)
    return topo, out


def verify_json(json_str, shapes=None, types=None, tp_size=1,
                check_registry=False, cost_model=None,
                slow_factor=3.0, plan=False, plan_layout="NCHW",
                mesh=None, parallel=None, memory=None):
    """Verify a serialized symbol (the reference JSON graph layout).

    Runs every :func:`verify_symbol` check *plus* true dead-node
    detection: nodes present in the file but unreachable from any head —
    the defect class hand-edited or generator-produced checkpoints hit,
    which an in-memory Symbol cannot represent (it only holds what its
    heads reach).
    """
    from .. import symbol as _symbol
    report = Report()
    try:
        data = json.loads(json_str)
        raw_nodes = data.get("nodes", [])
        heads = [h[0] for h in data.get("heads", [])]

        # reachability over the flat node table
        reachable, stack = set(), list(heads)
        while stack:
            i = stack.pop()
            if i in reachable or i >= len(raw_nodes):
                continue
            reachable.add(i)
            stack.extend(inp[0] for inp in raw_nodes[i].get("inputs", []))
        for i, entry in enumerate(raw_nodes):
            if i not in reachable:
                report.add("MXG003", "warning",
                           "node %r (op %s) is unreachable from every "
                           "head (dead node)"
                           % (entry.get("name", "#%d" % i),
                              entry.get("op", "?")),
                           node=entry.get("name"))
    except (ValueError, TypeError, AttributeError, KeyError,
            IndexError) as e:
        # not the reference JSON layout at all — one diagnostic, not a
        # traceback (the CLI contract)
        report.add("MXG005", "error",
                   "graph does not parse as the symbol JSON layout: "
                   "%s" % e)
        return report

    try:
        sym = _symbol.load_json(json_str)
    except (MXNetError, ValueError, TypeError, KeyError, IndexError) as e:
        report.add("MXG005", "error",
                   "graph does not deserialize: %s" % e)
        return report
    return verify_symbol(sym, shapes=shapes, types=types, tp_size=tp_size,
                         check_registry=check_registry, report=report,
                         cost_model=cost_model, slow_factor=slow_factor,
                         plan=plan, plan_layout=plan_layout,
                         mesh=mesh, parallel=parallel, memory=memory)


# default verification inputs per model-zoo entry: (data kwargs)
_MODEL_SHAPES = {
    "mlp": {"data": (2, 784)},
    "lenet": {"data": (2, 1, 28, 28)},
}
_DEFAULT_IMAGE = {"data": (2, 3, 224, 224)}


def verify_model(name, batch=2, tp_size=1, num_classes=10,
                 cost_model=None, slow_factor=3.0, plan=False,
                 plan_layout="NCHW", mesh=None, parallel=None,
                 memory=None, **model_kwargs):
    """Build a model-zoo symbol and verify it with its canonical input
    shape.  Returns (symbol, Report).  ``cost_model`` additionally
    runs the MXG010 predicted-slow check (:mod:`.perf`); ``plan=True``
    switches it to committed-plan mode; ``mesh``/``parallel`` as
    :func:`verify_symbol`."""
    from .. import models
    net = models.get_model(name, num_classes=num_classes, **model_kwargs)
    shapes = dict(_MODEL_SHAPES.get(name, _DEFAULT_IMAGE))
    shapes = {k: (batch,) + tuple(v[1:]) for k, v in shapes.items()}
    shapes["softmax_label"] = (batch,)
    return net, verify_symbol(net, shapes=shapes, tp_size=tp_size,
                              cost_model=cost_model,
                              slow_factor=slow_factor, plan=plan,
                              plan_layout=plan_layout,
                              mesh=mesh, parallel=parallel,
                              memory=memory)
