"""Symbol: the declarative graph.

The counterpart of ``mxnet_tpu/symbol.py``.  A Symbol is a Python DAG of
``_Node``s (op + parsed attrs + input edges).  ``eval_graph`` runs the DAG
op by op on tensors; ``infer_shape`` runs it on ``torch.device("meta")``,
where tensors carry shapes and no data (the counterpart of
``jax.eval_shape``), with the per-op parameter-shape hooks of
:mod:`.ops.shapes` filling in weight shapes on the way.

The JSON layout (nodes / arg_nodes / node_row_ptr / heads) and the attribute
strings are the JAX package's, so a graph saved by either package loads in
the other.  ``bind``/``simple_bind`` give an
:class:`~mxnet_tpu_torch.executor.Executor` (forward, and with grad arrays
backward); ``parallel.ShardedTrainer`` runs ``eval_graph`` under autograd
too.
"""
from __future__ import annotations

import json
import threading

import torch

from . import profiler as _profiler
from .base import MXNetError, torch_dtype
from .context import current_context
from . import attribute, name as _name_mod
from .ops import registry as _registry
from .ops.registry import OpContext, apply_op, get_op
from .ops import fused as _fused, shapes as _shapes
from .ops.nn import current_image_layout
from .analysis import fusion as _fusion

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "arange", "zeros", "ones", "eval_graph"]

_META_PREFIX = "__"
# generated op functions land in this module's globals; a ported op named
# ``slice`` would shadow the builtin used below
_py_slice = slice


class _Node:
    """One graph node: a variable (op is None) or an op application."""
    __slots__ = ("op", "name", "attrs", "raw_attr", "inputs", "num_args")

    def __init__(self, op, name, attrs=None, raw_attr=None, inputs=None,
                 num_args=0):
        self.op = op
        self.name = name
        self.attrs = attrs or {}        # parsed op params
        self.raw_attr = raw_attr or {}  # meta attrs (ctx_group, lr_mult, ...)
        self.inputs = inputs or []      # list[(Node, out_index)]
        self.num_args = num_args        # inputs[:num_args] are args, rest aux

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.op is None else self.op.get_num_outputs(self.attrs)

    def arg_names(self):
        return [] if self.op is None else self.op.get_arg_names(self.attrs)

    def aux_names(self):
        return [] if self.op is None else self.op.get_aux_names(self.attrs)

    def output_names(self):
        n = self.num_outputs()
        if self.op is None:
            return [self.name]
        if n == 1:
            return [self.name + "_output"]
        return ["%s_output%d" % (self.name, i) for i in range(n)]


def _topo_order(entries):
    """Iterative DFS post-order over the DAG (inputs before consumers)."""
    order, visited = [], set()
    stack = [(n, False) for (n, _) in reversed(entries)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in visited:
            continue
        if expanded:
            visited.add(id(node))
            order.append(node)
        else:
            stack.append((node, True))
            for (src, _) in reversed(node.inputs):
                if id(src) not in visited:
                    stack.append((src, False))
    return order


def _classify_vars(topo):
    """Split variable nodes into (args, aux) in first-appearance order."""
    aux_ids = set()
    for node in topo:
        for (src, _) in node.inputs[node.num_args:]:
            if src.is_variable:
                aux_ids.add(id(src))
    args, aux = [], []
    for node in topo:
        if node.is_variable:
            (aux if id(node) in aux_ids else args).append(node)
    return args, aux


def source_attrs(node, batch_size):
    """``node``'s attributes with a 0 in the ``shape`` of an op without
    inputs (``sym.zeros((0, H))``, the RNN cells' begin state) replaced by
    ``batch_size``; ops with inputs give a 0 its own meaning (Reshape's
    "copy this dim") and keep it."""
    shp = node.attrs.get("shape")
    if node.inputs or not isinstance(shp, (tuple, list)) \
            or not any(d == 0 for d in shp):
        return node.attrs
    if batch_size is None:
        raise MXNetError("node %r has a deferred (0) dim in shape %s but no "
                         "batch size is known" % (node.name, tuple(shp)))
    attrs = dict(node.attrs)
    attrs["shape"] = tuple(batch_size if d == 0 else int(d) for d in shp)
    return attrs


def eval_graph(topo, entries, var_values, is_train=False, device=None,
               generator=None, batch_size=None, monitor=None):
    """Run the DAG forward.  ``var_values``: id(variable node) -> tensor.
    ``device`` is where ops without inputs allocate; ``generator`` is the
    ``torch.Generator`` that the ops registered ``stochastic`` draw from
    when ``is_train``; the other ops get none, as in the JAX package only
    stochastic ops get a PRNG key.  ``batch_size`` fills the 0 dims of ops
    without inputs (:func:`source_attrs`).  ``monitor(name, tensor)``, when
    given, is called with every output of every op node as it is computed
    (the graph then runs unfused).

    Returns ``(heads, aux_updates)``: the head tensors and, for every
    auxiliary variable an op updates (BatchNorm's moving statistics),
    id(variable node) -> its new value.  Under
    :class:`~mxnet_tpu_torch.ops.fused.block_fusion` the graph runs by the
    block plan of :mod:`mxnet_tpu_torch.analysis.fusion`: interior nodes of
    a fused block are skipped and the block is evaluated at its terminal
    node, its BN aux updates threaded as the unfused op's.  Ops run
    eagerly and autograd records them unless the caller runs this under
    ``torch.no_grad()``/``inference_mode()``: the trainer differentiates
    through it, the Executor serves without."""
    device = device if device is not None else torch.device("cpu")
    octx = OpContext(is_train=is_train, device=device)
    sctx = OpContext(is_train=is_train, device=device, generator=generator)
    vals, aux_updates = {}, {}
    block_plan = None
    if _fused.block_fusion_enabled() and monitor is None:
        block_plan = _fusion.plan_block_fusion(
            topo, entries, layout=current_image_layout(), is_train=is_train)

    def thread_aux(node, updates):
        for (src, _), upd in zip(node.inputs[node.num_args:], updates):
            if src.is_variable:
                aux_updates[id(src)] = upd

    # a running profiler gets one operator event a node (a fused block's
    # at its terminal): the dispatch of the op on the host, on the clock
    # of the telemetry spans
    prof = _profiler.is_running()
    tid = threading.get_ident() % (1 << 31)
    node = None
    try:
        for node in topo:
            if node.is_variable:
                try:
                    vals[id(node)] = (var_values[id(node)],)
                except KeyError:
                    raise MXNetError("no value bound for variable %r"
                                     % node.name)
                continue
            if block_plan is not None:
                if id(node) in block_plan.skip:
                    # interior of a fused block: evaluated at its terminal
                    vals[id(node)] = (None,) * node.num_outputs()
                    continue
                blk = block_plan.blocks.get(id(node))
                if blk is not None:
                    t0 = _profiler.now_us() if prof else 0.0
                    out, bn_node, bn_aux = _fusion.apply_block(blk, vals,
                                                               is_train)
                    if prof:
                        _profiler.record_event(
                            "fused_%s" % getattr(blk, "kind", "block"), t0,
                            _profiler.now_us() - t0, "operator", tid)
                    vals[id(node)] = (out,)
                    if bn_node is not None:
                        thread_aux(bn_node, bn_aux)
                    continue
            ins = [vals[id(src)][idx] for (src, idx) in node.inputs]
            t0 = _profiler.now_us() if prof else 0.0
            outs = apply_op(node.op, source_attrs(node, batch_size),
                            sctx if node.op.is_stochastic(node.attrs)
                            else octx, *ins)
            if prof:
                _profiler.record_event(node.op.name, t0,
                                       _profiler.now_us() - t0, "operator",
                                       tid)
            n_vis = node.num_outputs()
            vals[id(node)] = outs[:n_vis]
            thread_aux(node, outs[n_vis:])
            if monitor is not None:
                for oname, val in zip(node.output_names(), outs[:n_vis]):
                    monitor(oname, val)
    except Exception as e:
        # name the node an error (a failed CUDA graph capture among them)
        # came from; the message and the type stay the exception's own
        if node is not None and not node.is_variable:
            e.add_note("while running op %s (node %r)"
                       % (node.op.name, node.name))
        raise
    heads = [vals[id(n)][i] for (n, i) in entries]
    return heads, aux_updates


class Symbol:
    """An immutable multi-output handle into the graph."""
    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)  # list[(Node, out_index)]

    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __repr__(self):
        if len(self._entries) == 1:
            return "<Symbol %s>" % self._entries[0][0].name
        return "<Symbol group [%s]>" % ", ".join(
            n.name for (n, _) in self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                for i, (n, _) in enumerate(self._entries):
                    if n.name == index:
                        return Symbol([self._entries[i]])
                raise ValueError("cannot find output %r" % index)
            index = names.index(index)
        if isinstance(index, _py_slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    # ----------------------------------------------------------- arithmetic
    def _binary(self, other, op_ss, op_s):
        if isinstance(other, Symbol):
            return _create(op_ss, None, None, [self, other], {})
        if isinstance(other, (int, float)):
            return _create(op_s, None, None, [self], {"scalar": float(other)})
        raise TypeError("unsupported operand type %r" % type(other).__name__)

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_rminus_scalar")

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_rdiv_scalar")

    def __pow__(self, other):
        return self._binary(other, "_power", "_power_scalar")

    def __neg__(self):
        return _create("negative", None, None, [self], {})

    # -------------------------------------------------------------- listing
    def _topo(self):
        return _topo_order(self._entries)

    def list_arguments(self):
        args, _ = _classify_vars(self._topo())
        return [n.name for n in args]

    def list_auxiliary_states(self):
        _, aux = _classify_vars(self._topo())
        return [n.name for n in aux]

    def list_outputs(self):
        return [node.output_names()[idx] for (node, idx) in self._entries]

    def attr_dict(self):
        """``{node name: {attr: value string}}`` of every node with
        attributes (the variables' meta attributes, an op's parameters)."""
        out = {}
        for node in self._topo():
            d = dict(node.raw_attr)
            if node.op is not None:
                d.update({k: _attr_str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    def get_internals(self):
        """All internal outputs as a group."""
        entries = []
        for node in self._topo():
            for i in range(node.num_outputs()):
                entries.append((node, i))
        return Symbol(entries)

    # ------------------------------------------------------------ inference
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input shapes;
        raises when an argument's shape cannot be inferred."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for what cannot be inferred."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        for a_name, a_shape in zip(self.list_arguments(), args):
            if a_shape is not None:
                known[a_name] = tuple(a_shape)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)

        topo = self._topo()
        arg_nodes, aux_nodes = _classify_vars(topo)
        shapes = {}
        for node in arg_nodes + aux_nodes:
            if node.name in known:
                shapes[id(node)] = known[node.name]
            elif "__shape__" in node.raw_attr:
                shapes[id(node)] = tuple(
                    json.loads(node.raw_attr["__shape__"]))

        # the batch dimension of the graph's 0-dim sources: the first
        # argument's leading dim, as the JAX package takes it
        batch_size = next((shapes[id(n)][0] for n in arg_nodes
                           if len(shapes.get(id(n), ())) > 0), None)

        # one pass in topological order on the meta device: a node's
        # parameter shapes come from its hook once its data shape is known,
        # then the node itself runs to give its output shapes
        meta = torch.device("meta")
        octx = OpContext(is_train=False, device=meta)
        vals = {}

        def value(src, idx):
            if src.is_variable:
                if id(src) not in shapes:
                    return None
                dt = torch_dtype(src.raw_attr.get("__dtype__", "float32"))
                return torch.empty(shapes[id(src)], dtype=dt, device=meta)
            out = vals.get(id(src))
            return None if out is None else out[idx]

        for node in topo:
            if node.is_variable:
                continue
            names = node.arg_names() + node.aux_names()
            hook = _shapes.get_param_shapes(node.op.name)
            if hook is not None:
                known_in = {}
                for nm, (src, idx) in zip(names, node.inputs):
                    v = value(src, idx)
                    if v is not None:
                        known_in[nm] = tuple(v.shape)
                for nm, shp in hook(node.attrs, known_in).items():
                    if nm not in names:
                        continue
                    src, _ = node.inputs[names.index(nm)]
                    if src.is_variable and id(src) not in shapes:
                        shapes[id(src)] = tuple(shp)
            ins = [value(src, idx) for (src, idx) in node.inputs]
            if all(v is not None for v in ins):
                vals[id(node)] = apply_op(
                    node.op, source_attrs(node, batch_size), octx,
                    *ins)[:node.num_outputs()]

        missing = [n.name for n in arg_nodes + aux_nodes
                   if id(n) not in shapes]
        if missing and not partial:
            raise MXNetError("infer_shape: cannot infer shapes for %s; "
                             "provide them explicitly" % missing)
        arg_shapes = [shapes.get(id(n)) for n in arg_nodes]
        aux_shapes = [shapes.get(id(n)) for n in aux_nodes]
        if missing:
            return arg_shapes, None, aux_shapes
        out_shapes = [tuple(value(n, i).shape) for (n, i) in self._entries]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes: a given
        type, else a variable's ``__dtype__``, else float32 (the ported ops
        keep their inputs' float type)."""
        import numpy as np
        known = {a: np.dtype(t) for a, t in zip(self.list_arguments(), args)
                 if t is not None}
        known.update({k: np.dtype(v) for k, v in kwargs.items()
                      if v is not None})
        topo = self._topo()
        arg_nodes, aux_nodes = _classify_vars(topo)

        def of(node):
            if node.name in known:
                return known[node.name]
            return np.dtype(node.raw_attr.get("__dtype__", "float32"))
        return ([of(n) for n in arg_nodes],
                [np.dtype(np.float32)] * len(self._entries),
                [of(n) for n in aux_nodes])

    # ------------------------------------------------------------- binding
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None):
        """An :class:`~mxnet_tpu_torch.executor.Executor` on ``ctx``
        (default: the current context, ``gpu(0)``) over ``args`` (a list in
        ``list_arguments()`` order or a dict of NDArrays), with grad arrays
        ``args_grad`` (made as zeros where ``grad_req`` asks for one and
        none is given) and ``aux_states``.  ``grad_req`` is ``'write'``,
        ``'add'`` or ``'null'``, or a list or dict of them."""
        from .executor import Executor
        return Executor(self, ctx or current_context(), args, args_grad,
                        grad_req, aux_states, group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        """Infer every shape from the input shapes in ``kwargs``, allocate
        zero arrays (and grad arrays where ``grad_req`` asks) on ``ctx``, and
        :meth:`bind` them."""
        from .ndarray import zeros
        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_types, _, aux_types = self.infer_type(**(type_dict or {}))
        names = self.list_arguments()
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in names}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(names, grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in names}
        args = [zeros(s, ctx=ctx, dtype=t)
                for s, t in zip(arg_shapes, arg_types)]
        grads = {n: zeros(s, ctx=ctx, dtype=t)
                 for n, s, t in zip(names, arg_shapes, arg_types)
                 if reqs.get(n, "null") != "null"}
        aux = [zeros(s, ctx=ctx, dtype=t)
               for s, t in zip(aux_shapes, aux_types)]
        return self.bind(ctx, args, args_grad=grads, grad_req=reqs,
                         aux_states=aux, group2ctx=group2ctx)

    # -------------------------------------------------------------- ser/de
    def tojson(self):
        """Serialize in the reference's JSON graph layout."""
        topo = self._topo()
        node_ids = {id(n): i for i, n in enumerate(topo)}
        nodes, arg_nodes = [], []
        for i, node in enumerate(topo):
            if node.is_variable:
                arg_nodes.append(i)
                entry = {"op": "null", "name": node.name, "inputs": []}
                if node.raw_attr:
                    entry["attrs"] = dict(node.raw_attr)
            else:
                attrs = {k: _attr_str(v) for k, v in node.attrs.items()}
                attrs.update(node.raw_attr)
                entry = {"op": node.op.name, "name": node.name,
                         "inputs": [[node_ids[id(s)], idx, 0]
                                    for (s, idx) in node.inputs]}
                if attrs:
                    entry["attrs"] = attrs
            nodes.append(entry)
        heads = [[node_ids[id(n)], idx, 0] for (n, idx) in self._entries]
        row_ptr = [0]
        for n in topo:
            row_ptr.append(row_ptr[-1] + n.num_outputs())
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": row_ptr,
            "heads": heads,
            "attrs": {"mxnet_version": ["int", 1001]},
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def _single_entry(self):
        if len(self._entries) != 1:
            raise MXNetError("operation requires a single-output symbol; "
                             "got %d outputs" % len(self._entries))
        return self._entries[0]


def _attr_str(v):
    if isinstance(v, bool):
        return "True" if v else "False"
    if v is None:
        return "None"
    if isinstance(v, (list, tuple)):
        return "(" + ", ".join(str(x) for x in v) + ")"
    return str(v)


# ---------------------------------------------------------------- creation
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a variable symbol; ``shape`` and ``dtype`` are stored as the
    ``__shape__``/``__dtype__`` attributes that shape inference reads,
    ``lr_mult``/``wd_mult`` as the attributes the optimizer reads, and
    ``init`` (an initializer or its ``dumps()`` string) as ``__init__``,
    which the initializers obey."""
    if not isinstance(name, str):
        raise TypeError("expect a string for variable name")
    raw = attribute.current().get(attr)
    if shape is not None:
        raw["__shape__"] = json.dumps(list(shape))
    if lr_mult is not None:
        raw["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        raw["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        import numpy as np
        raw["__dtype__"] = np.dtype(dtype).name
    if init is not None:
        raw["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            raw[k] = str(v)
        else:
            raise ValueError("unknown variable option %r" % k)
    return Symbol([(_Node(None, name, raw_attr=raw), 0)])


var = Variable


def Group(symbols):
    """Group symbols into one multi-output symbol."""
    entries = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("expect Symbols in Group")
        entries.extend(s._entries)
    return Symbol(entries)


def _create(op_name, name, attr, sym_args, attr_kwargs, sym_kwargs=None):
    """Compose a new op node (the generated ``mx.sym.<op>`` body)."""
    op = get_op(op_name)
    sym_kwargs = sym_kwargs or {}
    if op.key_var_num_args and op.key_var_num_args not in attr_kwargs:
        attr_kwargs = dict(attr_kwargs)
        attr_kwargs[op.key_var_num_args] = \
            (len(sym_args) + len(sym_kwargs)) or 1
    attrs = op.parse_attrs(attr_kwargs)
    arg_names = op.get_arg_names(attrs)
    all_names = arg_names + op.get_aux_names(attrs)

    name = _name_mod.current().get(name, op.name.lower().lstrip("_"))
    raw = attribute.current().get(attr)

    slots = {}
    for i, s in enumerate(sym_args):
        if i >= len(all_names):
            raise MXNetError("%s: too many positional inputs" % op_name)
        slots[all_names[i]] = s
    for k, v in sym_kwargs.items():
        if k in slots:
            raise MXNetError("%s: duplicate input %r" % (op_name, k))
        slots[k] = v

    inputs = []
    for nm in all_names:
        s = slots.get(nm)
        if s is None:
            # missing parameter inputs become variables, as in the reference
            s = Variable("%s_%s" % (name, nm))
        if not isinstance(s, Symbol):
            raise TypeError("%s: input %r must be a Symbol" % (op_name, nm))
        inputs.append(s._single_entry())

    node = _Node(op, name, attrs=attrs, raw_attr=raw, inputs=inputs,
                 num_args=len(arg_names))
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_sym_function(op):
    def fn(*args, name=None, attr=None, **kwargs):
        sym_args = []
        for a in args:
            if not isinstance(a, Symbol):
                raise TypeError("positional inputs must be Symbols")
            sym_args.append(a)
        sym_kwargs, attr_kwargs = {}, {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                attr_kwargs[k] = v
        return _create(op.name, name, attr, sym_args, attr_kwargs, sym_kwargs)
    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _register_sym_functions():
    g = globals()
    for opname in _registry.list_ops():
        g[opname] = _make_sym_function(get_op(opname))
    for alias, target in _registry.aliases().items():
        g[alias] = g[target]


_register_sym_functions()


def zeros(shape, dtype="float32", name=None, **kwargs):
    """A zeros source node; a 0 in ``shape`` is the batch dimension, filled
    in when the graph runs (the RNN cells' begin state).  Meta keyword
    arguments (``__layout__``) become node attributes."""
    attr = {k: str(v) for k, v in kwargs.items()
            if k.startswith("__") and k.endswith("__")}
    return _create("_zeros", name, attr or None, [],
                   {"shape": tuple(shape), "dtype": dtype})


def ones(shape, dtype="float32", name=None, **kwargs):
    """As :func:`zeros`, with ones."""
    attr = {k: str(v) for k, v in kwargs.items()
            if k.startswith("__") and k.endswith("__")}
    return _create("_ones", name, attr or None, [],
                   {"shape": tuple(shape), "dtype": dtype})


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", name=None):
    return _create("_arange", name, None, [],
                   {"start": start, "stop": stop, "step": step,
                    "repeat": repeat, "dtype": dtype})


# ---------------------------------------------------------------- loading
def load_json(json_str):
    """Deserialize from the reference JSON layout."""
    data = json.loads(json_str)
    built = []
    for entry in data["nodes"]:
        raw_attr = dict(entry.get("attrs", entry.get("attr", {}) or {}))
        if entry["op"] == "null":
            node = _Node(None, entry["name"], raw_attr=raw_attr)
        else:
            op = get_op(entry["op"])
            params = {k: v for k, v in raw_attr.items()
                      if not k.startswith(_META_PREFIX)}
            meta = {k: v for k, v in raw_attr.items()
                    if k.startswith(_META_PREFIX)}
            attrs = op.parse_attrs(params)
            inputs = [(built[src], idx)
                      for (src, idx, *_rest) in entry["inputs"]]
            node = _Node(op, entry["name"], attrs=attrs, raw_attr=meta,
                         inputs=inputs,
                         num_args=len(op.get_arg_names(attrs)))
        built.append(node)
    return Symbol([(built[i], idx) for (i, idx, *_r) in data["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
