"""Executor: a Symbol bound to argument, gradient and auxiliary arrays on
one device.

The counterpart of ``mxnet_tpu/executor.py``.  Where the JAX executor
compiles forward, vjp and the fused step into XLA programs, this one runs
the graph op by op in PyTorch; the hand-written kernels are reached through
the ops that wrap them (``_contrib_FlashAttention`` forward and backward).

* ``forward(is_train=False)`` runs under ``torch.inference_mode()``, as
  serving does.
* ``forward(is_train=True)`` runs under autograd: every argument whose
  ``grad_req`` is not ``'null'`` enters the graph as a leaf that shares its
  argument's storage, stochastic ops draw from :mod:`.random`'s generator
  of the device, and the graph is kept for :meth:`backward`.  BatchNorm's
  new moving statistics replace the auxiliary arrays' tensors (fresh
  tensors: the backward may still read the old ones, which autograd
  saved), as the JAX executor returns ``new_aux``.
* ``backward(out_grads=None)`` seeds loss heads with ones and the other
  heads with zeros (or takes ``out_grads`` for every head) and sums the
  gradients straight into the bound grad arrays, which autograd takes as
  the leaves' ``.grad``: ``'write'`` zeroes them first, ``'add'`` adds to
  what they hold, ``'null'`` has none.  No second copy of the gradients is
  made.

Block fusion (``ops.fused.block_fusion``) is captured at bind time and
applied around every run of the graph, as in the JAX executor.

``strict=True`` (or ``MXNET_TPU_STRICT_BIND=1``) runs the graph verifier
(:mod:`.analysis`) over the bound shapes and dtypes before any op runs and
raises naming the offending node; with a memory budget armed
(``MXNET_TPU_MEMORY_BUDGET`` > 0 and a known capacity) it also runs the
static liveness pass, refuses an over-budget graph (MXG017) and records
the prediction; an inference bind's first forward then registers the
allocator's peak against it (``mxtpu_memlive_drift_ratio``).  ``forward``
and ``backward`` are the ``executor.forward`` / ``executor.backward``
cost-database seams (:mod:`.telemetry.costdb`).

``set_monitor_callback(callback)`` calls ``callback(name, NDArray)`` with
every op output of each forward (the graph then runs unfused): the JAX
executor's eager monitor route.  ``set_stats_monitor(callback, pattern)``
is its numerics route: each matched output's ``telemetry.numerics`` stat
bundle, fetched in one transfer a forward.  ``forward`` and ``backward``
are ``executor.forward`` / ``executor.backward`` telemetry spans.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import NDArray, zeros as _nd_zeros
from .analysis import fusion as _fusion
from .ops import fused as _fused
from .symbol import eval_graph, _classify_vars
from . import random as _random
from . import telemetry
from .telemetry import costdb as _costdb, memory as _tmem
from .telemetry import numerics as _numerics

__all__ = ["Executor"]


def _normalize(values, names, kind):
    """Accept a list ordered by ``names`` or a dict; return a dict."""
    if values is None:
        return {}
    if isinstance(values, dict):
        return dict(values)
    if isinstance(values, (list, tuple)):
        if len(values) != len(names):
            raise MXNetError("%s: expected %d arrays, got %d"
                             % (kind, len(names), len(values)))
        return dict(zip(names, values))
    raise TypeError("%s must be list or dict" % kind)


class Executor:
    #: Executors made so far in the process (binds, ``reshape`` included)
    binds = 0

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, strict=False):
        if group2ctx:
            raise MXNetError("Executor: group2ctx (model-parallel placement) "
                             "is not yet ported to mxnet_tpu_torch")
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else current_context()
        self._device = self._ctx.torch_device()
        self._topo = symbol._topo()
        self._arg_nodes, self._aux_nodes = _classify_vars(self._topo)
        self._arg_names = [n.name for n in self._arg_nodes]
        self._aux_names = [n.name for n in self._aux_nodes]
        self._output_names = symbol.list_outputs()

        self.arg_dict = _normalize(args, self._arg_names, "args")
        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing argument arrays for %s" % missing)
        self.aux_dict = _normalize(aux_states, self._aux_names, "aux_states")
        for n in self._aux_names:
            if n not in self.aux_dict:
                raise MXNetError("bind: missing auxiliary state %r" % n)

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self._arg_names}
        bad = {r for r in self._grad_req.values()
               if r not in ("write", "add", "null")}
        if bad:
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %s" % sorted(bad))
        self.grad_dict = _normalize(args_grad, self._arg_names, "args_grad")
        for n, req in self._grad_req.items():
            if req != "null" and self.grad_dict.get(n) is None:
                src = self.arg_dict[n]
                self.grad_dict[n] = _nd_zeros(src.shape, ctx=self._ctx,
                                              dtype=src.data.dtype)
        for kind, d in (("argument", self.arg_dict),
                        ("auxiliary state", self.aux_dict),
                        ("gradient", self.grad_dict)):
            for n, arr in d.items():
                if arr is not None and arr.data.device != self._device:
                    raise MXNetError(
                        "bind: %s %r lies on %s, the executor on %s"
                        % (kind, n, arr.data.device, self._device))

        self._memlive_program = None
        from . import config as _config
        if strict or _config.get_bool("MXNET_TPU_STRICT_BIND"):
            self._strict_check()
        self._costdb_scope = _costdb.next_scope()
        self._cost = {}

        # captured here and applied around every run of the graph
        self._block_fusion = _fused.block_fusion_enabled()
        # the plan search's decisions: an ambient plan_decisions context is
        # captured like the fusion flag; otherwise the committed graph_plan
        # entry for this graph (structural digest, image layout, backend) is
        # consulted once here, and a hit plans every run below by it (a
        # miss, or MXNET_TPU_PLAN_SEARCH=off, plans greedily)
        self._plan_decisions = _fusion.active_decisions()
        if self._plan_decisions is None and self._block_fusion:
            from .analysis import plansearch as _plansearch
            from .ops.nn import current_image_layout
            self._plan_decisions = _plansearch.committed_decisions(
                self._topo, symbol._entries, current_image_layout(),
                backend=_costdb.backend_name(self._device))
        self._head_is_loss = [bool(node.op is not None and node.op.is_loss)
                              for (node, _i) in symbol._entries]
        self._outputs = None
        self._train_heads = None     # the heads of the last training forward
        self._leaves = None          # and its leaves, until backward
        self._monitor_callback = None
        self._stats_cb = None
        self._stats_pattern = None
        self._stats_active = None
        Executor.binds += 1

    def _strict_check(self):
        """The strict bind: the graph verifier over the exact shapes and
        dtypes bound, before any op runs, and the memory-liveness leg
        when a budget signal exists (the JAX executor's check)."""
        from .analysis import verify_symbol
        shapes = {n: tuple(self.arg_dict[n].shape) for n in self._arg_names}
        shapes.update({n: tuple(self.aux_dict[n].shape)
                       for n in self._aux_names})
        types = {n: self.arg_dict[n].data.dtype for n in self._arg_names}
        types.update({n: self.aux_dict[n].data.dtype
                      for n in self._aux_names})
        memory = None
        if _tmem.budget_fraction() > 0 \
                and _tmem.device_capacity_bytes(self._device):
            is_train = any(req != "null" for req in self._grad_req.values())
            self._memlive_program = ("executor.fused" if is_train
                                     else "executor.forward")
            memory = {
                "is_train": is_train,
                "inputs": {n for n in self._arg_names
                           if self._grad_req.get(n) == "null"},
                "donate": (), "record": True,
                "program": self._memlive_program,
            }
        verify_symbol(self._symbol, shapes=shapes, types=types,
                      memory=memory).raise_if_errors("bind strict=True")

    def _bound_bytes(self):
        """Bytes of the bound argument and auxiliary arrays."""
        return sum(a.data.numel() * a.data.element_size()
                   for a in list(self.arg_dict.values())
                   + list(self.aux_dict.values()))

    def _program_cost(self, passes):
        """Analytic ``(flops, bytes)`` of one forward (``passes=1``) or
        backward (2) at the bound shapes (the costdb program records)."""
        hit = self._cost.get(passes)
        if hit is None:
            from .analysis.perf import graph_cost
            shapes = {n: tuple(self.arg_dict[n].shape)
                      for n in self._arg_names}
            types = {n: self.arg_dict[n].data.dtype for n in self._arg_names}
            hit = self._cost[passes] = graph_cost(
                self._symbol, shapes, types, passes=passes)
        return hit

    # ------------------------------------------------------------ properties
    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) if self._grad_req[n] != "null" else None
                for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def grad_req(self):
        return dict(self._grad_req)

    # ------------------------------------------------------------------ run
    def _set_inputs(self, kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %r" % k)
            self.arg_dict[k][:] = v if isinstance(v, NDArray) \
                else np.asarray(v)

    def _run(self, var_values, is_train):
        first = self.arg_dict[self._arg_names[0]] if self._arg_names \
            else None
        batch = first.shape[0] if first is not None and first.shape \
            else None
        monitor = None
        stats = None
        if self._monitor_callback is not None:
            cb = self._monitor_callback

            def monitor(name, val):
                cb(name, NDArray(val.detach()))
        elif self._stats_cb is not None and (
                self._stats_active is None or self._stats_active()):
            stats = {}
            pattern = self._stats_pattern

            def monitor(name, val):
                if pattern.match(str(name)):
                    stats[str(name)] = _numerics.tensor_stats(val)
        with _fused.block_fusion(self._block_fusion), \
                _fusion.plan_decisions(self._plan_decisions):
            out = eval_graph(self._topo, self._symbol._entries, var_values,
                             is_train=is_train, device=self._device,
                             generator=_random.generator(self._device)
                             if is_train else None, batch_size=batch,
                             monitor=monitor)
        if stats:
            self._deliver_stats(stats)
        return out

    def _deliver_stats(self, stats):
        """Fetch every matched output's stat bundle in one transfer, run
        the numerics anomaly pass over them, then the callback per name in
        graph order."""
        names = list(stats)
        keys = ("l2", "mean_abs", "max_abs", "nonfinite", "zero_frac")
        flat = torch.stack([stats[n][k].detach().double().reshape(())
                            for n in names for k in keys]).cpu().tolist()
        host = {}
        for i, n in enumerate(names):
            vals = flat[i * len(keys):(i + 1) * len(keys)]
            host[n] = {k: (int(v) if k == "nonfinite" else float(v))
                       for k, v in zip(keys, vals)}
        _numerics.note_monitored(host, program="executor.forward_stats")
        for n in names:
            self._stats_cb(n, host[n])

    def set_stats_monitor(self, callback, pattern=".*", active=None):
        """Call ``callback(name, stats)`` per op output matching
        ``pattern`` with its ``telemetry.numerics`` bundle (``l2``,
        ``mean_abs``, ``max_abs``, ``nonfinite``, ``zero_frac`` floats),
        computed on the device as the forward runs and fetched in one
        transfer at its end; non-finite values feed the numerics anomaly
        rules.  ``active``: a zero-arg gate (a Monitor's interval); when it
        returns False the forward runs unmonitored.  ``callback=None``
        uninstalls.  The JAX executor computes the same bundle inside its
        compiled forward; a ``set_monitor_callback`` callback takes
        precedence."""
        import re as _re
        self._stats_cb = callback
        self._stats_pattern = (pattern if hasattr(pattern, "match")
                               else _re.compile(pattern))
        self._stats_active = active

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` with every op output of each
        later forward, or stop with ``callback=None``.  ``monitor_all`` is
        accepted, as by the JAX executor, which also passes op outputs
        only."""
        self._monitor_callback = callback

    def forward(self, is_train=False, **kwargs):
        """Run the graph forward; ``kwargs`` update named input arrays in
        place.  Returns the outputs.  An ``executor.forward`` span."""
        with telemetry.span("executor.forward", category="executor"):
            program = "executor.forward"
            obs = _costdb.begin_dispatch(
                program, key=(self._costdb_scope, id(self)),
                device=self._device)
            measure = None
            if self._memlive_program == "executor.forward" and not is_train:
                # the first inference dispatch after a strict bind: the
                # allocator's peak is the static prediction's yardstick
                measure = _tmem.measured_dispatch(
                    self._memlive_program, self._device, self._bound_bytes())
                self._memlive_program = None
            try:
                if measure is None:
                    out = self._forward(is_train, kwargs)
                else:
                    with measure:
                        out = self._forward(is_train, kwargs)
            except BaseException:
                _costdb.end_dispatch(obs, failed=True)
                raise
            _costdb.end_dispatch(obs, args=self.arg_dict,
                                 cost=lambda: self._program_cost(1))
            return out

    def _forward(self, is_train, kwargs):
        self._set_inputs(kwargs)
        aux_values = {id(n): self.aux_dict[n.name].data
                      for n in self._aux_nodes}
        if not is_train:
            self._train_heads = self._leaves = None
            var_values = {id(n): self.arg_dict[n.name].data
                          for n in self._arg_nodes}
            var_values.update(aux_values)
            with torch.inference_mode():
                heads, _aux = self._run(var_values, False)
            self._outputs = [NDArray(h) for h in heads]
            return self._outputs
        leaves = {}
        var_values = dict(aux_values)
        for n in self._arg_nodes:
            t = self.arg_dict[n.name].data
            if self._grad_req[n.name] != "null" and t.is_floating_point():
                t = t.detach().requires_grad_(True)
                leaves[n.name] = t
            var_values[id(n)] = t
        self._train_heads = self._leaves = None    # drop an unused graph
        with torch.enable_grad():
            heads, aux_upd = self._run(var_values, True)
        for n in self._aux_nodes:
            upd = aux_upd.get(id(n))
            if upd is not None:
                arr = self.aux_dict[n.name]
                arr._data = upd.detach().to(arr.data.dtype)
        self._train_heads, self._leaves = heads, leaves
        self._outputs = [NDArray(h.detach()) for h in heads]
        return self._outputs

    def backward(self, out_grads=None):
        """Gradients of the last ``forward(is_train=True)`` into the bound
        grad arrays.  ``out_grads``: one gradient per head (NDArrays or
        tensors), else ones for loss heads and zeros for the others.  An
        ``executor.backward`` span."""
        with telemetry.span("executor.backward", category="executor"):
            obs = _costdb.begin_dispatch(
                "executor.backward", key=(self._costdb_scope, id(self)),
                device=self._device)
            try:
                out = self._backward(out_grads)
            except BaseException:
                _costdb.end_dispatch(obs, failed=True)
                raise
            _costdb.end_dispatch(obs, args=self.arg_dict,
                                 cost=lambda: self._program_cost(2))
            return out

    def _backward(self, out_grads):
        if self._outputs is None:
            raise MXNetError("call forward(is_train=True) before backward()")
        if self._train_heads is None:
            raise MXNetError("backward() requires forward(is_train=True)")
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        heads, leaves = self._train_heads, self._leaves
        self._train_heads = self._leaves = None
        if out_grads is not None:
            if len(out_grads) != len(heads):
                raise MXNetError("backward: %d head gradients for %d heads"
                                 % (len(out_grads), len(heads)))
            cot = [g.data if isinstance(g, NDArray) else torch.as_tensor(g)
                   for g in out_grads]
            pairs = [(h, c.to(device=h.device, dtype=h.dtype))
                     for h, c in zip(heads, cot) if h.requires_grad]
        else:
            pairs = [(h, torch.ones_like(h))
                     for h, il in zip(heads, self._head_is_loss)
                     if il and h.requires_grad]
        for name, leaf in leaves.items():
            grad = self.grad_dict[name].data
            if self._grad_req[name] == "write":
                grad.zero_()
            leaf.grad = grad        # autograd sums into it in place
        if pairs:
            torch.autograd.backward([h for h, _c in pairs],
                                    [c for _h, c in pairs])
        for leaf in leaves.values():
            leaf.grad = None

    def forward_backward(self, **kwargs):
        """``forward(is_train=True)`` then ``backward()``; returns the
        outputs."""
        self.forward(is_train=True, **kwargs)
        self.backward()
        return self._outputs

    # -------------------------------------------------------------- utility
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError("unknown argument %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                self.aux_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError("unknown aux state %r" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new Executor at new input shapes, sharing the arrays whose
        shapes are unchanged (and reshaping those whose size is)."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args, new_grads, new_aux = {}, {}, {}
        for n, s in zip(self._arg_names, arg_shapes):
            cur, grad = self.arg_dict[n], self.grad_dict.get(n)
            if tuple(cur.shape) == tuple(s):
                new_args[n] = cur
                if grad is not None:
                    new_grads[n] = grad
                continue
            if not (partial_shaping or n in kwargs):
                raise MXNetError("unexpected shape change for %r" % n)
            old_size, new_size = cur.size, int(np.prod(s, dtype=np.int64))
            if new_size > old_size and not allow_up_sizing:
                raise MXNetError(
                    "new shape of arg %r larger than original; set "
                    "allow_up_sizing=True to allocate new arrays" % n)
            same = new_size == old_size
            new_args[n] = cur.reshape(s) if same else _nd_zeros(
                s, ctx=self._ctx, dtype=cur.data.dtype)
            if self._grad_req.get(n, "null") != "null":
                new_grads[n] = grad.reshape(s) \
                    if same and grad is not None else _nd_zeros(
                        s, ctx=self._ctx, dtype=cur.data.dtype)
        for n, s in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict[n]
            new_aux[n] = cur if tuple(cur.shape) == tuple(s) else \
                _nd_zeros(s, ctx=self._ctx, dtype=cur.data.dtype)
        exe = Executor(self._symbol, self._ctx, new_args, new_grads,
                       self._grad_req, new_aux)
        exe.set_monitor_callback(self._monitor_callback)
        if self._stats_cb is not None:
            exe.set_stats_monitor(self._stats_cb, self._stats_pattern,
                                  self._stats_active)
        return exe

