"""Executor: a Symbol bound to argument arrays on one device, forward only.

The counterpart of ``mxnet_tpu/executor.py``.  Where the JAX executor
compiles the graph into one XLA program, this one runs it op by op in
PyTorch under ``torch.inference_mode()``; the hand-written kernels are
reached through the ops that wrap them.  Gradients are not yet ported.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import NDArray, zeros as _nd_zeros
from .symbol import eval_graph, _classify_vars

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
    def __init__(self, symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else current_context()
        self._device = self._ctx.torch_device()
        self._topo = symbol._topo()
        self._arg_nodes, self._aux_nodes = _classify_vars(self._topo)
        self._arg_names = [n.name for n in self._arg_nodes]
        self._aux_names = [n.name for n in self._aux_nodes]

        self.arg_dict = _normalize(args, self._arg_names, "args")
        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing argument arrays for %s" % missing)
        self.aux_dict = _normalize(aux_states, self._aux_names, "aux_states")
        for n in self._aux_names:
            if n not in self.aux_dict:
                raise MXNetError("bind: missing auxiliary state %r" % n)
        for kind, d in (("argument", self.arg_dict),
                        ("auxiliary state", self.aux_dict)):
            for n, arr in d.items():
                if arr.data.device != self._device:
                    raise MXNetError(
                        "bind: %s %r lies on %s, the executor on %s"
                        % (kind, n, arr.data.device, self._device))
        self._outputs = None

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs

    def forward(self, is_train=False, **kwargs):
        """Run the graph forward; ``kwargs`` update named input arrays in
        place.  Training mode is not yet ported."""
        if is_train:
            raise MXNetError("forward(is_train=True) is not yet ported to "
                             "mxnet_tpu_torch")
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown input %r" % k)
            self.arg_dict[k][:] = v.data if isinstance(v, NDArray) \
                else np.asarray(v)
        var_values = {id(n): self.arg_dict[n.name].data
                      for n in self._arg_nodes}
        var_values.update({id(n): self.aux_dict[n.name].data
                           for n in self._aux_nodes})
        with torch.inference_mode():
            heads, _aux = eval_graph(self._topo, self._symbol._entries,
                                     var_values, is_train=False,
                                     device=self._device)
        self._outputs = [NDArray(h) for h in heads]
        return self._outputs

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new Executor at new input shapes, sharing the arrays whose
        shapes are unchanged."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args, new_aux = {}, {}
        for n, s in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[n]
            if tuple(cur.shape) == tuple(s):
                new_args[n] = cur
                continue
            if not (partial_shaping or n in kwargs):
                raise MXNetError("unexpected shape change for %r" % n)
            old_size, new_size = cur.size, int(np.prod(s, dtype=np.int64))
            if new_size > old_size and not allow_up_sizing:
                raise MXNetError(
                    "new shape of arg %r larger than original; set "
                    "allow_up_sizing=True to allocate new arrays" % n)
            if new_size == old_size:
                new_args[n] = cur.reshape(s)
            else:
                new_args[n] = _nd_zeros(s, ctx=self._ctx,
                                        dtype=cur.data.dtype)
        for n, s in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict[n]
            new_aux[n] = cur if tuple(cur.shape) == tuple(s) else \
                _nd_zeros(s, ctx=self._ctx, dtype=cur.data.dtype)
        return Executor(self._symbol, self._ctx, new_args,
                        aux_states=new_aux)
