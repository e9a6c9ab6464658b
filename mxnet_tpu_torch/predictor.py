"""Standalone inference predictor.

The counterpart of ``mxnet_tpu/predictor.py``: create from symbol JSON and
parameters, set inputs, forward, get outputs; partial batches are padded up
to the bound batch and the pad rows sliced off the outputs.

Two deliberate differences from the JAX package:

* ``ctx=None`` binds on ``gpu(0)`` (the JAX Predictor defaults to
  ``cpu()``): the port runs on the card unless the caller asks for the CPU.
* An output whose leading dim folds the batch with another dim (the GPT's
  ``(batch * seq, vocab)`` head) is sliced by whole sequences: ``rows`` input
  rows keep ``rows * (out_rows // batch)`` output rows.  The JAX package
  slices such an output by input rows, which cuts into the first sequence.
"""
from __future__ import annotations

import logging

import numpy as np

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym_mod
from .context import gpu

__all__ = ["Predictor", "pad_batch", "slice_rows"]

log = logging.getLogger(__name__)


def pad_batch(value, batch):
    """Zero-pad ``value`` along axis 0 to ``batch`` rows (the pad half of
    pad-and-slice).  Inference graphs are row-independent, so pad rows cost
    compute but never reach real rows' outputs."""
    arr = np.asarray(value)
    if arr.ndim == 0:
        raise MXNetError("pad_batch needs a batched array, got a scalar")
    rows = arr.shape[0]
    if rows == batch:
        return arr
    if rows > batch:
        raise MXNetError("pad_batch: %d rows exceed the target batch %d"
                         % (rows, batch))
    pad = np.zeros((batch - rows,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def slice_rows(out, start, rows, batch):
    """Rows ``[start, start + rows)`` of a batch of ``batch`` input rows,
    taken from an output whose axis 0 is ``batch * k`` (k output rows per
    input row; k = 1 for most nets, the sequence length for the GPT)."""
    if not getattr(out, "ndim", 0) or out.shape[0] % batch:
        return out
    k = out.shape[0] // batch
    return out[start * k:(start + rows) * k]


class Predictor:
    """Load a checkpoint and run inference (reference MXPredCreate /
    MXPredForward / MXPredGetOutput)."""

    def __init__(self, symbol_json, param_bytes_or_dict, input_shapes,
                 ctx=None):
        """
        symbol_json: JSON string or path of the network (``*-symbol.json``).
        param_bytes_or_dict: path to ``*.params``, its bytes, or
        {name: NDArray}.
        input_shapes: dict name -> shape.
        ctx: device context; default ``gpu(0)``.
        """
        if symbol_json.strip().startswith("{"):
            symbol = sym_mod.load_json(symbol_json)
        else:
            symbol = sym_mod.load(symbol_json)
        self._symbol = symbol
        self._ctx = ctx = ctx or gpu(0)
        ctx.torch_device()       # no card and no explicit cpu(): raise now

        if isinstance(param_bytes_or_dict, str):
            loaded = nd.load(param_bytes_or_dict, ctx=ctx)
        elif isinstance(param_bytes_or_dict, (bytes, bytearray)):
            loaded = nd.load_buffer(bytes(param_bytes_or_dict), ctx=ctx)
        else:
            loaded = dict(param_bytes_or_dict)
        if not isinstance(loaded, dict):
            raise MXNetError(
                "params were saved as an unnamed list; the predictor needs "
                "the name->array dict form (save with a dict)")
        params = {k.split(":", 1)[1] if ":" in k else k: v.as_in_context(ctx)
                  for k, v in loaded.items()}

        self._input_names = list(input_shapes)
        self._inert = self._inert_labels(symbol, input_shapes)
        shapes = self._with_inert(input_shapes)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in input_shapes:
                args[name] = nd.zeros(shape, ctx=ctx)
            elif name in params:
                args[name] = params[name]
            elif name.endswith("label"):
                # loss heads keep their label inputs, which are inert at
                # inference; only label-named args are zero-filled, so a
                # missing weight stays a loud error
                log.warning("Predictor: zero-filling inference-inert "
                            "input %r", name)
                args[name] = nd.zeros(shape, ctx=ctx)
            else:
                raise MXNetError("missing parameter %r" % name)
        aux = {name: params[name] if name in params
               else nd.zeros(shape, ctx=ctx)
               for name, shape in zip(symbol.list_auxiliary_states(),
                                      aux_shapes)}
        self._partial_rows = {}
        self._executor = symbol.bind(ctx, args, grad_req="null",
                                     aux_states=aux)

    @staticmethod
    def _inert_labels(symbol, input_shapes):
        """Label-named arguments whose shape the graph cannot infer from
        the inputs (the GPT's ``softmax_label`` feeds a Reshape before the
        loss head).  They are inert at inference; each is bound at the
        first input's shape, the layout of per-token labels."""
        arg_shapes, _, _ = symbol.infer_shape_partial(**input_shapes)
        return [n for n, s in zip(symbol.list_arguments(), arg_shapes)
                if s is None and n.endswith("label")
                and n not in input_shapes]

    def _with_inert(self, input_shapes):
        shapes = dict(input_shapes)
        first = tuple(input_shapes[self._input_names[0]])
        for n in self._inert:
            shapes[n] = first
        return shapes

    @property
    def context(self):
        return self._ctx

    def set_input(self, name, value):
        """Stage one named input.  A batch SMALLER than the bound one is
        zero-padded (:func:`pad_batch`) and the pad rows are sliced off the
        outputs by :meth:`get_output`; a LARGER one is an error that points
        at :meth:`reshaped` and the serving batch ladder."""
        if name not in self._input_names:
            raise MXNetError("unknown input %r" % name)
        arr = self._executor.arg_dict[name]
        bound = tuple(arr.shape)
        value = np.asarray(value)
        if value.ndim == len(bound) and value.shape != bound:
            if value.shape[1:] != bound[1:]:
                raise MXNetError(
                    "input %r: non-batch dims %r do not match the bound "
                    "shape %r; reshape the predictor (reshaped()) for a "
                    "different feature shape" % (name, value.shape, bound))
            rows, cap = value.shape[0], bound[0]
            if rows > cap:
                raise MXNetError(
                    "input %r: batch %d exceeds the bound batch %d; use "
                    "reshaped({%r: %r}) for a second handle, or the "
                    "serving batch ladder (mxnet_tpu_torch.serving)"
                    % (name, rows, cap, name, (rows,) + bound[1:]))
            value = pad_batch(value, cap)
            self._partial_rows[name] = rows
        else:
            self._partial_rows.pop(name, None)
        arr[:] = value

    def forward(self, **inputs):
        for k, v in inputs.items():
            self.set_input(k, v)
        self._executor.forward(is_train=False)
        return self

    def get_output(self, index=0):
        """Fetch one output as numpy; pad rows staged by a partial-batch
        :meth:`set_input` are sliced off (see :func:`slice_rows`)."""
        out = self._executor.outputs[index].asnumpy()
        if self._partial_rows:
            batch = self._executor.arg_dict[self._input_names[0]].shape[0]
            out = slice_rows(out, 0, min(self._partial_rows.values()), batch)
        return out

    def reshaped(self, input_shapes):
        """A NEW Predictor bound at ``input_shapes`` over the same weights,
        leaving this one untouched (reference MXPredReshape)."""
        clone = object.__new__(Predictor)
        clone._symbol = self._symbol
        clone._ctx = self._ctx
        clone._partial_rows = {}
        clone._input_names = list(self._input_names)
        clone._inert = list(self._inert)
        shapes = {n: tuple(self._executor.arg_dict[n].shape)
                  for n in self._input_names}
        shapes.update(input_shapes)
        clone._executor = self._executor.reshape(
            allow_up_sizing=True, partial_shaping=True,
            **clone._with_inert(shapes))
        return clone
