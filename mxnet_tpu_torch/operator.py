"""Custom Python operators: the counterpart of ``mxnet_tpu/operator.py``
(the reference's ``python/mxnet/operator.py``).

A ``CustomOpProp`` subclass registered with :func:`register` declares an
op's arguments, outputs, shapes and types; its ``create_operator`` gives
the ``CustomOp`` whose ``forward``/``backward`` run on the host on numpy
arrays.  ``mx.sym.Custom(..., op_type=name)`` puts it in a graph.

The ``Custom`` op's body copies its inputs to the host, runs the prop's
numpy code and copies the outputs back to the inputs' device, under a
``torch.autograd.Function`` whose backward calls the op's ``backward``
the same way: the reference's design, where the engine hands the Python
callbacks host memory.  A prop with a ``device_forward(is_train, args)``
method (the torch bridge's, :mod:`mxnet_tpu_torch.torch`) is called with
the input tensors on their device instead and returns the outputs as
tensors, differentiated by autograd: no host round trip.  ``Custom.host_calls`` counts these host round
trips (one a forward, one a backward).  On the ``meta`` device
(``Symbol.infer_shape``) the body answers from ``infer_shape`` and
``infer_type`` and never calls ``forward``.  As in the JAX package the op
is stateless between calls: ``create_operator`` runs at every call, and
auxiliary states pass through unchanged.  The port keeps its own registry
of props.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, dtype_np, torch_dtype
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_CUSTOM_PROPS = {}


class CustomOp:
    """Base class of a custom operator's host computation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for g, r in zip(in_grad, req):
            self.assign(g, r, np.zeros(g.shape, g.dtype))

    def assign(self, dst, req, src):
        """Write ``src`` to ``dst`` as ``req`` asks: ``'write'``/
        ``'inplace'`` replace, ``'add'`` adds, ``'null'`` skips."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("invalid req %s" % req)


class CustomOpProp:
    """Declares a custom operator's arguments, outputs, shapes, types and
    backward dependencies."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a ``CustomOpProp`` class under ``reg_name`` (the
    ``op_type`` of ``mx.sym.Custom``)."""
    def do_register(prop_cls):
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered():
    return dict(_CUSTOM_PROPS)


class _HostNDArray:
    """The numpy-backed array handed to ``CustomOp.forward``/``backward``."""

    def __init__(self, arr):
        self._arr = np.array(arr)

    def asnumpy(self):
        return self._arr

    @property
    def shape(self):
        return self._arr.shape

    @property
    def dtype(self):
        return self._arr.dtype

    def __setitem__(self, key, value):
        self._arr[key] = value.asnumpy() if isinstance(value, _HostNDArray) \
            else np.asarray(value)

    def __getitem__(self, key):
        return self._arr[key]

    def __add__(self, other):
        o = other.asnumpy() if isinstance(other, _HostNDArray) else other
        return self._arr + o


def _make_prop(attrs):
    name = attrs.get("op_type")
    if name not in _CUSTOM_PROPS:
        raise MXNetError("custom op type %r is not registered" % name)
    kwargs = {k: str(v) for k, v in attrs.items()
              if k != "op_type" and v is not None}
    try:
        return _CUSTOM_PROPS[name](**kwargs)
    except TypeError:
        return _CUSTOM_PROPS[name]()


def _custom_arg_names(attrs):
    return tuple(_make_prop(attrs).list_arguments())


def _custom_aux_names(attrs):
    return tuple(_make_prop(attrs).list_auxiliary_states())


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _to_host(t):
    return t.detach().cpu().numpy()


def _to_device(a, like):
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


class _HostCall(torch.autograd.Function):
    """The prop's numpy forward, and its backward, on host copies."""

    @staticmethod
    def forward(fctx, spec, *tensors):
        prop, is_train, in_shapes, in_types, out_specs, n_args = spec
        host = [_to_host(t) for t in tensors]
        Custom.host_calls += 1
        op = prop.create_operator(None, in_shapes, in_types)
        in_data = [_HostNDArray(a) for a in host[:n_args]]
        aux = [_HostNDArray(a) for a in host[n_args:]]
        out_data = [_HostNDArray(np.zeros(s, t)) for s, t in out_specs]
        op.forward(is_train, ["write"] * len(out_data), in_data, out_data,
                   aux)
        outs = [o.asnumpy() for o in out_data]
        fctx.spec, fctx.host, fctx.host_out = spec, host, outs
        fctx.like = tensors[0]
        return tuple(_to_device(o, tensors[0]) for o in outs)

    @staticmethod
    def backward(fctx, *grads):
        prop, _is_train, in_shapes, in_types, _outs, n_args = fctx.spec
        host = fctx.host
        Custom.host_calls += 1
        op = prop.create_operator(None, in_shapes, in_types)
        in_grad = [_HostNDArray(np.zeros_like(a)) for a in host[:n_args]]
        op.backward(["write"] * n_args,
                    [_HostNDArray(_to_host(g)) for g in grads],
                    [_HostNDArray(a) for a in host[:n_args]],
                    [_HostNDArray(o) for o in fctx.host_out], in_grad,
                    [_HostNDArray(a) for a in host[n_args:]])
        return (None,) + tuple(_to_device(g.asnumpy(), fctx.like)
                               for g in in_grad) \
            + (None,) * (len(host) - n_args)


@_register_op("Custom", arg_names=_custom_arg_names,
              aux_names=_custom_aux_names,
              num_outputs=_custom_num_outputs,
              params={"op_type": None})
def Custom(attrs, octx, *inputs):
    """The ``Custom`` op: the registered prop's host computation."""
    prop = _make_prop(attrs)
    n_args = len(prop.list_arguments())
    args, aux = inputs[:n_args], inputs[n_args:]
    in_shapes = [list(a.shape) for a in args]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    in_types = [dtype_np(a.dtype) for a in args]
    _, out_types, _ = prop.infer_type(in_types)
    out_specs = [(tuple(int(d) for d in s), dtype_np(t))
                 for s, t in zip(out_shapes, out_types)]
    dev = args[0].device
    if dev.type != "meta" and hasattr(prop, "device_forward"):
        outs = prop.device_forward(bool(octx.is_train), list(args))
    elif dev.type == "meta":
        outs = tuple(torch.empty(s, dtype=torch_dtype(t), device=dev)
                     for s, t in out_specs)
    else:
        spec = (prop, bool(octx.is_train), in_shapes, in_types, out_specs,
                n_args)
        outs = _HostCall.apply(spec, *args, *aux)
    return tuple(outs) + tuple(aux)


Custom.host_calls = 0
