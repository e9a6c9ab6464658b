"""Tensor ops: the subset of ``mxnet_tpu/ops/tensor.py`` that the GPT,
ResNet and RNN paths use: element-wise arithmetic with tensors and
scalars (the ``Symbol`` operators), ``where``, the init ops and the shape
ops.  Parameter names and defaults are the JAX package's, so a Symbol's
JSON is the same in both packages."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


@register("identity", aliases=("_copy",))
def identity(attrs, ctx, data):
    """The input itself (ResNet's ``sym.identity`` stem wrapper)."""
    return data


@register("elemwise_add", arg_names=("lhs", "rhs"), aliases=("_plus", "_add"))
def elemwise_add(attrs, ctx, lhs, rhs):
    return lhs + rhs


@register("broadcast_add", arg_names=("lhs", "rhs"),
          aliases=("broadcast_plus",))
def broadcast_add(attrs, ctx, lhs, rhs):
    return lhs + rhs


def _binary(name, fn, aliases=()):
    @register(name, arg_names=("lhs", "rhs"), aliases=aliases,
              doc="element-wise %s of two tensors" % name)
    def op(attrs, ctx, lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    return op


for _n, _f, _al in [
        ("elemwise_sub", torch.sub, ("_minus", "_sub")),
        ("elemwise_mul", torch.mul, ("_mul",)),
        ("elemwise_div", torch.div, ("_div",)),
        ("_power", torch.pow, ("pow",))]:
    _binary(_n, _f, _al)


@register("negative")
def negative(attrs, ctx, data):
    return -data


def _scalar(name, fn):
    @register(name, params={"scalar": 0.0},
              doc="element-wise %s of a tensor and a scalar" % name)
    def op(attrs, ctx, data, _fn=fn):
        return _fn(data, float(attrs["scalar"]))
    return op


def _full(data, s):
    return torch.full((), s, dtype=data.dtype, device=data.device)


def _as(data, mask):
    """A comparison's boolean result in the input's dtype, as the
    reference returns it."""
    return mask.to(data.dtype)


for _n, _f in [
        ("_plus_scalar", lambda x, s: x + s),
        ("_minus_scalar", lambda x, s: x - s),
        ("_rminus_scalar", lambda x, s: s - x),
        ("_mul_scalar", lambda x, s: x * s),
        ("_div_scalar", lambda x, s: x / s),
        ("_rdiv_scalar", lambda x, s: s / x),
        ("_power_scalar", lambda x, s: x ** s),
        ("_rpower_scalar", lambda x, s: s ** x),
        # a tie passes half the gradient, as jnp.maximum's does
        ("_maximum_scalar", lambda x, s: torch.maximum(x, _full(x, s))),
        ("_minimum_scalar", lambda x, s: torch.minimum(x, _full(x, s))),
        ("_mod_scalar", lambda x, s: torch.remainder(x, s)),
        ("_equal_scalar", lambda x, s: _as(x, x == s)),
        ("_not_equal_scalar", lambda x, s: _as(x, x != s)),
        ("_greater_scalar", lambda x, s: _as(x, x > s)),
        ("_greater_equal_scalar", lambda x, s: _as(x, x >= s)),
        ("_lesser_scalar", lambda x, s: _as(x, x < s)),
        ("_lesser_equal_scalar", lambda x, s: _as(x, x <= s))]:
    _scalar(_n, _f)


@register("where", arg_names=("condition", "x", "y"))
def where(attrs, ctx, condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y``; a 1-d condition
    picks whole rows of ``x`` and ``y``."""
    cond = condition
    if cond.dim() == 1 and x.dim() > 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


@register("_zeros", arg_names=(), params={"shape": (), "dtype": "float32"},
          aliases=("zeros_like_op",))
def zeros_op(attrs, ctx):
    """Zeros of ``shape`` on the op context's device (a 0 in ``shape`` is
    the batch dimension, which ``eval_graph`` fills in first)."""
    return torch.zeros(tuple(attrs["shape"]),
                       dtype=torch_dtype(attrs["dtype"]), device=ctx.device)


@register("_ones", arg_names=(), params={"shape": (), "dtype": "float32"})
def ones_op(attrs, ctx):
    return torch.ones(tuple(attrs["shape"]),
                      dtype=torch_dtype(attrs["dtype"]), device=ctx.device)


@register("zeros_like")
def zeros_like(attrs, ctx, data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(attrs, ctx, data):
    return torch.ones_like(data)


@register("expand_dims", params={"axis": 0})
def expand_dims(attrs, ctx, data):
    return data.unsqueeze(int(attrs["axis"]))


def reshape_target(spec, src):
    """Resolve the reference's shape specials against the input shape:
    0 copies a dim, -1 infers one, -2 copies the rest, -3 merges two dims,
    -4 splits one dim into the next two entries."""
    out, i = [], 0
    it = iter(range(len(spec)))
    for k in it:
        s = spec[k]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            a, b = spec[k + 1], spec[k + 2]
            next(it); next(it)
            a = src[i] if a == -2 else a
            b = src[i] if b == -2 else b
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b]); i += 1
        else:
            out.append(int(s)); i += 1
    return tuple(out)


@register("Reshape", params={"shape": (), "reverse": False,
                             "target_shape": (), "keep_highest": False},
          aliases=("reshape",))
def reshape(attrs, ctx, data):
    spec = list(attrs["shape"]) or list(attrs["target_shape"])
    if not spec:
        return data
    return data.reshape(reshape_target(spec, list(data.shape)))


@register("slice_axis", params={"axis": 0, "begin": 0, "end": None})
def slice_axis(attrs, ctx, data):
    ax = int(attrs["axis"])
    n = data.shape[ax]
    begin = int(attrs["begin"])
    end = n if attrs["end"] is None else int(attrs["end"])
    if begin < 0:
        begin += n
    if end < 0:
        end += n
    return data.narrow(ax, begin, end - begin)


@register("_arange", arg_names=(),
          params={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                  "dtype": "float32"})
def arange_op(attrs, ctx):
    start, stop = attrs["start"], attrs["stop"]
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, attrs["step"],
                       dtype=torch_dtype(attrs["dtype"]), device=ctx.device)
    if int(attrs["repeat"]) > 1:
        out = out.repeat_interleave(int(attrs["repeat"]))
    return out
