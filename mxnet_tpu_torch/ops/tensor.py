"""Tensor ops: the subset of ``mxnet_tpu/ops/tensor.py`` that the GPT
and ResNet paths use.  Parameter names and defaults are the JAX package's, so
a Symbol's JSON is the same in both packages."""
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
