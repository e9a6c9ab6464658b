"""Tensor ops: the counterpart of ``mxnet_tpu/ops/tensor.py`` (the
reference's ``src/operator/tensor/`` corpus): element-wise unary and binary
ops with their broadcast and scalar forms, the reductions, the matrix and
shape ops, indexing, ordering, the init ops and the samplers.  Parameter
names and defaults are the JAX package's, so a Symbol's JSON is the same in
both packages, and so are the semantics the JAX package chose:

* ``round`` and ``rint`` round half to even (``jnp.round``); ``gamma`` is
  ``exp(gammaln(x))``, so its sign is lost for negative x; ``pick`` and
  ``take`` clip their indices (``take`` also wraps under ``mode="wrap"``).
* Index-valued outputs (``argmax``, ``argmin``, ``argsort``, ``topk``) are
  float32.  ``sort``/``argsort`` descending are the stable ascending order
  flipped, so tied elements come in descending index order; ``topk``
  follows ``lax.top_k``: a total order on the bits (-0.0 below +0.0, NaN
  above +inf) with ties taken lower index first.
* A tie of ``_maximum``/``_minimum`` (and ``clip`` at a bound) passes half
  the gradient to each side, as ``jnp.maximum`` does; ``max``/``min``
  reductions split it evenly among the tied elements; ``abs`` passes +1 at
  0, as ``jnp.abs`` does.
* ``scatter_nd`` with duplicate indices is undefined in both packages
  (one of the writes wins).

The samplers draw from the ``torch.Generator`` the op context carries (the
device's, :mod:`mxnet_tpu_torch.random`), never from torch's global RNG;
the gamma draws are Marsaglia and Tsang's rejection method on that
generator's normal and uniform draws, since ``torch._standard_gamma``
takes no generator.  The bits differ from the JAX package's."""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, torch_dtype
from .registry import register


def _num_args(a):
    return tuple("arg%d" % i for i in range(int(a["num_args"])))


def _scalar_like(x, s):
    return torch.full((), s, dtype=x.dtype, device=x.device)


def _as(data, mask):
    """A comparison's boolean result in the input's dtype, as the
    reference returns it."""
    return mask.to(data.dtype)


# ------------------------------------------------------------ unary elemwise
def _unary(name, fn, aliases=()):
    @register(name, aliases=aliases, doc="element-wise %s" % name)
    def op(attrs, ctx, data, _fn=fn):
        return _fn(data)
    return op


def _abs(x):
    # jnp.abs passes +1 at 0 (torch.abs passes 0)
    return torch.where(x >= 0, x, -x) if x.is_floating_point() else x.abs()


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


for _n, _f in [
        ("relu", torch.relu),
        ("sigmoid", torch.sigmoid),
        ("exp", torch.exp),
        ("log", torch.log),
        ("log2", torch.log2),
        ("log10", torch.log10),
        ("log1p", torch.log1p),
        ("expm1", torch.expm1),
        ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt),
        ("cbrt", _cbrt),
        ("rcbrt", lambda x: 1.0 / _cbrt(x)),
        ("square", torch.square),
        ("abs", _abs),
        ("sign", torch.sign),
        ("round", torch.round),          # half to even, as jnp.round
        ("rint", torch.round),
        ("ceil", torch.ceil),
        ("floor", torch.floor),
        ("trunc", torch.trunc),
        ("fix", torch.trunc),
        ("reciprocal", torch.reciprocal),
        ("sin", torch.sin),
        ("cos", torch.cos),
        ("tan", torch.tan),
        ("arcsin", torch.asin),
        ("arccos", torch.acos),
        ("arctan", torch.atan),
        ("sinh", torch.sinh),
        ("cosh", torch.cosh),
        ("tanh", torch.tanh),
        ("arcsinh", torch.asinh),
        ("arccosh", torch.acosh),
        ("arctanh", torch.atanh),
        ("degrees", lambda x: x * (180.0 / math.pi)),
        ("radians", lambda x: x * (math.pi / 180.0)),
        ("gamma", lambda x: torch.exp(torch.lgamma(x))),
        ("gammaln", torch.lgamma),
        ("erf", torch.erf),
        ("softsign", lambda x: x / (1 + x.abs()))]:
    _unary(_n, _f)


@register("negative")
def negative(attrs, ctx, data):
    return -data


@register("identity", aliases=("_copy",))
def identity(attrs, ctx, data):
    """The input itself (ResNet's ``sym.identity`` stem wrapper)."""
    return data


@register("Cast", params={"dtype": "float32"}, aliases=("cast",))
def cast(attrs, ctx, data):
    return data.to(torch_dtype(attrs["dtype"]))


@register("clip", params={"a_min": None, "a_max": None})
def clip(attrs, ctx, data):
    """``min(max(x, a_min), a_max)``: a value on a bound passes half the
    gradient, as ``jnp.clip`` does."""
    if attrs["a_min"] is None or attrs["a_max"] is None:
        raise MXNetError("clip requires both a_min and a_max")
    lo = _scalar_like(data, float(attrs["a_min"]))
    hi = _scalar_like(data, float(attrs["a_max"]))
    return torch.minimum(torch.maximum(data, lo), hi)


@register("smooth_l1", params={"scalar": 1.0})
def smooth_l1(attrs, ctx, data):
    """0.5 s^2 x^2 where |x| < 1/s^2, else |x| - 0.5/s^2 (RCNN's loss)."""
    s2 = float(attrs["scalar"]) ** 2
    absd = _abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data.square(),
                       absd - 0.5 / s2)


# ----------------------------------------------------------- binary elemwise
def _binary(name, fn, aliases=()):
    @register(name, arg_names=("lhs", "rhs"), aliases=aliases,
              doc="element-wise %s of two tensors" % name)
    def op(attrs, ctx, lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    return op


def _cmp(fn):
    return lambda a, b: _as(a, fn(a, b))


_BINARY = [
    ("add", torch.add), ("sub", torch.sub), ("mul", torch.mul),
    ("div", torch.div), ("mod", torch.remainder), ("power", torch.pow),
    ("maximum", torch.maximum), ("minimum", torch.minimum),
    ("hypot", torch.hypot),
    ("equal", _cmp(torch.eq)), ("not_equal", _cmp(torch.ne)),
    ("greater", _cmp(torch.gt)), ("greater_equal", _cmp(torch.ge)),
    ("lesser", _cmp(torch.lt)), ("lesser_equal", _cmp(torch.le))]
_FN = dict(_BINARY)

for _n, _f, _al in [
        ("elemwise_add", torch.add, ("_plus", "_add")),
        ("elemwise_sub", torch.sub, ("_minus", "_sub")),
        ("elemwise_mul", torch.mul, ("_mul",)),
        ("elemwise_div", torch.div, ("_div",)),
        ("_power", torch.pow, ("pow",))]:
    _binary(_n, _f, _al)
for _n in ("maximum", "minimum", "hypot", "equal", "not_equal", "greater",
           "greater_equal", "lesser", "lesser_equal"):
    _binary("_" + _n, _FN[_n])
for _n, _f in _BINARY:
    _binary("broadcast_" + _n, _f,
            {"add": ("broadcast_plus",),
             "sub": ("broadcast_minus",)}.get(_n, ()))


def _scalar(name, fn):
    @register(name, params={"scalar": 0.0},
              doc="element-wise %s of a tensor and a scalar" % name)
    def op(attrs, ctx, data, _fn=fn):
        return _fn(data, float(attrs["scalar"]))
    return op


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
        ("_maximum_scalar",
         lambda x, s: torch.maximum(x, _scalar_like(x, s))),
        ("_minimum_scalar",
         lambda x, s: torch.minimum(x, _scalar_like(x, s))),
        ("_mod_scalar", lambda x, s: torch.remainder(x, s)),
        ("_equal_scalar", lambda x, s: _as(x, x == s)),
        ("_not_equal_scalar", lambda x, s: _as(x, x != s)),
        ("_greater_scalar", lambda x, s: _as(x, x > s)),
        ("_greater_equal_scalar", lambda x, s: _as(x, x >= s)),
        ("_lesser_scalar", lambda x, s: _as(x, x < s)),
        ("_lesser_equal_scalar", lambda x, s: _as(x, x <= s))]:
    _scalar(_n, _f)


@register("add_n", arg_names=_num_args, params={"num_args": 1},
          key_var_num_args="num_args", aliases=("ElementWiseSum", "_sum"))
def add_n(attrs, ctx, *args):
    """The sum of the inputs, added left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# -------------------------------------------------------------------- reduce
def _axes(axis, ndim, exclude=False):
    """The reduced axes as a tuple of non-negative ints (None: all)."""
    if axis is None:
        return None
    if not isinstance(axis, (tuple, list)):
        axis = (axis,)
    axes = tuple(int(a) % ndim for a in axis)
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _prod(x, axes, keepdims):
    axes = tuple(range(x.dim())) if axes is None else axes
    for a in sorted(axes, reverse=True):
        x = x.prod(a, keepdim=True)
    return x if keepdims else x.reshape([s for i, s in enumerate(x.shape)
                                         if i not in axes])


_REDUCERS = {
    "sum": lambda x, a, k: x.sum(a, keepdim=k),
    "mean": lambda x, a, k: (x if x.is_floating_point() else x.float())
    .mean(a, keepdim=k),
    "prod": _prod,
    "max": lambda x, a, k: torch.amax(x, a, keepdim=k),
    "min": lambda x, a, k: torch.amin(x, a, keepdim=k),
    "nansum": lambda x, a, k: torch.nansum(x, a, keepdim=k),
    "nanprod": lambda x, a, k: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), a, k),
}


def _reduce(name):
    fn = _REDUCERS[name]

    @register(name, params={"axis": None, "keepdims": False,
                            "exclude": False},
              doc="reduce %s over ``axis`` (None: all)" % name)
    def op(attrs, ctx, data):
        axes = _axes(attrs["axis"], data.dim(), bool(attrs["exclude"]))
        if axes == ():
            return data
        if axes is None:
            axes = tuple(range(data.dim()))
        return fn(data, axes, bool(attrs["keepdims"]))
    return op


for _n in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod"):
    _reduce(_n)


@register("norm", params={"ord": 2, "axis": None, "keepdims": False})
def norm(attrs, ctx, data):
    """The 1-norm or the 2-norm over ``axis`` (None: all)."""
    axes = _axes(attrs["axis"], data.dim())
    axes = tuple(range(data.dim())) if axes is None else axes
    keep = bool(attrs["keepdims"])
    order = int(attrs["ord"])
    if order == 1:
        return _abs(data).sum(axes, keepdim=keep)
    if order != 2:
        raise MXNetError("norm: only ord=1,2 supported, got %d" % order)
    return data.square().sum(axes, keepdim=keep).sqrt()


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), 0)
    else:
        out = fn(data, int(axis))
        if keepdims:
            out = out.unsqueeze(int(axis))
    return out.to(torch.float32)


@register("argmax", params={"axis": None, "keepdims": False})
def argmax(attrs, ctx, data):
    """The index of the first maximum (float32)."""
    return _arg(torch.argmax, data, attrs["axis"], attrs["keepdims"])


@register("argmin", params={"axis": None, "keepdims": False})
def argmin(attrs, ctx, data):
    return _arg(torch.argmin, data, attrs["axis"], attrs["keepdims"])


@register("argmax_channel")
def argmax_channel(attrs, ctx, data):
    return torch.argmax(data, 1).to(torch.float32)


@register("broadcast_axis", params={"axis": (), "size": ()},
          aliases=("broadcast_axes",))
def broadcast_axis(attrs, ctx, data):
    axes = attrs["axis"] if isinstance(attrs["axis"], (tuple, list)) \
        else (attrs["axis"],)
    sizes = attrs["size"] if isinstance(attrs["size"], (tuple, list)) \
        else (attrs["size"],)
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[int(a)] = int(s)
    return data.expand(shape).contiguous()


@register("broadcast_to", params={"shape": ()})
def broadcast_to_op(attrs, ctx, data):
    """``data`` broadcast to ``shape`` (a 0 keeps that dim)."""
    target = tuple(d if int(t) == 0 else int(t)
                   for t, d in zip(attrs["shape"], data.shape))
    target = target + tuple(int(t) for t in attrs["shape"][len(target):])
    return data.expand(target).contiguous()


# -------------------------------------------------------------------- matrix
def _rev(x):
    return x.permute(*reversed(range(x.dim())))


@register("dot", arg_names=("lhs", "rhs"),
          params={"transpose_a": False, "transpose_b": False})
def dot(attrs, ctx, lhs, rhs):
    """``jnp.dot``: the last axis of ``lhs`` against the second-to-last of
    ``rhs`` (its only axis when 1-d); ``transpose_*`` reverse all axes."""
    a = _rev(lhs) if attrs["transpose_a"] else lhs
    b = _rev(rhs) if attrs["transpose_b"] else rhs
    if a.dim() == 0 or b.dim() == 0:
        return (a * b).to(lhs.dtype)
    out = torch.tensordot(a, b, dims=([a.dim() - 1],
                                      [max(b.dim() - 2, 0)]))
    return out.to(lhs.dtype)


@register("batch_dot", arg_names=("lhs", "rhs"),
          params={"transpose_a": False, "transpose_b": False})
def batch_dot(attrs, ctx, lhs, rhs):
    a = lhs.transpose(-1, -2) if attrs["transpose_a"] else lhs
    b = rhs.transpose(-1, -2) if attrs["transpose_b"] else rhs
    return torch.matmul(a, b).to(lhs.dtype)


@register("transpose", params={"axes": ()})
def transpose(attrs, ctx, data):
    axes = tuple(int(a) for a in attrs["axes"])
    return data.permute(*axes) if axes else _rev(data)


@register("expand_dims", params={"axis": 0})
def expand_dims(attrs, ctx, data):
    return data.unsqueeze(int(attrs["axis"]))


@register("squeeze", params={"axis": None})
def squeeze(attrs, ctx, data):
    """Drop size-1 dims (``axis=None`` drops all; an int or a tuple
    selects)."""
    axis = attrs["axis"]
    if axis is None:
        return data.squeeze()
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    axes = sorted((int(a) % data.dim() for a in axes), reverse=True)
    for a in axes:
        if data.shape[a] != 1:
            raise MXNetError("squeeze: axis %d has size %d"
                             % (a, data.shape[a]))
        data = data.squeeze(a)
    return data


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


def _slice_dim(x, dim, begin, end, step):
    """``x`` sliced along ``dim`` as a Python slice, negative steps
    included."""
    start, stop, step = slice(begin, end, step).indices(x.shape[dim])
    if step > 0:
        return x[(slice(None),) * dim + (slice(start, stop, step),)]
    return x.index_select(dim, torch.arange(start, stop, step,
                                            device=x.device))


@register("slice", params={"begin": (), "end": (), "step": ()},
          aliases=("crop_like",))
def slice_op(attrs, ctx, data):
    """``data[begin:end:step]`` on the leading axes (None: the axis's
    whole extent; a negative step walks backwards)."""
    begin, end = attrs["begin"], attrs["end"]
    step = attrs["step"] or (1,) * len(begin)
    out = data
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        out = _slice_dim(out, d, None if b is None else int(b),
                         None if e is None else int(e), int(s) if s else 1)
    return out


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


@register("flip", params={"axis": 0}, aliases=("reverse",))
def flip(attrs, ctx, data):
    ax = attrs["axis"]
    ax = ax if isinstance(ax, (tuple, list)) else (ax,)
    return torch.flip(data, [int(a) for a in ax])


@register("repeat", params={"repeats": 1, "axis": None})
def repeat(attrs, ctx, data):
    """Each element repeated ``repeats`` times along ``axis`` (None: of
    the flattened input)."""
    axis = attrs["axis"]
    if axis is None:
        return data.reshape(-1).repeat_interleave(int(attrs["repeats"]))
    return data.repeat_interleave(int(attrs["repeats"]), dim=int(axis))


@register("tile", params={"reps": ()})
def tile(attrs, ctx, data):
    return torch.tile(data, tuple(int(r) for r in attrs["reps"]))


@register("stack", arg_names=_num_args, params={"axis": 0, "num_args": 1},
          key_var_num_args="num_args")
def stack(attrs, ctx, *args):
    return torch.stack(args, dim=int(attrs["axis"]))


# ------------------------------------------------------------------ indexing
@register("take", arg_names=("a", "indices"),
          params={"axis": 0, "mode": "clip"})
def take(attrs, ctx, a, indices):
    """Slices of ``a`` along ``axis`` at ``indices``: clipped into range
    (``mode="clip"``, a negative index reads 0) or wrapped (``"wrap"``)."""
    ax = int(attrs["axis"]) % a.dim()
    n = a.shape[ax]
    idx = indices.long()
    mode = attrs["mode"]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "raise":
        raise MXNetError("take: mode='raise' is unsupported (a "
                         "data-dependent error); use 'clip' or 'wrap'")
    idx = idx.clamp(0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take", arg_names=("a", "indices"))
def batch_take(attrs, ctx, a, indices):
    """``a[i, indices[i]]`` for each row i."""
    return a.gather(1, indices.long().reshape(-1, 1))[:, 0]


@register("one_hot", arg_names=("indices",),
          params={"depth": 0, "on_value": 1.0, "off_value": 0.0,
                  "dtype": "float32"})
def one_hot(attrs, ctx, indices):
    """One-hot rows of ``depth``; an index outside [0, depth) gives an
    all-``off_value`` row."""
    depth = int(attrs["depth"])
    cls = torch.arange(depth, device=indices.device)
    oh = (indices.long().unsqueeze(-1) == cls).to(torch_dtype(attrs["dtype"]))
    on, off = float(attrs["on_value"]), float(attrs["off_value"])
    if on != 1.0 or off != 0.0:
        oh = oh * (on - off) + off
    return oh


@register("gather_nd", arg_names=("data", "indices"))
def gather_nd(attrs, ctx, data, indices):
    """``data[indices[0], indices[1], ...]``."""
    return data[tuple(indices.long())]


@register("scatter_nd", arg_names=("data", "indices"), params={"shape": ()})
def scatter_nd(attrs, ctx, data, indices):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (the inverse
    of ``gather_nd``).  With duplicate indices one write wins, which one
    is undefined, as in the JAX package."""
    out = torch.zeros(tuple(int(s) for s in attrs["shape"]),
                      dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data)


# ------------------------------------------------------------------ ordering
_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64,
           torch.float16: torch.int16, torch.bfloat16: torch.int16}


def total_order_key(x):
    """An integer key that orders ``x`` as ``lax.top_k`` does: the float's
    bits in sign-magnitude order, so -0.0 sorts below +0.0 and NaN above
    +inf; equal keys are equal bits."""
    if not x.is_floating_point():
        return x
    it = _INT_OF[x.dtype]
    i = x.contiguous().view(it)
    return torch.where(i < 0, i ^ torch.iinfo(it).max, i)


@register("topk", params={"axis": -1, "k": 1, "ret_typ": "indices",
                          "is_ascend": False},
          num_outputs=lambda a: 2 if a.get("ret_typ") == "both" else 1)
def topk(attrs, ctx, data):
    """The ``k`` largest (smallest under ``is_ascend``) along ``axis``, as
    ``lax.top_k`` gives them: ties lower index first.  ``ret_typ``:
    ``"indices"`` (float32), ``"value"``, ``"both"`` or ``"mask"``."""
    ax = int(attrs["axis"]) % data.dim()
    k = int(attrs["k"])
    x = data.movedim(ax, -1)
    key = total_order_key(-x if attrs["is_ascend"] else x)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    rt = attrs["ret_typ"]
    if rt == "mask":
        mask = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return mask.scatter(-1, idx, 1.0).movedim(-1, ax)
    vals = x.gather(-1, idx).movedim(-1, ax)
    idxf = idx.movedim(-1, ax).to(torch.float32)
    if rt == "value":
        return vals
    if rt == "both":
        return vals, idxf
    return idxf


def _sorted(data, axis, ascend):
    ax = int(axis)
    res = torch.sort(data, dim=ax, stable=True)
    if ascend:
        return res.values, res.indices
    return res.values.flip(ax), res.indices.flip(ax)


@register("sort", params={"axis": -1, "is_ascend": True})
def sort(attrs, ctx, data):
    """Sorted along ``axis``; descending is the ascending order flipped."""
    return _sorted(data, attrs["axis"], attrs["is_ascend"])[0]


@register("argsort", params={"axis": -1, "is_ascend": True})
def argsort(attrs, ctx, data):
    """The stable ascending order's indices (float32), flipped for
    descending: tied elements then come in descending index order."""
    return _sorted(data, attrs["axis"], attrs["is_ascend"])[1] \
        .to(torch.float32)


@register("pick", arg_names=("data", "index"),
          params={"axis": -1, "keepdims": False})
def pick(attrs, ctx, data, index):
    """``data`` at per-position indices along ``axis``; an index out of
    range clips to the first or last element."""
    axis = int(attrs["axis"]) % data.dim()
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = data.gather(axis, idx)
    return out if attrs["keepdims"] else out.squeeze(axis)


# -------------------------------------------------------------- control flow
@register("where", arg_names=("condition", "x", "y"))
def where(attrs, ctx, condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y``; a 1-d condition
    picks whole rows of ``x`` and ``y``."""
    cond = condition
    if cond.dim() == 1 and x.dim() > 1:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond != 0, x, y)


# ---------------------------------------------------------------- init ops
def _shape(attrs):
    return tuple(int(s) for s in attrs["shape"])


@register("_zeros", arg_names=(), params={"shape": (), "dtype": "float32"},
          aliases=("zeros_like_op",))
def zeros_op(attrs, ctx):
    """Zeros of ``shape`` on the op context's device (a 0 in ``shape`` is
    the batch dimension, which ``eval_graph`` fills in first)."""
    return torch.zeros(_shape(attrs), dtype=torch_dtype(attrs["dtype"]),
                       device=ctx.device)


@register("_ones", arg_names=(), params={"shape": (), "dtype": "float32"})
def ones_op(attrs, ctx):
    return torch.ones(_shape(attrs), dtype=torch_dtype(attrs["dtype"]),
                      device=ctx.device)


@register("_full", arg_names=(), params={"shape": (), "dtype": "float32",
                                         "value": 0.0})
def full_op(attrs, ctx):
    return torch.full(_shape(attrs), float(attrs["value"]),
                      dtype=torch_dtype(attrs["dtype"]), device=ctx.device)


@register("zeros_like")
def zeros_like(attrs, ctx, data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(attrs, ctx, data):
    return torch.ones_like(data)


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


# ---------------------------------------------------------------- sample ops
def standard_gamma(alpha, shape, gen, device):
    """Gamma(alpha, 1) draws of ``shape`` from ``gen`` alone: Marsaglia and
    Tsang's rejection method, every pending element redrawn from a normal
    and a uniform until it is accepted, and alpha < 1 boosted by
    U^(1/alpha) from Gamma(alpha + 1)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device) \
        .expand(shape)
    small = a < 1
    boost = torch.where(
        small, torch.rand(shape, generator=gen, device=device)
        .pow(1.0 / a), torch.ones((), device=device))
    a = torch.where(small, a + 1, a)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(pending.any()):
        x = torch.randn(shape, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take_now = pending & ok
        out = torch.where(take_now, d * v, out)
        pending = pending & ~ok
    return out * boost


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


def _neg_binomial(r, p, shape, gen, device):
    lam = standard_gamma(r, shape, gen, device) * (1 - p) / p
    return _poisson(lam, gen)


_DRAWS = {
    "_random_uniform": lambda g, s, dv, a: torch.rand(
        s, generator=g, device=dv) * (a["high"] - a["low"]) + a["low"],
    "_random_normal": lambda g, s, dv, a: a["loc"] + a["scale"] * torch.randn(
        s, generator=g, device=dv),
    "_random_gamma": lambda g, s, dv, a: a["beta"] * standard_gamma(
        a["alpha"], s, g, dv),
    "_random_exponential": lambda g, s, dv, a: torch.empty(
        s, device=dv).exponential_(1.0, generator=g) / a["lam"],
    "_random_poisson": lambda g, s, dv, a: _poisson(
        torch.full(s, float(a["lam"]), device=dv), g),
    "_random_negative_binomial": lambda g, s, dv, a: _neg_binomial(
        float(a["k"]), float(a["p"]), s, g, dv),
    "_random_generalized_negative_binomial": lambda g, s, dv, a:
        _neg_binomial(1.0 / a["alpha"], (1.0 / a["alpha"])
                      / (1.0 / a["alpha"] + a["mu"]), s, g, dv),
}


def _sample(name, params, aliases):
    draw = _DRAWS[name]

    @register(name, arg_names=(), params={**params, "shape": (),
                                          "dtype": "float32"},
              stochastic=True, aliases=aliases,
              doc="random sample of ``shape`` from the device's generator")
    def op(attrs, ctx):
        shape = _shape(attrs)
        dt = torch_dtype(attrs["dtype"])
        if ctx.device.type == "meta":          # shape inference
            return torch.empty(shape, dtype=dt, device=ctx.device)
        out = draw(ctx.require_generator(), shape, ctx.device, attrs)
        return out.to(dt)
    return op


for _n, _p, _al in [
        ("_random_uniform", {"low": 0.0, "high": 1.0},
         ("uniform", "random_uniform")),
        ("_random_normal", {"loc": 0.0, "scale": 1.0},
         ("normal", "random_normal")),
        ("_random_gamma", {"alpha": 1.0, "beta": 1.0}, ("random_gamma",)),
        ("_random_exponential", {"lam": 1.0}, ("random_exponential",)),
        ("_random_poisson", {"lam": 1.0}, ("random_poisson",)),
        ("_random_negative_binomial", {"k": 1, "p": 1.0},
         ("random_negative_binomial",)),
        ("_random_generalized_negative_binomial", {"mu": 1.0, "alpha": 1.0},
         ("random_generalized_negative_binomial",))]:
    _sample(_n, _p, _al)
