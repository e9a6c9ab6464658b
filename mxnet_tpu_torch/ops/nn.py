"""Neural-network ops: the subset of ``mxnet_tpu/ops/nn.py`` that the GPT,
the ResNet and the RNN cells serve and train with.  Parameter names and defaults are the JAX
package's.  The dense products and convolutions stay ``F.linear`` and
``F.conv2d``: the JAX package left them to XLA, and the port leaves them to
PyTorch.  Gradients come from autograd, except SoftmaxOutput's and
BatchNorm's, which are the reference's hand-written backwards (each an
``autograd.Function``, as the JAX op is a ``custom_vjp``).  No op writes in
place into a tensor that autograd saved.

Image layout: the graphs are written against the reference's NCHW
convention; under :class:`image_layout` ``("NHWC")`` (the trainer's
``layout="NHWC"``) Convolution, Pooling and BatchNorm take channel-minor
activations, as in the JAX package.  Weights stay OIHW.  A convolution
then runs as ``F.conv2d`` on the channels-last view
``x.permute(0, 3, 1, 2)`` with the weight in ``channels_last`` memory
format too, so cuDNN reads and writes NHWC without transposes."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        t = tuple(int(x) for x in v)
        return t if len(t) == n else t * n if len(t) == 1 else t
    return (int(v),) * n


# ----------------------------------------------------------------- layout
_IMAGE_LAYOUT = "NCHW"


class image_layout:
    """Context manager selecting the activation layout ('NCHW'/'NHWC')
    seen by Convolution/Pooling/BatchNorm while a graph runs."""

    def __init__(self, layout):
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("unsupported image layout %r" % (layout,))
        self.layout = layout

    def __enter__(self):
        global _IMAGE_LAYOUT
        self._prev = _IMAGE_LAYOUT
        _IMAGE_LAYOUT = self.layout
        return self

    def __exit__(self, *exc):
        global _IMAGE_LAYOUT
        _IMAGE_LAYOUT = self._prev
        return False


def current_image_layout():
    return _IMAGE_LAYOUT


def _is_nhwc(data):
    """True when a 4-d activation flows channel-minor (trainer NHWC mode)."""
    return data.dim() == 4 and _IMAGE_LAYOUT == "NHWC"


def _ch_axis(data):
    return 3 if _is_nhwc(data) else 1


# Ops that index the channel axis but have no NHWC adaptation; a trainer in
# NHWC mode refuses graphs containing them rather than silently computing on
# the wrong axis.  The JAX package's list, kept whole so that a later port
# of one of these ops meets it.
NHWC_UNAWARE_OPS = frozenset({
    "SwapAxis", "SpatialTransformer", "BilinearSampler", "GridGenerator",
    "ROIPooling", "Correlation", "Proposal", "MultiBoxPrior",
    "MultiBoxTarget", "MultiBoxDetection",
})


@register("FullyConnected", arg_names=lambda a: ("data", "weight")
          if a["no_bias"] else ("data", "weight", "bias"),
          params={"num_hidden": 0, "no_bias": False, "flatten": True},
          aliases=("fully_connected",))
def fully_connected(attrs, ctx, data, weight, bias=None):
    """Y = X W^T + b, W of shape (num_hidden, in)."""
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    return F.linear(x, weight, bias).to(data.dtype)


# ---------------------------------------------------------------------- conv
def conv2d(x, w, bias, stride, pad, dilate, groups, nhwc):
    """2-d convolution of ``x`` (NHWC when ``nhwc``, else NCHW) by the OIHW
    weight ``w``; the output has ``x``'s layout.  NHWC runs on the
    channels-last view of ``x`` with the weight in ``channels_last``
    memory format, so cuDNN inserts no layout transposes; the result's
    permute back to NHWC is then a contiguous view."""
    if not nhwc:
        return F.conv2d(x, w, bias, stride, pad, dilate, groups)
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.contiguous(memory_format=torch.channels_last), bias,
                 stride, pad, dilate, groups)
    return y.permute(0, 2, 3, 1)


def conv_statics(attrs):
    """(kernel, stride, dilate, pad, groups) of a Convolution, with
    the reference's defaults filled in."""
    kernel = tuple(attrs["kernel"])
    nd = len(kernel)
    return (kernel, tuple(attrs["stride"]) or (1,) * nd,
            tuple(attrs["dilate"]) or (1,) * nd,
            tuple(attrs["pad"]) or (0,) * nd, int(attrs["num_group"]))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _pinned_layout(attrs, op):
    layout = attrs.get("layout") or _IMAGE_LAYOUT
    if attrs.get("layout") and _IMAGE_LAYOUT == "NHWC" \
            and attrs["layout"] != "NHWC":
        raise MXNetError(
            "%s node pins layout=%r but the trainer runs "
            "image_layout('NHWC'); drop the explicit layout attr or train "
            "in NCHW" % (op, attrs["layout"]))
    return layout


@register("Convolution", arg_names=lambda a: ("data", "weight")
          if a["no_bias"] else ("data", "weight", "bias"),
          params={"kernel": (1, 1), "stride": (), "dilate": (), "pad": (),
                  "num_filter": 0, "num_group": 1, "no_bias": False,
                  "workspace": 1024, "cudnn_tune": None, "cudnn_off": False,
                  "layout": None},
          aliases=("convolution", "Convolution_v1"))
def convolution(attrs, ctx, data, weight, bias=None):
    """1-d, 2-d or 3-d convolution, NCW/NCHW/NCDHW or (2-d, under
    ``image_layout("NHWC")`` or a ``layout="NHWC"`` attr) NHWC; weight
    (num_filter, C/group, *kernel)."""
    kernel, stride, dilate, pad, groups = conv_statics(attrs)
    layout = _pinned_layout(attrs, "Convolution")
    if len(kernel) == 2:
        y = conv2d(data, weight, bias, stride, pad, dilate, groups,
                   layout == "NHWC")
    elif len(kernel) in _CONV:
        y = _CONV[len(kernel)](data, weight, bias, stride, pad, dilate,
                               groups)
    else:
        raise MXNetError("Convolution with a %d-d kernel" % len(kernel))
    return y.to(data.dtype)


@register("Deconvolution", arg_names=lambda a: ("data", "weight")
          if a["no_bias"] else ("data", "weight", "bias"),
          params={"kernel": (1, 1), "stride": (), "dilate": (), "pad": (),
                  "adj": (), "target_shape": (), "num_filter": 0,
                  "num_group": 1, "no_bias": True, "workspace": 512,
                  "cudnn_tune": None, "cudnn_off": False, "layout": None})
def deconvolution(attrs, ctx, data, weight, bias=None):
    """1-d, 2-d or 3-d transposed convolution; weight (C_in, C_out/group,
    *kernel), the output (in - 1) * stride - 2 * pad + kernel + adj.  As
    in the JAX package, ``dilate`` and ``target_shape`` are not read (the
    reference reads both); 2-d activations may be NHWC, as for
    Convolution."""
    kernel = tuple(int(k) for k in attrs["kernel"])
    nd = len(kernel)
    if nd not in _CONV_T:
        raise MXNetError("Deconvolution with a %d-d kernel" % nd)
    stride = tuple(attrs["stride"]) or (1,) * nd
    pad = tuple(attrs["pad"]) or (0,) * nd
    adj = tuple(attrs["adj"]) or (0,) * nd
    groups = int(attrs["num_group"])
    nhwc = nd == 2 and _is_nhwc(data)
    x = data.permute(0, 3, 1, 2) if nhwc else data
    y = _CONV_T[nd](x, weight, bias, stride, pad, adj, groups)
    if nhwc:
        y = y.permute(0, 2, 3, 1)
    return y.to(data.dtype)


# ------------------------------------------------------------------- pooling
_POOL = {1: (F.max_pool1d, F.avg_pool1d), 2: (F.max_pool2d, F.avg_pool2d),
         3: (F.max_pool3d, F.avg_pool3d)}


@register("Pooling",
          params={"kernel": (1, 1), "pool_type": "max", "global_pool": False,
                  "stride": (), "pad": (), "pooling_convention": "valid",
                  "cudnn_off": False},
          aliases=("pooling", "Pooling_v1"))
def pooling(attrs, ctx, data):
    """1-d, 2-d or 3-d max/avg/sum pooling, NCW/NCHW/NCDHW or (2-d) NHWC.
    Padding reads -inf for max and 0 otherwise; the stride defaults to 1
    (the reference's, not the kernel); ``pooling_convention="full"`` pads
    the high side up to a whole window; avg divides by the full window,
    padding included."""
    nd = data.dim() - 2
    if nd not in _POOL:
        raise MXNetError("Pooling of a %d-d input" % data.dim())
    nhwc = nd == 2 and _IMAGE_LAYOUT == "NHWC"
    x = data.permute(0, 3, 1, 2) if nhwc else data
    if attrs["global_pool"]:
        kernel, stride, pad = tuple(x.shape[2:]), (1,) * nd, (0,) * nd
    else:
        kernel = _pair(attrs["kernel"], nd)
        stride = tuple(attrs["stride"]) or (1,) * nd
        pad = tuple(attrs["pad"]) or (0,) * nd
    extra = [0] * nd
    if attrs.get("pooling_convention", "valid") == "full":
        for i in range(nd):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                extra[i] = stride[i] - rem
    ptype = attrs["pool_type"]
    if ptype not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %s" % ptype)
    fill = float("-inf") if ptype == "max" else 0.0
    if any(extra) or any(p > k // 2 for p, k in zip(pad, kernel)):
        # asymmetric or wide padding: pad explicitly, pool unpadded
        widths = []
        for i in reversed(range(nd)):
            widths += [pad[i], pad[i] + extra[i]]
        x = F.pad(x, widths, value=fill)
        pad = (0,) * nd
    max_pool, avg_pool = _POOL[nd]
    if ptype == "max":
        y = max_pool(x, kernel, stride, pad)
    else:
        y = avg_pool(x, kernel, stride, pad, count_include_pad=True)
        if ptype == "sum":
            y = y * math.prod(kernel)
    y = y.to(data.dtype)
    return y.permute(0, 2, 3, 1) if nhwc else y


# ---------------------------------------------------------------- batch norm
def bn_apply(xf, gamma, beta, mean, var, eps, bshape, act=None):
    """``(xf * scale + shift [relu], inv)``: BatchNorm's normalization of
    an f32 tensor with ``inv = rsqrt(var + eps)``, ``scale = gamma * inv``
    and ``shift = beta - mean * scale``."""
    inv = torch.rsqrt(var + eps)
    scale = gamma.float() * inv
    shift = beta.float() - mean * scale
    out = xf * scale.reshape(bshape) + shift.reshape(bshape)
    return (torch.relu(out) if act == "relu" else out), inv


def _batch_span():
    """``(parallel.multihost, world)`` when BatchNorm's batch reductions
    span the ranks of a data-parallel trainer's step, else ``(None,
    1)``."""
    from ..parallel import multihost
    if multihost.batch_sums_span_ranks():
        return multihost, multihost.world_size()
    return None, 1


def bn_moments(s1, s2, n, c, mm, mv, momentum):
    """``(mean, var, new_mm, new_mv)`` from the shifted sums ``s1 =
    sum(x - c)`` and ``s2 = sum((x - c)^2)`` over ``n`` values: the biased
    variance E[(x-c)^2] - E[x-c]^2, and the moving statistics moved toward
    the batch's by ``1 - momentum``."""
    ranks, world = _batch_span()
    if ranks is not None:
        # the global batch's statistics, as the JAX step's one program
        # takes them: the sums of every rank, over every rank's rows
        s1, s2 = ranks.reduce_batch_sums(s1, s2)
        n = n * world
    meanc = s1 / n
    var = (s2 / n - meanc.square()).clamp_min(0.0)
    mean = meanc + c
    return (mean, var, mm * momentum + mean * (1 - momentum),
            mv * momentum + var * (1 - momentum))


def bn_forward(xf, gamma, beta, mm, mv, red, bshape, eps, momentum,
               train_stats, act=None):
    """BatchNorm (+ReLU) forward over an f32 tensor, reduced over ``red``
    and broadcast by ``bshape``: one shifted single-pass statistics pass,
    c = the moving mean (var = E[(x-c)^2] - E[x-c]^2, which avoids the
    cancellation of the raw form on large-mean channels), then one
    normalize pass.  Without ``train_stats`` the moving statistics
    normalize and pass through.  Returns ``(out_f32, mean, var, inv,
    new_mm, new_mv)``."""
    if train_stats:
        c = mm.float()
        xs = xf - c.reshape(bshape)
        mean, var, new_mm, new_mv = bn_moments(
            xs.sum(red), xs.square().sum(red), xf.numel() // math.prod(bshape),
            c, mm, mv, momentum)
    else:
        mean, var = mm.float(), mv.float()
        new_mm, new_mv = mm.clone(), mv.clone()
    out, inv = bn_apply(xf, gamma, beta, mean, var, eps, bshape, act)
    return out, mean, var, inv, new_mm, new_mv


def bn_backward(dout, xf, gamma, beta, mean, inv, mm, red, bshape,
                momentum, train_stats, act, dmean_o, dvar_o, dmm_o, dmv_o):
    """The backward of :func:`bn_forward`: one reduce pass (sum dy, sum
    dy*(x-c)) and one dx pass, with the cotangents of the mean, var and
    moving outputs.  A ReLU's mask is recomputed from ``xf*scale + shift >
    0``, not saved.  Returns ``(dx_f32, dgamma, dbeta, dmm, dmv)``."""
    dyf = dout.float()
    a = gamma.float() * inv
    if act == "relu":
        shift = beta.float() - mean * a
        pre = xf * a.reshape(bshape) + shift.reshape(bshape)
        dyf = torch.where(pre > 0, dyf, torch.zeros((), device=dyf.device))
    c = mm.float()
    xs = xf - c.reshape(bshape)
    meanc = mean - c
    dbeta = dyf.sum(red)
    dxs = (dyf * xs).sum(red)
    dgamma = (dxs - meanc * dbeta) * inv
    if train_stats:
        n = xf.numel() // mean.numel()
        dmean = dmean_o + (1 - momentum) * dmm_o
        dvar = dvar_o + (1 - momentum) * dmv_o
        gbeta, ggamma = dbeta, dgamma
        ranks, world = _batch_span()
        if ranks is not None:
            # dx reads the global batch's sums; dgamma and dbeta stay this
            # rank's shares, which the gradient all-reduce adds up
            gbeta, gxs, dmean, dvar = ranks.reduce_batch_sums(
                dbeta, dxs, dmean * torch.ones_like(dbeta),
                dvar * torch.ones_like(dbeta))
            ggamma = (gxs - meanc * gbeta) * inv
            n = n * world
        k = (-a * inv * ggamma + 2.0 * dvar) * (1.0 / n)
        d = -k * meanc - a * gbeta * (1.0 / n) + dmean * (1.0 / n)
        dx = (dyf * a.reshape(bshape) + xs * k.reshape(bshape)
              + d.reshape(bshape))
        dmm, dmv = momentum * dmm_o, momentum * dmv_o
    else:
        dx = dyf * a.reshape(bshape)
        dmm, dmv = dmm_o + dmean_o, dmv_o + dvar_o
    return dx, dgamma, dbeta, dmm, dmv


def _bn_layout(x, axis):
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]
    return [i for i in range(x.dim()) if i != axis], bshape


class BNCore(torch.autograd.Function):
    """The hand-scheduled BatchNorm of ``mxnet_tpu/ops/nn.py`` ``_bn_core``
    (a ``custom_vjp`` there): ``(x, gamma, beta, mm, mv)`` with f32 moving
    statistics -> ``(out, mean, var, new_mm, new_mv)``, through
    :func:`bn_forward` and :func:`bn_backward`.  With ``act="relu"`` it
    is also the fused BN->ReLU region (``_fused_bn_act_xla``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mm, mv, eps, momentum, train_stats,
                axis, act=None):
        red, bshape = _bn_layout(x, axis)
        out, mean, var, inv, new_mm, new_mv = bn_forward(
            x.float(), gamma, beta, mm, mv, red, bshape, eps, momentum,
            train_stats, act)
        ctx.save_for_backward(x, gamma, beta, mean, inv, mm)
        ctx.cfg = (momentum, train_stats, axis, act)
        return out.to(x.dtype), mean, var, new_mm, new_mv

    @staticmethod
    def backward(ctx, dy, dmean_o, dvar_o, dmm_o, dmv_o):
        x, gamma, beta, mean, inv, mm = ctx.saved_tensors
        momentum, train_stats, axis, act = ctx.cfg
        red, bshape = _bn_layout(x, axis)
        dx, dgamma, dbeta, dmm, dmv = bn_backward(
            dy, x.float(), gamma, beta, mean, inv, mm, red, bshape, momentum,
            train_stats, act, dmean_o, dvar_o, dmm_o, dmv_o)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), dmm, dmv) + (None,) * 5


def bn_axis(attrs, data):
    """The BatchNorm channel axis: the symbols declare the reference NCHW
    axis 1, which is axis 3 of an NHWC activation."""
    axis = int(attrs["axis"]) % data.dim()
    return _ch_axis(data) if axis == 1 else axis


@register("BatchNorm", arg_names=("data", "gamma", "beta"),
          aux_names=("moving_mean", "moving_var"),
          num_outputs=lambda a: 3 if a.get("output_mean_var") else 1,
          params={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                  "use_global_stats": False, "output_mean_var": False,
                  "axis": 1, "cudnn_off": False},
          aliases=("batch_norm", "BatchNorm_v1"))
def batch_norm(attrs, ctx, data, gamma, beta, moving_mean, moving_var):
    """Batch normalization through :class:`BNCore`.  The updated moving
    statistics are returned as trailing outputs, which ``eval_graph``
    threads as aux updates: ``(out[, mean, var], new_mm, new_mv)``.
    ``fix_gamma`` uses ones, which get no gradient."""
    if attrs["fix_gamma"]:
        gamma = torch.ones_like(gamma)
    train_stats = bool(ctx.is_train and not attrs["use_global_stats"])
    out, mean, var, new_mm, new_mv = BNCore.apply(
        data, gamma, beta, moving_mean.float(), moving_var.float(),
        float(attrs["eps"]), float(attrs["momentum"]), train_stats,
        bn_axis(attrs, data))
    new_mm = new_mm.to(moving_mean.dtype)
    new_mv = new_mv.to(moving_var.dtype)
    if attrs.get("output_mean_var"):
        return out, mean, var, new_mm, new_mv
    return out, new_mm, new_mv


@register("LayerNorm", arg_names=("data", "gamma", "beta"),
          num_outputs=lambda a: 3 if a.get("output_mean_var") else 1,
          params={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def layer_norm(attrs, ctx, data, gamma, beta):
    """Layer normalization over ``axis``; statistics in f32, the result
    cast back to the input's dtype.  ``output_mean_var`` adds the mean and
    the standard deviation sqrt(var + eps), without ``axis`` (f32)."""
    axis = int(attrs["axis"])
    eps = float(attrs["eps"])
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = (xf - mean).square().mean(dim=axis, keepdim=True)
    inv = torch.rsqrt(var + eps)
    bshape = tuple(data.shape[axis] if i == (axis % data.dim()) else 1
                   for i in range(data.dim()))
    out = ((xf - mean) * inv * gamma.float().reshape(bshape)
           + beta.float().reshape(bshape)).to(data.dtype)
    if attrs["output_mean_var"]:
        return out, mean.squeeze(axis), torch.sqrt(var + eps).squeeze(axis)
    return out


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # log(1 + e^x) without overflow, as jax.nn.softplus; F.softplus's
    # linear branch past its threshold would differ in the last bits
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device)),
    "softsign": lambda x: x / (1 + x.abs()),
}


@register("Activation", params={"act_type": "relu"}, aliases=("activation",))
def activation(attrs, ctx, data):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign."""
    fn = _ACTIVATIONS.get(attrs["act_type"])
    if fn is None:
        raise MXNetError("unknown act_type %s" % attrs["act_type"])
    return fn(data)


@register("Dropout", params={"p": 0.5, "mode": "training"}, stochastic=True,
          aliases=("dropout",))
def dropout(attrs, ctx, data):
    """Inverted dropout in training, from the op context's generator: keep
    each element with probability 1 - p and scale it by 1 / (1 - p).
    Identity at inference.  The bits differ from the JAX package's."""
    p = float(attrs["p"])
    if not ctx.is_train or p <= 0.0:
        return data
    keep = 1.0 - p
    u = torch.rand(data.shape, generator=ctx.require_generator(),
                   device=data.device)
    return torch.where(u < keep, data / keep,
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device)).to(data.dtype)


def softmax_output_grad(out, label, grad_scale, axis, use_ignore,
                        ignore_label, normalization):
    """The reference SoftmaxOutput gradient (p - onehot(label)) * scale in
    f32, cast to ``out``'s dtype.  A label outside [0, nclass) has an
    all-zero one-hot row, as in ``jax.nn.one_hot``; ``use_ignore`` zeroes
    the rows whose label is ``ignore_label``; ``normalization`` divides by
    the batch ("batch"), the count of kept labels ("valid" with
    ``use_ignore``) or all labels ("valid" without)."""
    nclass = out.shape[axis]
    lab = label.long()
    # a copy: ``out`` is saved by autograd and must stay untouched
    grad = out.to(torch.float32, copy=True)
    in_range = ((lab >= 0) & (lab < nclass)).unsqueeze(axis)
    grad.scatter_add_(axis, lab.clamp(0, nclass - 1).unsqueeze(axis),
                      -in_range.to(torch.float32))
    scale = grad_scale
    if use_ignore:
        keep = lab != int(ignore_label)
        grad = grad * keep.unsqueeze(axis)
        if normalization == "valid":
            scale = scale / keep.sum().clamp(min=1)
    if normalization == "batch":
        scale = scale / out.shape[0]
    elif normalization == "valid" and not use_ignore:
        scale = scale / lab.numel()
    return (grad * scale).to(out.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward ignores the head gradient and returns
    :func:`softmax_output_grad` for the data and zeros for the label."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, axis, use_ignore, ignore_label,
                normalization):
        out = torch.softmax(data.float(), dim=axis).to(data.dtype)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, axis, use_ignore, ignore_label, normalization)
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        grad = softmax_output_grad(out, label, *ctx.cfg)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None, None, None, None


@register("SoftmaxOutput", arg_names=("data", "label"),
          params={"grad_scale": 1.0, "ignore_label": -1.0,
                  "multi_output": False, "use_ignore": False,
                  "preserve_shape": False, "normalization": "null",
                  "out_grad": False, "smooth_alpha": 0.0},
          is_loss=True, aliases=("Softmax",))
def softmax_output(attrs, ctx, data, label):
    """Softmax over the last axis (axis 1 under ``multi_output``) in f32,
    cast back; its gradient is the reference's (p - onehot(label)) *
    grad_scale whatever the head gradient
    (``mxnet_tpu/ops/nn.py`` ``_softmax_output_bwd``)."""
    axis = 1 if attrs["multi_output"] else -1
    return _SoftmaxOutput.apply(
        data, label, float(attrs["grad_scale"]), axis,
        bool(attrs["use_ignore"]), float(attrs["ignore_label"]),
        attrs["normalization"])


@register("Embedding", arg_names=("data", "weight"),
          params={"input_dim": 0, "output_dim": 0, "dtype": "float32"})
def embedding(attrs, ctx, data, weight):
    """Rows of ``weight`` at the indices in ``data`` (which arrive as
    floats).  As in the JAX package's ``jnp.take``, a negative index counts
    from the end and an index out of range reads NaN; clamping first keeps
    a bad index from faulting the device."""
    n = weight.shape[0]
    idx = data.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, n - 1), weight)
    return out.masked_fill(~valid.unsqueeze(-1), float("nan"))


@register("Flatten", aliases=("flatten",))
def flatten_op(attrs, ctx, data):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


@register("Concat",
          arg_names=lambda a: tuple("arg%d" % i
                                    for i in range(int(a["num_args"]))),
          params={"num_args": 1, "dim": 1}, key_var_num_args="num_args",
          aliases=("concat",))
def concat(attrs, ctx, *args):
    """The inputs joined along ``dim`` (the channel axis 3 when every
    input is an NHWC activation and ``dim`` is 1)."""
    dim = int(attrs["dim"])
    if dim == 1 and all(_is_nhwc(a) for a in args):
        dim = 3
    return torch.cat(args, dim=dim)


@register("SliceChannel", num_outputs=lambda a: int(a["num_outputs"]),
          params={"num_outputs": 1, "axis": 1, "squeeze_axis": False},
          aliases=("split",))
def slice_channel(attrs, ctx, data):
    """``num_outputs`` equal parts along ``axis``, each without that axis
    under ``squeeze_axis``."""
    axis = int(attrs["axis"])
    if axis == 1 and _is_nhwc(data):
        axis = 3
    n = int(attrs["num_outputs"])
    if data.shape[axis] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d parts" % (axis, data.shape[axis], n))
    parts = torch.chunk(data, n, dim=axis)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("SwapAxis", params={"dim1": 0, "dim2": 0}, aliases=("swapaxes",))
def swapaxis(attrs, ctx, data):
    return data.transpose(int(attrs["dim1"]), int(attrs["dim2"]))


# ------------------------------------------------------------ normalization
@register("InstanceNorm", arg_names=("data", "gamma", "beta"),
          params={"eps": 1e-3})
def instance_norm(attrs, ctx, data, gamma, beta):
    """Each sample's channels normalized over their spatial axes (biased
    variance, in the input's dtype), then scaled by ``gamma`` and shifted
    by ``beta``."""
    ch = _ch_axis(data)
    red = [i for i in range(1, data.dim()) if i != ch]
    mean = data.mean(red, keepdim=True)
    var = (data - mean).square().mean(red, keepdim=True)
    bshape = [-1 if i == ch else 1 for i in range(data.dim())]
    out = (data - mean) * torch.rsqrt(var + float(attrs["eps"]))
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization", params={"eps": 1e-10, "mode": "instance"})
def l2_normalization(attrs, ctx, data):
    """``data / sqrt(sum(data^2) + eps)`` over each sample
    (``"instance"``), its channels (``"channel"``) or its spatial axes
    (``"spatial"``)."""
    mode = attrs["mode"]
    if mode == "instance":
        red = list(range(1, data.dim()))
    elif mode == "channel":
        red = [1]
    elif mode == "spatial":
        red = list(range(2, data.dim()))
    else:
        raise MXNetError("unknown mode %s" % mode)
    return data / torch.sqrt(data.square().sum(red, keepdim=True)
                             + float(attrs["eps"]))


@register("LRN", params={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                         "nsize": 5})
def lrn(attrs, ctx, data):
    """Local response normalization across ``nsize`` channels:
    ``x * (knorm + alpha / nsize * sum(x^2))^-beta``, the sum in f32 over
    the window centred on each channel (zeros past the edges)."""
    nsize = int(attrs["nsize"])
    ch = _ch_axis(data)
    sq = data.float().square()
    pre = nsize // 2
    widths = [0, 0] * (data.dim() - 1 - ch) + [pre, nsize - pre - 1]
    padded = F.pad(sq, widths)
    acc = 0
    for i in range(nsize):
        acc = acc + padded.narrow(ch, i, data.shape[ch])
    scale = float(attrs["knorm"]) + (float(attrs["alpha"]) / nsize) * acc
    return (data * scale ** (-float(attrs["beta"]))).to(data.dtype)


# ------------------------------------------------------- activations, more
@register("LeakyReLU", arg_names=lambda a: ("data", "gamma")
          if a["act_type"] == "prelu" else ("data",),
          params={"act_type": "leaky", "slope": 0.25,
                  "lower_bound": 0.125, "upper_bound": 0.334},
          stochastic=lambda a: a["act_type"] == "rrelu")
def leaky_relu(attrs, ctx, data, gamma=None):
    """x where x > 0, else: ``slope * x`` (leaky), ``gamma[c] * x``
    (prelu, per channel), ``slope * (e^x - 1)`` (elu) or, for rrelu, x
    times a slope drawn per element from U(lower_bound, upper_bound) in
    training and their mean at inference."""
    t = attrs["act_type"]
    pos = data > 0
    if t == "leaky":
        return torch.where(pos, data, data * float(attrs["slope"]))
    if t == "prelu":
        ch = _ch_axis(data)
        g = gamma.reshape([-1 if i == ch else 1 for i in range(data.dim())])
        return torch.where(pos, data, data * g)
    if t == "elu":
        return torch.where(pos, data,
                           float(attrs["slope"]) * (torch.exp(data) - 1))
    if t == "rrelu":
        lo, hi = float(attrs["lower_bound"]), float(attrs["upper_bound"])
        if ctx.is_train:
            slope = torch.rand(data.shape, generator=ctx.require_generator(),
                               device=data.device).to(data.dtype) \
                * (hi - lo) + lo
        else:
            slope = (lo + hi) / 2.0
        return torch.where(pos, data, data * slope)
    raise MXNetError("unknown act_type %s" % t)


def _softmax(x, axis):
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


@register("softmax", params={"axis": -1, "temperature": None})
def softmax_op(attrs, ctx, data):
    """Softmax over ``axis`` in f32 (of ``data / temperature`` when a
    temperature is given)."""
    x = data
    if attrs.get("temperature"):
        x = x / float(attrs["temperature"])
    return _softmax(x, int(attrs["axis"]))


@register("log_softmax", params={"axis": -1})
def log_softmax_op(attrs, ctx, data):
    return torch.log_softmax(data.float(), dim=int(attrs["axis"])) \
        .to(data.dtype)


@register("SoftmaxActivation", params={"mode": "instance"})
def softmax_activation(attrs, ctx, data):
    """Softmax over the channels (``"channel"``) or over each sample's
    flattened values (``"instance"``)."""
    if attrs["mode"] == "channel":
        return _softmax(data, _ch_axis(data))
    return _softmax(data.reshape(data.shape[0], -1), -1).reshape(data.shape)


# -------------------------------------------------------------- loss heads
def _label_grad(ctx, label):
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


class _HeadOutput(torch.autograd.Function):
    """A loss head: forward ``data`` (``sigmoid(data)`` for the logistic
    head); the backward ignores the head gradient and returns the
    reference's gradient for ``data`` and zeros for ``label``, as the JAX
    package's ``custom_vjp`` heads do: pred - label (linear), sign(pred -
    label) (MAE), sigmoid(data) - label (logistic), the hinge's (SVM)."""

    @staticmethod
    def forward(ctx, data, label, kind, cfg):
        ctx.save_for_backward(data, label)
        ctx.kind, ctx.cfg = kind, cfg
        return torch.sigmoid(data) if kind == "logistic" else data.clone()

    @staticmethod
    def backward(ctx, _head_grad):
        data, label = ctx.saved_tensors
        kind = ctx.kind
        if kind == "svm":
            grad = svm_grad(data, label, *ctx.cfg)
        else:
            lab = label.reshape(data.shape)
            if kind == "linear":
                grad = data - lab
            elif kind == "mae":
                grad = torch.sign(data - lab)
            else:
                grad = torch.sigmoid(data) - lab
        return grad.to(data.dtype), _label_grad(ctx, label), None, None


def svm_grad(x, label, margin, reg, use_linear):
    """The SVMOutput gradient: for the L1 hinge (``use_linear``) -y * reg
    where y * x < margin (y = +1 for the label's class, -1 else); for the
    squared-margin form each class that violates the margin against the
    label's score gets reg and the label's class minus reg times their
    count."""
    n = x.shape[-1]
    onehot = (label.long().unsqueeze(-1) == torch.arange(
        n, device=x.device)).to(x.dtype)
    sign = 2 * onehot - 1
    if use_linear:
        viol = ((margin - sign * x) > 0).to(x.dtype)
        return -sign * viol * reg
    correct = (x * onehot).sum(-1, keepdim=True)
    viol = ((x - correct + margin) > 0).to(x.dtype) * (1 - onehot)
    return (viol - onehot * viol.sum(-1, keepdim=True)) * reg


def _head(kind):
    def fc(attrs, ctx, data, label):
        return _HeadOutput.apply(data, label, kind, None)
    return fc


for _n, _k in [("LinearRegressionOutput", "linear"),
               ("MAERegressionOutput", "mae"),
               ("LogisticRegressionOutput", "logistic")]:
    register(_n, arg_names=("data", "label"), params={"grad_scale": 1.0},
             is_loss=True,
             doc="forward %s; backward the reference's gradient whatever the "
             "head gradient (``grad_scale`` is not read, as in the JAX "
             "package)" % ("sigmoid(data)" if _k == "logistic" else "data"))(
        _head(_k))


@register("SVMOutput", arg_names=("data", "label"),
          params={"margin": 1.0, "regularization_coefficient": 1.0,
                  "use_linear": False}, is_loss=True)
def svm_output(attrs, ctx, data, label):
    """Forward ``data``; backward :func:`svm_grad`."""
    return _HeadOutput.apply(
        data, label, "svm", (float(attrs["margin"]),
                             float(attrs["regularization_coefficient"]),
                             bool(attrs["use_linear"])))


class _MakeLoss(torch.autograd.Function):
    """Forward ``data``; the backward is ``grad_scale`` everywhere, divided
    by the batch (``"batch"``) or by the count of entries above
    ``valid_thresh`` (``"valid"``, at least 1)."""

    @staticmethod
    def forward(ctx, data, scale, norm, thresh):
        ctx.save_for_backward(data)
        ctx.cfg = (scale, norm, thresh)
        return data.clone()

    @staticmethod
    def backward(ctx, _head_grad):
        (x,) = ctx.saved_tensors
        scale, norm, thresh = ctx.cfg
        s = torch.full((), scale, dtype=x.dtype, device=x.device)
        if norm == "batch":
            s = s / x.shape[0]
        elif norm == "valid":
            s = s / (x > thresh).sum().clamp_min(1).to(x.dtype)
        return s.expand(x.shape).to(x.dtype), None, None, None


@register("MakeLoss", params={"grad_scale": 1.0, "valid_thresh": 0.0,
                              "normalization": "null"}, is_loss=True)
def make_loss(attrs, ctx, data):
    return _MakeLoss.apply(data, float(attrs["grad_scale"]),
                           attrs["normalization"],
                           float(attrs["valid_thresh"]))


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(attrs, ctx, data):
    """``data``, through which no gradient flows."""
    return data.detach()


class _KLSparse(torch.autograd.Function):
    """Forward ``data``; the backward adds the KL sparseness penalty
    ``penalty * (-s / ma + (1 - s) / (1 - ma))`` of each unit's running
    mean activation ``ma`` to the head gradient."""

    @staticmethod
    def forward(ctx, data, ma, s, penalty):
        ctx.save_for_backward(ma)
        ctx.cfg = (s, penalty)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (ma,) = ctx.saved_tensors
        s, penalty = ctx.cfg
        reg = penalty * (-s / ma + (1 - s) / (1 - ma))
        g2 = g.reshape(g.shape[0], -1)
        return (g2 + reg).reshape(g.shape).to(g.dtype), None, None, None


@register("IdentityAttachKLSparseReg", arg_names=("data",),
          aux_names=("moving_avg",),
          params={"sparseness_target": 0.1, "penalty": 0.001,
                  "momentum": 0.9})
def identity_attach_kl_sparse_reg(attrs, ctx, data, moving_avg):
    """Identity forward whose backward adds a KL sparseness penalty against
    the running mean activation ``moving_avg`` (pair with sigmoids).  The
    running mean moves on the training forward by ``1 - momentum`` toward
    the batch's mean, and the penalty reads the moved value, as in the JAX
    package (the reference moves it in the backward).  Returns ``(data,
    new_moving_avg)``."""
    momentum = float(attrs["momentum"])
    ma = moving_avg.detach().float()
    if ctx.is_train:
        avg = data.detach().reshape(data.shape[0], -1).float().mean(0)
        ma = momentum * ma + (1 - momentum) * avg
    out = _KLSparse.apply(data, ma, float(attrs["sparseness_target"]),
                          float(attrs["penalty"]))
    return out, ma.to(moving_avg.dtype)


@register("LSoftmax", arg_names=("data", "weight", "label"),
          params={"num_hidden": 0, "margin": 2, "beta": 1.0,
                  "beta_min": 0.0, "scale": 1.0, "verbose": False})
def lsoftmax(attrs, ctx, data, weight, label):
    """Large-margin softmax's inner product in f32: ``x W^T``, and in
    training the label's column replaced by ``(beta f + |x||w| psi) / (1 +
    beta)`` with ``psi(theta) = (-1)^k cos(m theta) - 2k`` on the
    monotone extension of the cosine."""
    m = int(attrs["margin"])
    beta = float(attrs["beta"])
    x, w = data.float(), weight.float()
    out = x @ w.t()
    if m == 1 or not ctx.is_train:
        return out.to(data.dtype)
    n = x.shape[0]
    y = label.long().clamp(0, w.shape[0] - 1)
    wy = w[y]
    xn, wn = x.norm(dim=1), wy.norm(dim=1)
    rows = torch.arange(n, device=x.device)
    fy = out[rows, y]
    cos = (fy / (xn * wn).clamp_min(1e-12)).clamp(-1.0, 1.0)
    j = torch.arange(1, m + 1, dtype=torch.float32, device=x.device)
    thresholds = torch.cos(j * math.pi / m)
    k = (cos.detach()[:, None] < thresholds[None, :]).sum(1).float()
    cos_m = torch.cos(m * torch.acos(cos))
    psi = torch.pow(-1.0, k) * cos_m - 2.0 * k
    fy_new = (beta * fy + xn * wn * psi) / (1.0 + beta)
    return out.index_put((rows, y), fy_new).to(data.dtype)


# ---------------------------------------------------------------- shape ops
@register("Pad", params={"mode": "constant", "pad_width": (),
                         "constant_value": 0.0})
def pad_op(attrs, ctx, data):
    """``pad_width`` (before, after) pairs in the reference's NCHW axis
    order (permuted for NHWC activations); ``"constant"``, ``"edge"`` or
    ``"reflect"``.  The last two pad only the spatial axes."""
    pw = tuple(int(p) for p in attrs["pad_width"])
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    nhwc = len(pairs) == 4 and _is_nhwc(data)
    mode = attrs["mode"]
    if mode == "constant":
        if nhwc:
            pairs = [pairs[0], pairs[2], pairs[3], pairs[1]]
        widths = [w for p in reversed(pairs) for w in p]
        return F.pad(data, widths, value=float(attrs["constant_value"]))
    if mode not in ("edge", "reflect"):
        raise MXNetError("unknown pad mode %s" % mode)
    if any(p != (0, 0) for p in pairs[:2]):
        raise MXNetError("Pad %s pads only the spatial axes" % mode)
    # F.pad's edge and reflect modes pad the trailing axes: the spatial
    # ones of the NCHW view
    x = data.permute(0, 3, 1, 2) if nhwc else data
    widths = [w for p in reversed(pairs[2:]) for w in p]
    y = F.pad(x, widths, mode="replicate" if mode == "edge" else "reflect")
    return y.permute(0, 2, 3, 1) if nhwc else y


@register("UpSampling", arg_names=lambda a: tuple(
    "arg%d" % i for i in range(int(a["num_args"]))),
          params={"scale": 1, "num_filter": 0, "sample_type": "nearest",
                  "multi_input_mode": "concat", "num_args": 1,
                  "workspace": 512},
          key_var_num_args="num_args")
def upsampling(attrs, ctx, *args):
    """Nearest-neighbour upsampling by ``scale``; several inputs are each
    brought to the first's size times ``scale`` and summed or joined on
    the channels."""
    scale = int(attrs["scale"])
    h_ax = 1 if _is_nhwc(args[0]) else 2
    target = args[0].shape[h_ax] * scale
    outs = []
    for a in args:
        s = target // a.shape[h_ax]
        outs.append(a.repeat_interleave(s, dim=h_ax)
                    .repeat_interleave(s, dim=h_ax + 1))
    if len(outs) == 1:
        return outs[0]
    if attrs["multi_input_mode"] == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=3 if _is_nhwc(args[0]) else 1)


@register("Crop", arg_names=lambda a: tuple(
    "arg%d" % i for i in range(int(a["num_args"]))),
          params={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                  "center_crop": False},
          key_var_num_args="num_args")
def crop(attrs, ctx, *args):
    """A (h, w) window of ``data``: ``h_w``, or the second input's spatial
    size; at ``offset`` or centred."""
    data = args[0]
    h_ax = 1 if _is_nhwc(data) else 2
    if len(args) == 2:
        h, w = args[1].shape[h_ax], args[1].shape[h_ax + 1]
    else:
        h, w = (int(v) for v in attrs["h_w"])
    if attrs["center_crop"]:
        oh = (data.shape[h_ax] - h) // 2
        ow = (data.shape[h_ax + 1] - w) // 2
    else:
        oh, ow = (int(v) for v in attrs["offset"])
    return data.narrow(h_ax, oh, h).narrow(h_ax + 1, ow, w)


# -------------------------------------------------------------- sequence ops
def _seq_args(a):
    return ("data", "sequence_length") if a["use_sequence_length"] \
        else ("data",)


def _lengths(length, data):
    """The lengths as a (1, B, 1, ...) long tensor against a time-major
    ``data``."""
    return length.long().reshape((1, -1) + (1,) * (data.dim() - 2))


@register("SequenceMask", arg_names=_seq_args,
          params={"use_sequence_length": False, "value": 0.0, "axis": 0})
def sequence_mask(attrs, ctx, data, sequence_length=None):
    """Time-major (T, B, ...) ``data`` with the steps past each sequence's
    length set to ``value``."""
    if sequence_length is None:
        return data
    steps = torch.arange(data.shape[0], device=data.device).reshape(
        (-1,) + (1,) * (data.dim() - 1))
    return torch.where(steps < _lengths(sequence_length, data), data,
                       torch.full((), float(attrs["value"]),
                                  dtype=data.dtype, device=data.device))


@register("SequenceLast", arg_names=_seq_args,
          params={"use_sequence_length": False, "axis": 0})
def sequence_last(attrs, ctx, data, sequence_length=None):
    """Each sequence's last step (T, B, ...) -> (B, ...)."""
    if sequence_length is None:
        return data[-1]
    idx = (_lengths(sequence_length, data) - 1).expand(
        (1,) + tuple(data.shape[1:]))
    return data.gather(0, idx)[0]


@register("SequenceReverse", arg_names=_seq_args,
          params={"use_sequence_length": False, "axis": 0})
def sequence_reverse(attrs, ctx, data, sequence_length=None):
    """Each sequence's first ``length`` steps reversed, the rest kept."""
    if sequence_length is None:
        return data.flip(0)
    t = data.shape[0]
    steps = torch.arange(t, device=data.device).reshape(
        (t,) + (1,) * (data.dim() - 1))
    lens = _lengths(sequence_length, data)
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    return data.gather(0, src.expand(data.shape))


@register("softmax_cross_entropy", arg_names=("data", "label"))
def softmax_cross_entropy(attrs, ctx, data, label):
    """``-sum(log_softmax(data)[i, label[i]])`` in f32, shape (1,); a label
    out of range clips."""
    logp = torch.log_softmax(data.float(), dim=-1)
    idx = label.long().clamp(0, data.shape[-1] - 1)
    picked = logp.gather(-1, idx[:, None])
    return (-picked.sum()).reshape(1).to(data.dtype)
