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
    """(kernel, stride, dilate, pad, groups) of a 2-d Convolution, with
    the reference's defaults filled in."""
    kernel = tuple(attrs["kernel"])
    nd = len(kernel)
    return (kernel, tuple(attrs["stride"]) or (1,) * nd,
            tuple(attrs["dilate"]) or (1,) * nd,
            tuple(attrs["pad"]) or (0,) * nd, int(attrs["num_group"]))


@register("Convolution", arg_names=lambda a: ("data", "weight")
          if a["no_bias"] else ("data", "weight", "bias"),
          params={"kernel": (1, 1), "stride": (), "dilate": (), "pad": (),
                  "num_filter": 0, "num_group": 1, "no_bias": False,
                  "workspace": 1024, "cudnn_tune": None, "cudnn_off": False,
                  "layout": None},
          aliases=("convolution", "Convolution_v1"))
def convolution(attrs, ctx, data, weight, bias=None):
    """2-d convolution, NCHW or (under ``image_layout("NHWC")`` or a
    ``layout="NHWC"`` attr) NHWC; weight (num_filter, C/group, kh, kw).
    1-d and 3-d convolutions are not yet ported."""
    kernel, stride, dilate, pad, groups = conv_statics(attrs)
    if len(kernel) != 2:
        raise MXNetError("Convolution with a %d-d kernel is not yet ported "
                         "to mxnet_tpu_torch" % len(kernel))
    layout = attrs.get("layout") or _IMAGE_LAYOUT
    if attrs.get("layout") and _IMAGE_LAYOUT == "NHWC" \
            and attrs["layout"] != "NHWC":
        raise MXNetError(
            "Convolution node pins layout=%r but the trainer runs "
            "image_layout('NHWC'); drop the explicit layout attr or train "
            "in NCHW" % (attrs["layout"],))
    y = conv2d(data, weight, bias, stride, pad, dilate, groups,
               layout == "NHWC")
    return y.to(data.dtype)


# ------------------------------------------------------------------- pooling
@register("Pooling",
          params={"kernel": (1, 1), "pool_type": "max", "global_pool": False,
                  "stride": (), "pad": (), "pooling_convention": "valid",
                  "cudnn_off": False},
          aliases=("pooling", "Pooling_v1"))
def pooling(attrs, ctx, data):
    """2-d max/avg/sum pooling, NCHW or NHWC.  Padding reads -inf for max
    and 0 otherwise; the stride defaults to 1 (the reference's, not the
    kernel); ``pooling_convention="full"`` pads the high side up to a
    whole window; avg divides by the full window, padding included."""
    if data.dim() != 4:
        raise MXNetError("Pooling of a %d-d input is not yet ported to "
                         "mxnet_tpu_torch" % data.dim())
    nhwc = _IMAGE_LAYOUT == "NHWC"
    x = data.permute(0, 3, 1, 2) if nhwc else data
    if attrs["global_pool"]:
        kernel, stride, pad = tuple(x.shape[2:]), (1, 1), (0, 0)
    else:
        kernel = _pair(attrs["kernel"])
        stride = tuple(attrs["stride"]) or (1, 1)
        pad = tuple(attrs["pad"]) or (0, 0)
    extra = [0, 0]
    if attrs.get("pooling_convention", "valid") == "full":
        for i in range(2):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                extra[i] = stride[i] - rem
    ptype = attrs["pool_type"]
    if ptype not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %s" % ptype)
    fill = float("-inf") if ptype == "max" else 0.0
    if any(extra) or any(p > k // 2 for p, k in zip(pad, kernel)):
        # asymmetric or wide padding: pad explicitly, pool unpadded
        x = F.pad(x, (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0]),
                  value=fill)
        pad = (0, 0)
    if ptype == "max":
        y = F.max_pool2d(x, kernel, stride, pad)
    else:
        y = F.avg_pool2d(x, kernel, stride, pad, count_include_pad=True)
        if ptype == "sum":
            y = y * (kernel[0] * kernel[1])
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


def bn_moments(s1, s2, n, c, mm, mv, momentum):
    """``(mean, var, new_mm, new_mv)`` from the shifted sums ``s1 =
    sum(x - c)`` and ``s2 = sum((x - c)^2)`` over ``n`` values: the biased
    variance E[(x-c)^2] - E[x-c]^2, and the moving statistics moved toward
    the batch's by ``1 - momentum``."""
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
    dgamma = ((dyf * xs).sum(red) - meanc * dbeta) * inv
    if train_stats:
        n = xf.numel() // mean.numel()
        dmean = dmean_o + (1 - momentum) * dmm_o
        dvar = dvar_o + (1 - momentum) * dmv_o
        k = (-a * inv * dgamma + 2.0 * dvar) * (1.0 / n)
        d = -k * meanc - a * dbeta * (1.0 / n) + dmean * (1.0 / n)
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
          params={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def layer_norm(attrs, ctx, data, gamma, beta):
    """Layer normalization over ``axis``; statistics in f32, the result
    cast back to the input's dtype.  ``output_mean_var`` is not yet
    ported."""
    if attrs["output_mean_var"]:
        raise MXNetError("LayerNorm output_mean_var=True is not yet ported "
                         "to mxnet_tpu_torch")
    axis = int(attrs["axis"])
    eps = float(attrs["eps"])
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = (xf - mean).square().mean(dim=axis, keepdim=True)
    inv = torch.rsqrt(var + eps)
    bshape = tuple(data.shape[axis] if i == (axis % data.dim()) else 1
                   for i in range(data.dim()))
    return ((xf - mean) * inv * gamma.float().reshape(bshape)
            + beta.float().reshape(bshape)).to(data.dtype)


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
