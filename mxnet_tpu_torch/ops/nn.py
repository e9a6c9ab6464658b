"""Neural-network ops: the subset of ``mxnet_tpu/ops/nn.py`` that the GPT
serves and trains with.  Parameter names and defaults are the JAX
package's.  The dense products stay ``F.linear``: the JAX package left them
to XLA, and the port leaves them to PyTorch.  Gradients come from autograd,
except SoftmaxOutput's, which is the reference's hand-written loss gradient
(an ``autograd.Function``, as the JAX op is a ``custom_vjp``).  No op writes
in place into a tensor that autograd saved."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("FullyConnected", arg_names=lambda a: ("data", "weight")
          if a["no_bias"] else ("data", "weight", "bias"),
          params={"num_hidden": 0, "no_bias": False, "flatten": True},
          aliases=("fully_connected",))
def fully_connected(attrs, ctx, data, weight, bias=None):
    """Y = X W^T + b, W of shape (num_hidden, in)."""
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    return F.linear(x, weight, bias).to(data.dtype)


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


@register("Activation", params={"act_type": "relu"}, aliases=("activation",))
def activation(attrs, ctx, data):
    """relu; the other act_types are not yet ported."""
    if attrs["act_type"] != "relu":
        raise MXNetError("Activation act_type=%r is not yet ported to "
                         "mxnet_tpu_torch" % attrs["act_type"])
    return torch.relu(data)


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
