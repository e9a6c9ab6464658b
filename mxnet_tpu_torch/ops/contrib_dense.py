"""The dense contrib ops: the counterpart of ``mxnet_tpu/ops/contrib.py``'s
``_contrib_CTCLoss``, ``_contrib_quantize``/``_contrib_dequantize``,
``_contrib_fft``/``_contrib_ifft``, ``_contrib_count_sketch`` and
``_contrib_SwitchMoE`` (the MultiBox ops are in :mod:`.contrib`).

Each is written on PyTorch's own ops as the JAX op is on XLA's, with no
host sync, so each runs on the ``meta`` device (``Symbol.infer_shape``)
and differentiates by autograd where the JAX op differentiates by
``jax.vjp``.  Where the JAX op departs from the reference MXNet, the port
follows the JAX op:

* ``CTCLoss`` is the log-alpha recursion with ``-1e30`` for ``-inf`` (an
  infeasible alignment costs about 1e30, not inf), a label's length counts
  its entries > 0, blank is class 0, ``blank_label="last"`` raises, and
  ``logaddexp`` differentiates by ``jnp.logaddexp``'s rule.
* ``fft`` is the full complex FFT of the real input, interleaved re/im;
  ``ifft`` takes numpy's 1/N and the real part (the reference's ifft is
  unnormalized); neither reads ``compute_size``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, dtype_np, torch_dtype
from .registry import register

__all__ = ["ctc_loss"]

#: the recursion's -inf
NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` as ``jnp.logaddexp`` computes it, with its
    gradient rule ``exp(a - out)``, ``exp(b - out)``: where both inputs sit
    at the -1e30 floor, ``out`` rounds to the floor and each weight reads 1
    (torch's own rule gives the exact 1/2)."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b,
                          torch.maximum(a, b)
                          + torch.log1p(torch.exp(-delta.abs())))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_logaddexp = _LogAddExp.apply


@register("_contrib_CTCLoss", arg_names=("data", "label"), num_outputs=1,
          params={"use_data_lengths": False, "use_label_lengths": False,
                  "blank_label": "first"},
          aliases=("CTCLoss", "ctc_loss"), is_loss=True)
def ctc_loss(attrs, ctx, data, label):
    """CTC loss of activations ``data`` (T, B, V) against labels (B, L)
    padded with 0 (blank is class 0): -log of the summed probability of
    the alignments, one value a sample, in f32.  The forward recursion
    runs over the T steps of the extended label (blanks interleaved,
    2L + 1 states), the batch at once."""
    t_len, batch, vocab = data.shape
    if attrs["blank_label"] != "first":
        raise MXNetError("only blank_label='first' supported")
    logp = torch.log_softmax(data.float(), dim=-1)
    labels = label.to(torch.int32).long()
    lab_len = (labels > 0).sum(dim=1)
    s = 2 * labels.shape[1] + 1
    dev = data.device
    ext = torch.zeros(batch, s, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    s_len = 2 * lab_len + 1
    idx = torch.arange(s, device=dev)
    can_skip = (idx % 2 == 1) & (idx >= 2)
    same = torch.where(idx >= 2, ext == torch.roll(ext, 2, dims=1),
                       torch.ones_like(ext, dtype=torch.bool))
    # the classes read: a negative label counts from the end, as a jnp
    # index does, and an index past the end is clamped
    ext = torch.where(ext < 0, ext + vocab, ext).clamp(0, vocab - 1)
    allow2 = can_skip & ~same
    live = idx < s_len[:, None]
    neg = torch.full((batch, 1), NEG_INF, device=dev)
    first = logp[0]
    alpha = torch.cat([
        first[:, :1],
        torch.where(lab_len[:, None] > 0, first.gather(-1, ext[:, 1:2]),
                    neg),
        neg.expand(batch, s - 2)], dim=1)
    for t in range(1, t_len):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        a = _logaddexp(alpha, prev1)
        a = torch.where(allow2, _logaddexp(a, prev2), a)
        a = a + logp[t].gather(-1, ext)
        alpha = torch.where(live, a, torch.full_like(a, NEG_INF))
    last = alpha.gather(-1, (s_len - 1).clamp(min=0)[:, None])[:, 0]
    last2 = torch.where(
        s_len >= 2, alpha.gather(-1, (s_len - 2).clamp(min=0)[:, None])
        [:, 0], torch.full_like(last, NEG_INF))
    return -_logaddexp(last, last2)


def _int_range(dtype):
    info = torch.iinfo(dtype)
    return float(info.min), float(info.max)


@register("_contrib_quantize", arg_names=("data", "min_range", "max_range"),
          num_outputs=3, params={"out_type": "uint8"})
def quantize(attrs, ctx, data, min_range, max_range):
    """``data`` in [min_range, max_range] to the integers of ``out_type``
    (uint8 or int8), rounded half to even and clipped; the range passes
    through as the second and third outputs."""
    out_dt = torch_dtype(dtype_np(attrs["out_type"]))
    qmin, qmax = _int_range(out_dt)
    scale = (qmax - qmin) / (max_range - min_range)
    q = torch.clamp(torch.round((data - min_range) * scale + qmin),
                    qmin, qmax)
    return q.to(out_dt), min_range, max_range


@register("_contrib_dequantize", arg_names=("data", "min_range", "max_range"),
          params={"out_type": "float32"})
def dequantize(attrs, ctx, data, min_range, max_range):
    """Integers of ``data``'s type back to [min_range, max_range]."""
    imin, imax = _int_range(data.dtype)
    scale = (max_range - min_range) / (imax - imin)
    return ((data.float() - imin) * scale + min_range) \
        .to(torch_dtype(dtype_np(attrs["out_type"])))


@register("_contrib_fft", params={"compute_size": 128})
def fft(attrs, ctx, data):
    """The complex FFT of the real ``data`` over its last axis, as
    interleaved (re, im) pairs: (..., N) -> (..., 2N), f32."""
    out = torch.fft.fft(data.float(), dim=-1)
    return torch.view_as_real(out).reshape(
        data.shape[:-1] + (2 * data.shape[-1],)).float()


@register("_contrib_ifft", params={"compute_size": 128})
def ifft(attrs, ctx, data):
    """The real part of the inverse FFT (numpy's 1/N) of interleaved
    (re, im) pairs: (..., 2N) -> (..., N), f32."""
    re = data[..., 0::2].float()
    im = data[..., 1::2].float()
    return torch.fft.ifft(torch.complex(re, im), dim=-1).real.float()


@register("_contrib_count_sketch", arg_names=("data", "h", "s"),
          params={"out_dim": 0, "processing_batch_size": 32})
def count_sketch(attrs, ctx, data, h, s):
    """``out[..., h[i]] += s[i] * data[..., i]``; duplicate ``h`` entries
    sum."""
    idx = h.to(torch.int32).long().reshape(-1)
    sign = s.to(data.dtype).reshape(-1)
    out = torch.zeros(data.shape[:-1] + (int(attrs["out_dim"]),),
                      dtype=data.dtype, device=data.device)
    return out.index_add(-1, idx, data * sign)


@register("_contrib_SwitchMoE",
          arg_names=("data", "router_weight", "expert1_weight",
                     "expert1_bias", "expert2_weight", "expert2_bias"),
          num_outputs=2,
          params={"num_experts": 0, "hidden_size": 0,
                  "capacity_factor": 1.25},
          aliases=("SwitchMoE",))
def switch_moe_op(attrs, ctx, data, router_weight, expert1_weight,
                  expert1_bias, expert2_weight, expert2_bias):
    """Switch-routed mixture-of-experts FFN over (batch, seq, d) or
    (tokens, d) inputs: ``(output, load_balance_loss)``, the Symbol surface
    of :func:`mxnet_tpu_torch.parallel.moe.switch_moe` on one device."""
    from ..parallel.moe import switch_moe
    if int(attrs["num_experts"]) <= 0 or int(attrs["hidden_size"]) <= 0:
        raise MXNetError("_contrib_SwitchMoE requires num_experts > 0 "
                         "and hidden_size > 0")
    if (router_weight.shape[1] != int(attrs["num_experts"])
            or expert1_weight.shape[2] != int(attrs["hidden_size"])):
        raise MXNetError(
            "_contrib_SwitchMoE: weights shaped for E=%d, ff=%d do not "
            "match num_experts=%s hidden_size=%s"
            % (router_weight.shape[1], expert1_weight.shape[2],
               attrs["num_experts"], attrs["hidden_size"]))
    shape = data.shape
    x = data.reshape(-1, shape[-1]) if data.dim() > 2 else data
    y, aux = switch_moe(x, router_weight, expert1_weight, expert1_bias,
                        expert2_weight, expert2_bias,
                        capacity_factor=float(attrs["capacity_factor"]))
    return y.reshape(shape), aux
