"""Flash attention: the hand-written CUDA kernels, their plain versions,
the autograd function and the ``_contrib_FlashAttention`` op.

The counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  The TPU kernels
(``_flash_attention_fwd_pallas`` and ``_flash_attention_bwd_pallas``, each
in a panel and a streamed form) become two CUDA sources each, chosen by
dtype: float32 runs on the CUDA cores (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``), bfloat16 on the tensor cores through
wgmma with TMA loads (``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``).  Each is built with ``nvcc`` for
``sm_90a`` on first use and called through ctypes on PyTorch's current
stream.

* :func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the
  wrappers: a CUDA tensor launches the kernel of its dtype or raises; a
  CPU (or meta) tensor takes the plain version.  ``.launches`` on each
  counts launches of either route.
* :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`
  compute the same results in PyTorch, the TPU kernels' panel arithmetic in
  f32.  The tests and ``chip_smoke.py`` hold the kernels against them.
* :class:`FlashAttention` is the ``torch.autograd.Function`` (the
  counterpart of the JAX ``custom_vjp``): forward through
  :func:`flash_attention_fwd`, backward through :func:`flash_attention_bwd`.
* :func:`attention_plain` is the counterpart of ``_attention_jnp``: the op
  takes it for shapes outside the kernel's dispatch gate (ragged lengths,
  tk != tq), as the JAX op does.

Layout everywhere: q, k, v are (batch, seq, heads, head_dim); ``lse`` is
(batch*heads, seq, 1) f32 with row ``b*heads + h``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["flash_attention_fwd", "flash_attention_plain", "attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "FlashAttention", "KERNEL_HEAD_DIMS"]

_BLOCK_Q = 128

#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def attention_plain(q, k, v, causal):
    """softmax(q k^T / sqrt(D) [causal]) v in q's dtype; tk may differ
    from tq (the counterpart of ``_attention_jnp``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def flash_attention_plain(q, k, v, causal):
    """``(o, lse)`` of the flash forward in plain PyTorch: the TPU panel
    kernel's arithmetic (f32 scores, row max m, p = exp(s - m), l = sum p,
    o = (p v) / l, lse = m + log l)."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones(t, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(b * h, t, 1)
    return o.to(q.dtype), lse


def kernel_strides(x):
    """(batch, seq, heads) strides of a (B, T, H, D) tensor in elements.
    A dim of size 1 is never stepped, so its stride is replaced by a
    packed one: TMA wants every stride 16-byte aligned, whatever a size-1
    dim of a view says."""
    b, t, h, d = x.shape
    sb, st, sh = x.stride()[:3]
    if h == 1:
        sh = d
    if t == 1:
        st = h * sh
    if b == 1:
        sb = t * st
    return sb, st, sh


def check_kernel_args(q, k, v, *more, name="flash_attention_fwd"):
    """Raise unless the CUDA kernel takes these tensors: (B, T, H, D) of one
    shape, one dtype (f32 or bf16) and one device, D in
    :data:`KERNEL_HEAD_DIMS`, last dim contiguous.  The bf16 route loads by
    TMA, so there every base address and every stride must also be a
    multiple of 16 bytes.  ``more`` are further tensors held to the same
    rules (the backward's dO and O)."""
    xs = (q, k, v) + more
    if q.dim() != 4 or any(x.shape != q.shape for x in xs):
        raise MXNetError("%s: the inputs must share one (batch, seq, heads, "
                         "head_dim) shape, got %s"
                         % (name, " ".join(str(tuple(x.shape)) for x in xs)))
    if any(x.dtype != q.dtype for x in xs) or q.dtype not in _KERNEL_DTYPES:
        raise MXNetError("%s: the kernel takes float32 or bfloat16 inputs "
                         "of one dtype, got %s"
                         % (name, " ".join(str(x.dtype) for x in xs)))
    if any(x.device != q.device for x in xs):
        raise MXNetError("%s: inputs on different devices" % name)
    b, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise MXNetError("%s: head_dim %d is not supported by the CUDA "
                         "kernel (supported: %s)"
                         % (name, d, ", ".join(map(str, KERNEL_HEAD_DIMS))))
    if any(x.stride(-1) != 1 for x in xs):
        raise MXNetError("%s: the last dim of every input must be "
                         "contiguous" % name)
    if b * h > 65535 or t < 1:
        raise MXNetError("%s: batch*heads must be at most 65535 and seq at "
                         "least 1, got %d and %d" % (name, b * h, t))
    if q.dtype == torch.bfloat16:
        if b * h * t >= 2 ** 31:
            raise MXNetError("%s: batch*heads*seq must be below 2**31, got "
                             "%d" % (name, b * h * t))
        for x in xs:
            if x.data_ptr() % 16 or any(
                    s * x.element_size() % 16 for s in kernel_strides(x)):
                raise MXNetError(
                    "%s: the bf16 kernel loads by TMA, which needs a "
                    "16-byte aligned base and (batch, seq, heads) strides "
                    "of a multiple of 16 bytes; got base %% 16 = %d and "
                    "strides %s" % (name, x.data_ptr() % 16,
                                    x.stride()[:3]))


# q, k, v, o, lse, b, t, h, d, the strides of q, k, v, causal, stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 9 + [ctypes.c_int, ctypes.c_void_p])


#: dtype -> (library, entry, error-string function): f32 on the CUDA-core
#: kernel, bf16 on the tensor-core (sm90) kernel
_FWD_ROUTES = {
    torch.float32: ("flash_attention_fwd", "mxtt_flash_attention_fwd",
                    "mxtt_error_string"),
    torch.bfloat16: ("flash_attention_fwd_sm90",
                     "mxtt_flash_attention_fwd_sm90",
                     "mxtt_fwd_sm90_error_string"),
}


def _bind(route, argtypes):
    """``(entry function, error-string function)`` of a route's kernel
    library, built on first use; a failed build raises."""
    from .. import cuda_build
    name, entry, errfn = route
    lib = cuda_build.library(name)
    fn = getattr(lib, entry)
    err = getattr(lib, errfn)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return fn, err


def _launch(q, k, v, causal):
    check_kernel_args(q, k, v)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t, 1), dtype=torch.float32, device=q.device)
    route = _FWD_ROUTES[q.dtype]
    fn, err = _bind(route, _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, t, h, d,
                *(s for x in (q, k, v) for s in kernel_strides(x)),
                int(bool(causal)), stream)
    if rc != 0:
        raise MXNetError("flash_attention_fwd: CUDA launch failed (%s): %s "
                         "(%d)" % (route[0], err(rc).decode(), rc))
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal):
    """``(o, lse)`` of attention over (B, T, H, D) inputs.  A CUDA tensor
    launches the hand-written kernel of its dtype (or raises); a CPU or
    meta tensor takes :func:`flash_attention_plain`."""
    kind = q.device.type
    if kind == "cuda":
        return _launch(q, k, v, causal)
    if kind in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal)
    raise MXNetError("flash_attention_fwd: no path for device %s" % q.device)


flash_attention_fwd.launches = 0


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal):
    """``(dq, dk, dv)`` of the flash backward in plain PyTorch: the TPU
    panel kernel's arithmetic in f32.  P = exp(s - lse), dV = P^T dO,
    dP = dO V^T, dS = P * (dP - delta) * scale with delta = rowsum(dO * O),
    dQ = dS K, dK = dS^T Q; the gradients come back in q's dtype."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones(t, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - lse.reshape(b, h, t, 1))   # masked: exp(-inf) = 0
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


# q, k, v, dO, lse, delta, dq, dk, dv, b, t, h, d, the strides of q, k, v,
# dO, causal, stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])

#: as :data:`_FWD_ROUTES`, for the backward
_BWD_ROUTES = {
    torch.float32: ("flash_attention_bwd", "mxtt_flash_attention_bwd",
                    "mxtt_bwd_error_string"),
    torch.bfloat16: ("flash_attention_bwd_sm90",
                     "mxtt_flash_attention_bwd_sm90",
                     "mxtt_bwd_sm90_error_string"),
}


def _launch_bwd(q, k, v, o, lse, do, causal):
    name = "flash_attention_bwd"
    # autograd may hand over dO with any strides: the kernel reads it
    # through its (batch, seq, heads) strides, and only a dO whose last dim
    # is not contiguous is copied first
    if do.stride(-1) != 1:
        do = do.contiguous()
    check_kernel_args(q, k, v, do, o, name=name)
    b, t, h, d = q.shape
    if lse.shape != (b * h, t, 1) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise MXNetError("%s: lse must be a contiguous float32 (%d, %d, 1) "
                         "tensor on %s, got %s %s on %s"
                         % (name, b * h, t, q.device, tuple(lse.shape),
                            lse.dtype, lse.device))
    # delta = rowsum(dO * O) in f32, outside the kernel as in the TPU code,
    # in lse's (B*H, T, 1) layout; the product is taken in place in an f32
    # copy of dO (a copy even when dO is f32 already; o is widened inside
    # the multiply)
    delta = do.to(torch.float32, copy=True).mul_(o).sum(-1) \
        .transpose(1, 2).contiguous()
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    route = _BWD_ROUTES[q.dtype]
    fn, err = _bind(route, _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                *(s for x in (q, k, v, do) for s in kernel_strides(x)),
                int(bool(causal)), stream)
    if rc != 0:
        raise MXNetError("%s: CUDA launch failed (%s): %s (%d)"
                         % (name, route[0], err(rc).decode(), rc))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal):
    """``(dq, dk, dv)`` of attention over (B, T, H, D) inputs, from the
    forward's ``o`` and ``lse`` and the output gradient ``do``.  A CUDA
    tensor launches the hand-written kernel of its dtype (or raises); a
    CPU or meta tensor takes :func:`flash_attention_bwd_plain`."""
    kind = q.device.type
    if kind == "cuda":
        return _launch_bwd(q, k, v, o, lse, do, causal)
    if kind in ("cpu", "meta"):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    raise MXNetError("flash_attention_bwd: no path for device %s" % q.device)


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with the flash kernels on both passes: the counterpart of
    the JAX ``flash_attention`` custom_vjp.  The forward saves
    ``(q, k, v, o, lse)``; the backward rebuilds P from ``lse`` and returns
    dq, dk, dv in q's dtype (summed in f32)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = bool(causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


@register("_contrib_FlashAttention", arg_names=("q", "k", "v"),
          params={"causal": False})
def flash_attention_op(attrs, ctx, q, k, v):
    """Attention over (batch, seq, heads, head_dim) inputs, with the JAX
    op's dispatch gate: tk == tq and seq a multiple of min(128, seq) go
    through :class:`FlashAttention` (the flash kernels forward and, under
    autograd, backward); other shapes take :func:`attention_plain`, as the
    JAX op takes ``_attention_jnp``."""
    causal = bool(attrs["causal"])
    t = q.shape[1]
    block_q = min(_BLOCK_Q, t)
    if t > 0 and t % block_q == 0 and k.shape[1] == t:
        return FlashAttention.apply(q, k, v, causal)
    return attention_plain(q, k, v, causal)
