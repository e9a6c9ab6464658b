"""Flash attention: the hand-written CUDA kernels, their plain versions,
the autograd function and the ``_contrib_FlashAttention`` op.

The counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  The TPU kernels
(``_flash_attention_fwd_pallas`` and ``_flash_attention_bwd_pallas``, each
in a panel and a streamed form) become two CUDA sources each, chosen by
dtype, all on the tensor cores with TMA loads: float32 as split TF32
(three TF32 products a product, f32's accuracy) on ``mma.sync``
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``),
bfloat16 on wgmma (``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``).  The backward's row sums delta =
rowsum(dO * O) are a kernel of their own for both routes
(``csrc/flash_attention_delta.cu``).  Each is built with ``nvcc`` for
``sm_90a`` on first use and called through ctypes on PyTorch's current
stream.

* :func:`flash_attention_fwd`, :func:`flash_attention_bwd` and
  :func:`flash_attention_delta` are the wrappers: a CUDA tensor launches
  the kernel of its dtype or raises; a CPU (or meta) tensor takes the plain
  version.  ``.launches`` on each counts launches of either route, and
  ``.source_launches`` on the forward and the backward counts them by
  kernel library (``flash_attention_fwd`` for f32,
  ``flash_attention_fwd_sm90`` for bf16, and so for the backward).
* :func:`flash_attention_plain`, :func:`flash_attention_bwd_plain` and
  :func:`flash_attention_delta_plain` compute the same results in PyTorch,
  the TPU kernels' panel arithmetic in f32.  The tests and
  ``chip_smoke.py`` hold the kernels against them.
* :func:`kernel_takes` is the one rule of what the kernels take: the
  wrappers raise on the rest (:func:`check_kernel_args`) and the op routes
  the rest to :func:`attention_plain`.
* :class:`FlashAttention` is the ``torch.autograd.Function`` (the
  counterpart of the JAX ``custom_vjp``): forward through
  :func:`flash_attention_fwd`, backward through :func:`flash_attention_bwd`.
* :func:`attention_plain` is the counterpart of ``_attention_jnp``: the op
  takes it for shapes outside the kernel's dispatch gate (ragged lengths,
  tk != tq) and for inputs the kernels do not take, as the JAX op does.

Layout everywhere: q, k, v are (batch, seq, heads, head_dim); ``lse`` is
(batch*heads, seq, 1) f32 with row ``b*heads + h``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..autotune import cache as _tune_cache
from ..base import MXNetError
from ..cuda_build import on_device
from ..telemetry import costdb as _costdb
from .registry import register

__all__ = ["flash_attention_fwd", "flash_attention_plain", "attention_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_delta", "flash_attention_delta_plain",
           "FlashAttention", "KERNEL_HEAD_DIMS", "kernel_takes",
           "check_kernel_args", "kernel_tiles", "select_tile"]

_BLOCK_Q = 128

#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_F32_FWD = [(128, 64), (128, 32), (64, 64), (64, 32)]
_F32_BWD = [(64, 32), (64, 64)]

#: ``(which, dtype, head dim) -> [(block_q, block_k), ...]``: the tiles each
#: kernel is built for, its built-in choice first (the autotuner's
#: candidates).  Forward: query rows a block by keys a K/V tile; the bf16
#: forward's block is always 128 rows (two consumer warpgroups).  Backward:
#: rows a block owns (64) by rows a streamed tile.  Where one tile alone
#: fits, the list holds one: the f32 forward and backward at D = 128, whose
#: 64-row stages would leave two blocks an SM no room in shared memory.
_TILES = {
    ("fwd", torch.float32, 32): _F32_FWD,
    ("fwd", torch.float32, 64): _F32_FWD,
    ("fwd", torch.float32, 128): [(64, 32)],
    ("fwd", torch.bfloat16, 32): [(128, 128), (128, 64)],
    ("fwd", torch.bfloat16, 64): [(128, 128), (128, 64)],
    ("fwd", torch.bfloat16, 128): [(128, 64), (128, 32)],
    ("bwd", torch.float32, 32): _F32_BWD,
    ("bwd", torch.float32, 64): _F32_BWD,
    ("bwd", torch.float32, 128): [(64, 32)],
    ("bwd", torch.bfloat16, 32): [(64, 64), (64, 32)],
    ("bwd", torch.bfloat16, 64): [(64, 64), (64, 32)],
    ("bwd", torch.bfloat16, 128): [(64, 64), (64, 32)],
}


def kernel_tiles(which, dtype, head_dim):
    """The ``(block_q, block_k)`` tiles the ``which`` (``fwd``/``bwd``)
    kernel takes at this dtype and head dim, the built-in one first; [] for
    inputs no kernel takes."""
    return list(_TILES.get((which, dtype, int(head_dim)), ()))


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


# select_tile's answers: (which, shape, dtype, device, causal) -> (the
# cache's resolution token, the tile); a key's first call a generation
# goes through autotune.kernel_config, the rest cost one dict lookup
_SELECTED = {}


def select_tile(which, q, causal, blocks=None):
    """The ``(block_q, block_k)`` the ``which`` kernel launches with for q
    of shape (B, T, H, D), or None for its built-in choice.  ``blocks``, an
    explicit override (the tuners measure through it), must be one of
    :func:`kernel_tiles` or raises.  Without it the tuning cache is
    consulted under the JAX package's key (``flash_attention_<which>``, q's
    shape and dtype, ``{"causal": ...}``); a cached tile the kernel does not
    take at this dtype and D degrades to the built-in choice, as JAX's
    ``_select_blocks`` does."""
    if blocks is None:
        token = _tune_cache.resolution_token()
        if token[0] == "off":
            return None
        key = (which, q.shape, q.dtype, q.device, bool(causal))
        got = _SELECTED.get(key)
        if got is not None and got[0] == token and token[0] == "cache":
            return got[1]
    legal = kernel_tiles(which, q.dtype, q.shape[-1])
    if blocks is not None:
        blocks = tuple(int(b) for b in blocks)
        if blocks not in legal:
            raise MXNetError(
                "flash_attention_%s: tile %s is not one the %s kernel takes "
                "at D=%d (%s)" % (which, blocks, _dtype_name(q.dtype),
                                  q.shape[-1], legal))
        return blocks
    if not legal:
        return None
    cfg = _tune_cache.kernel_config(
        "flash_attention_%s" % which, [tuple(q.shape)],
        [_dtype_name(q.dtype)], extra={"causal": bool(causal)},
        backend=_costdb.backend_name(q.device))
    pair = None
    if cfg:
        try:
            pair = (int(cfg.get("block_q", legal[0][0])),
                    int(cfg.get("block_k", legal[0][1])))
        except (TypeError, ValueError):
            pair = None
    pair = pair if pair in legal else None
    _SELECTED[key] = (_tune_cache.resolution_token(), pair)
    return pair


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


def _tma_aligned(x):
    """Whether TMA can load ``x``: a 16-byte aligned base and (batch, seq,
    heads) strides of a multiple of 16 bytes."""
    return x.data_ptr() % 16 == 0 and all(
        s * x.element_size() % 16 == 0 for s in kernel_strides(x))


def kernel_takes(q, k, v, *more):
    """``None`` when the CUDA kernels take these tensors, else the reason
    they do not.  They take (B, T, H, D) tensors of one shape, one dtype
    (f32 or bf16) and one device, D in :data:`KERNEL_HEAD_DIMS`, the last
    dim contiguous, B*H at most 65535, T at least 1 and B*H*T below 2**31.
    Both routes load by TMA, so every base address and every stride must
    also be a multiple of 16 bytes.  ``more`` are further tensors held to
    the same rules (the backward's dO and O).  The one rule of both the
    wrappers (:func:`check_kernel_args`) and the op's gate."""
    xs = (q, k, v) + more
    if q.dim() != 4 or any(x.shape != q.shape for x in xs):
        return ("the inputs must share one (batch, seq, heads, head_dim) "
                "shape, got %s" % " ".join(str(tuple(x.shape)) for x in xs))
    if any(x.dtype != q.dtype for x in xs) or q.dtype not in _KERNEL_DTYPES:
        return ("the kernel takes float32 or bfloat16 inputs of one dtype, "
                "got %s" % " ".join(str(x.dtype) for x in xs))
    if any(x.device != q.device for x in xs):
        return "inputs on different devices"
    b, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        return ("head_dim %d is not supported by the CUDA kernel "
                "(supported: %s)" % (d, ", ".join(map(str, KERNEL_HEAD_DIMS))))
    if any(x.stride(-1) != 1 for x in xs):
        return "the last dim of every input must be contiguous"
    if b * h > 65535 or t < 1:
        return ("batch*heads must be at most 65535 and seq at least 1, got "
                "%d and %d" % (b * h, t))
    if b * h * t >= 2 ** 31:
        return "batch*heads*seq must be below 2**31, got %d" % (b * h * t)
    for x in xs:
        if not _tma_aligned(x):
            return ("the kernels load by TMA, which needs a 16-byte aligned "
                    "base and (batch, seq, heads) strides of a multiple of 16 "
                    "bytes; got base %% 16 = %d and strides %s"
                    % (x.data_ptr() % 16, x.stride()[:3]))
    return None


def check_kernel_args(q, k, v, *more, name="flash_attention_fwd"):
    """Raise ``MXNetError`` unless the CUDA kernels take these tensors
    (:func:`kernel_takes`)."""
    why = kernel_takes(q, k, v, *more)
    if why is not None:
        raise MXNetError("%s: %s" % (name, why))


# q, k, v, o, lse, b, t, h, d, the strides of q, k, v, causal, then the
# tile (f32: block_q and block_k; bf16: block_k), stream
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
         + [ctypes.c_longlong] * 9 + [ctypes.c_int])
_FWD_ARGTYPES = {torch.float32: _ARGS + [ctypes.c_int] * 2
                 + [ctypes.c_void_p],
                 torch.bfloat16: _ARGS + [ctypes.c_int, ctypes.c_void_p]}


#: dtype -> (library, entry, error-string function): f32 on the split-TF32
#: kernel, bf16 on the wgmma (sm90) kernel
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


def _launch(q, k, v, causal, blocks=None):
    check_kernel_args(q, k, v)
    tile = select_tile("fwd", q, causal, blocks)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t, 1), dtype=torch.float32, device=q.device)
    route = _FWD_ROUTES[q.dtype]
    fn, err = _bind(route, _FWD_ARGTYPES[q.dtype])
    # 0 is the kernel's built-in tile; the bf16 kernel's block is fixed
    bq, bk = tile or (0, 0)
    tile_args = (bq, bk) if q.dtype == torch.float32 else (bk,)
    rc = on_device(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, t, h, d,
        *(s for x in (q, k, v) for s in kernel_strides(x)),
        int(bool(causal)), *tile_args, stream))
    if rc != 0:
        raise MXNetError("flash_attention_fwd: CUDA launch failed (%s, tile "
                         "%s): %s (%d)" % (route[0], tile or "built-in",
                                           err(rc).decode(), rc))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.source_launches[route[0]] += 1
    return o, lse, tile


def _note_kernel_cost(op, q, causal, n_matmuls, n_tensors, tile=None):
    """Note this call in the cost database (inside a sampled dispatch):
    the JAX kernels' flops and bytes estimates (``n_matmuls`` products of
    ``B*H*T*T*D`` MACs counted as flops, ``n_tensors`` (B, T, H, D)
    tensors moved), keyed by the problem shape with the tile that ran and
    the route's source.  A kernel launch passes ``tile`` (None for its
    built-in one, :func:`kernel_tiles`' first); the plain version, which
    has none, notes the dispatch gate's query tile for both, as before."""
    b, t, h, d = q.shape
    which = "fwd" if op == "flash_attention_fwd" else "bwd"
    if q.device.type == "cuda":
        block_q, block_k = tile or kernel_tiles(which, q.dtype, d)[0]
    else:
        block_q = block_k = min(_BLOCK_Q, t)
    route = (_FWD_ROUTES if which == "fwd" else _BWD_ROUTES).get(q.dtype)
    _costdb.note_kernel(
        op, [tuple(q.shape)], [_dtype_name(q.dtype)],
        flops=float(n_matmuls) * b * h * t * t * d,
        bytes_accessed=float(n_tensors) * b * t * h * d * q.element_size(),
        block_config={"block_q": block_q, "block_k": block_k,
                      "n_k": -(-t // block_k), "causal": bool(causal),
                      "route": route[0] if route else "plain"})


def flash_attention_fwd(q, k, v, causal, blocks=None):
    """``(o, lse)`` of attention over (B, T, H, D) inputs.  A CUDA tensor
    launches the hand-written kernel of its dtype (or raises) at the tile
    :func:`select_tile` picks (``blocks``, an explicit ``(block_q,
    block_k)``, else the tuning cache, else the built-in one); a CPU or
    meta tensor takes :func:`flash_attention_plain`.  Inside a sampled
    cost-database dispatch the call is noted (:func:`_note_kernel_cost`)."""
    kind = q.device.type
    if kind == "cuda":
        o, lse, tile = _launch(q, k, v, causal, blocks)
        if _costdb.SAMPLING:
            _note_kernel_cost("flash_attention_fwd", q, causal, 4, 4, tile)
        return o, lse
    if blocks is not None:       # an explicit tile is checked everywhere
        select_tile("fwd", q, causal, blocks)
    if _costdb.SAMPLING:
        _note_kernel_cost("flash_attention_fwd", q, causal, 4, 4)
    if kind in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal)
    raise MXNetError("flash_attention_fwd: no path for device %s" % q.device)


flash_attention_fwd.launches = 0
flash_attention_fwd.source_launches = {r[0]: 0
                                       for r in _FWD_ROUTES.values()}


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
    delta = flash_attention_delta_plain(o, do).reshape(b, h, t, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def flash_attention_delta_plain(o, do):
    """delta = rowsum(dO * O) in f32 as (B*H, T, 1), lse's layout: the
    backward's row sums, in plain PyTorch (the TPU code's jnp delta)."""
    b, t, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t, 1)


# dO, O, delta, b, t, h, d, the strides of dO and O, dtype, stream
_DELTA_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
_DELTA_ROUTE = ("flash_attention_delta", "mxtt_flash_attention_delta",
                "mxtt_delta_error_string")
_DELTA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch_delta(o, do):
    """The delta kernel on (B, T, H, D) ``o`` and ``do`` that
    :func:`check_kernel_args` has passed."""
    b, t, h, d = o.shape
    delta = torch.empty((b * h, t, 1), dtype=torch.float32, device=o.device)
    fn, err = _bind(_DELTA_ROUTE, _DELTA_ARGTYPES)
    rc = on_device(o.device, lambda stream: fn(
        do.data_ptr(), o.data_ptr(), delta.data_ptr(), b, t, h, d,
        *kernel_strides(do), *kernel_strides(o), _DELTA_DTYPES[o.dtype],
        stream))
    if rc != 0:
        raise MXNetError("flash_attention_delta: CUDA launch failed: %s (%d)"
                         % (err(rc).decode(), rc))
    flash_attention_delta.launches += 1
    return delta


def flash_attention_delta(o, do):
    """delta = rowsum(dO * O) in f32 as (B*H, T, 1), from (B, T, H, D)
    ``o`` and ``do`` of one dtype.  A CUDA tensor launches the one-pass
    kernel (or raises); a CPU or meta tensor takes
    :func:`flash_attention_delta_plain`."""
    kind = o.device.type
    if kind == "cuda":
        check_kernel_args(do, o, o, name="flash_attention_delta")
        return _launch_delta(o, do)
    if kind in ("cpu", "meta"):
        return flash_attention_delta_plain(o, do)
    raise MXNetError("flash_attention_delta: no path for device %s"
                     % o.device)


flash_attention_delta.launches = 0


# q, k, v, dO, lse, delta, dq, dk, dv, b, t, h, d, the strides of q, k, v,
# dO, causal, the streamed tile's rows, stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: as :data:`_FWD_ROUTES`, for the backward
_BWD_ROUTES = {
    torch.float32: ("flash_attention_bwd", "mxtt_flash_attention_bwd",
                    "mxtt_bwd_error_string"),
    torch.bfloat16: ("flash_attention_bwd_sm90",
                     "mxtt_flash_attention_bwd_sm90",
                     "mxtt_bwd_sm90_error_string"),
}


def _launch_bwd(q, k, v, o, lse, do, causal, blocks=None):
    name = "flash_attention_bwd"
    # autograd may hand over dO with any strides: the kernel reads it
    # through its (batch, seq, heads) strides, and only a dO that TMA
    # cannot load (last dim not contiguous, or not 16-byte aligned) is
    # copied first
    if do.dim() == 4 and do.shape == q.shape and do.dtype == q.dtype and (
            do.stride(-1) != 1 or not _tma_aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    check_kernel_args(q, k, v, do, o, name=name)
    b, t, h, d = q.shape
    if lse.shape != (b * h, t, 1) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous() \
            or lse.data_ptr() % 16:
        raise MXNetError("%s: lse must be a contiguous, 16-byte aligned "
                         "float32 (%d, %d, 1) tensor on %s, got %s %s on %s"
                         % (name, b * h, t, q.device, tuple(lse.shape),
                            lse.dtype, lse.device))
    tile = select_tile("bwd", q, causal, blocks)
    # delta = rowsum(dO * O) in f32, outside the attention kernels as in
    # the TPU code, in lse's (B*H, T, 1) layout: one pass of its own kernel
    # (dO and O are checked above)
    delta = _launch_delta(o, do)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    route = _BWD_ROUTES[q.dtype]
    fn, err = _bind(route, _BWD_ARGTYPES)
    rc = on_device(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, t, h, d,
        *(s for x in (q, k, v, do) for s in kernel_strides(x)),
        int(bool(causal)), tile[1] if tile else 0, stream))
    if rc != 0:
        raise MXNetError("%s: CUDA launch failed (%s, tile %s): %s (%d)"
                         % (name, route[0], tile or "built-in",
                            err(rc).decode(), rc))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.source_launches[route[0]] += 1
    return dq, dk, dv, tile


def flash_attention_bwd(q, k, v, o, lse, do, causal, blocks=None):
    """``(dq, dk, dv)`` of attention over (B, T, H, D) inputs, from the
    forward's ``o`` and ``lse`` and the output gradient ``do``.  A CUDA
    tensor launches the hand-written kernel of its dtype (or raises) at the
    tile :func:`select_tile` picks (``blocks`` overrides it); a CPU or meta
    tensor takes :func:`flash_attention_bwd_plain`.  Noted in a sampled
    cost-database dispatch, as the forward."""
    kind = q.device.type
    if kind == "cuda":
        dq, dk, dv, tile = _launch_bwd(q, k, v, o, lse, do, causal, blocks)
        if _costdb.SAMPLING:
            _note_kernel_cost("flash_attention_bwd", q, causal, 10, 8, tile)
        return dq, dk, dv
    if blocks is not None:
        select_tile("bwd", q, causal, blocks)
    if _costdb.SAMPLING:
        _note_kernel_cost("flash_attention_bwd", q, causal, 10, 8)
    if kind in ("cpu", "meta"):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    raise MXNetError("flash_attention_bwd: no path for device %s" % q.device)


flash_attention_bwd.launches = 0
flash_attention_bwd.source_launches = {r[0]: 0
                                       for r in _BWD_ROUTES.values()}


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
    autograd, backward) when the kernels take the inputs
    (:func:`kernel_takes`); other shapes, and inputs the kernels do not take
    (a head dim outside :data:`KERNEL_HEAD_DIMS`, float16 or float64, B*H
    over 65535, bases or strides TMA cannot load), take
    :func:`attention_plain`, as the JAX op takes ``_attention_jnp``."""
    causal = bool(attrs["causal"])
    t = q.shape[1]
    block_q = min(_BLOCK_Q, t)
    if t > 0 and t % block_q == 0 and k.shape[1] == t \
            and kernel_takes(q, k, v) is None:
        return FlashAttention.apply(q, k, v, causal)
    return attention_plain(q, k, v, causal)


@register("_contrib_RingAttention", arg_names=("q", "k", "v"),
          params={"causal": False})
def ring_attention_op(attrs, ctx, q, k, v):
    """Sequence-parallel attention over (batch, seq, heads, head_dim).  The
    port has no sequence-parallel context (the JAX package's
    ``parallel.sequence`` and ``ShardedTrainer(sequence_parallel=True)``
    are not yet ported), and without one the JAX op *is*
    ``_contrib_FlashAttention``: the same dispatch, so the same Symbol
    trains with either op, through the flash kernels on the card."""
    return flash_attention_op(attrs, ctx, q, k, v)
