"""Fused conv/BN/activation regions and K5, the GEMM with a statistics
epilogue.

The counterpart of ``mxnet_tpu/ops/fused.py``, block-fusion part.  The
planner of :mod:`mxnet_tpu_torch.analysis.fusion` lowers each matched
chain (conv->BN->ReLU, conv->BN, BN->ReLU, FC->activation) to one of the
regions below.  Each region is a ``torch.autograd.Function`` carrying the
JAX package's hand-written backward (a ``custom_vjp`` there), so a block is
one region in each direction.

* :func:`matmul_stats` is the K5 wrapper: ``(M, K) @ (K, N)`` with the f32
  column sums of ``(y - c)`` and ``(y - c)^2`` from the f32 accumulator.  A
  CUDA tensor launches ``csrc/matmul_stats.cu`` (or raises); a CPU or meta
  tensor takes :func:`matmul_stats_plain`.  ``matmul_stats.launches``
  counts launches (``matmul_stats.f32_launches`` the f32 ones),
  ``matmul_stats.padded`` those whose shape TMA does not
  take (K or N not a multiple of 16 bytes: 8 bf16 or 4 f32 values; or an
  unaligned base), which go through :func:`pad_operands` first.  bf16 runs
  on wgmma, f32 on the tensor cores as split TF32 (three TF32 products a
  product).
* :func:`matmul_stats_prologue` is the K8 wrapper, the same over
  ``relu(x * scale + shift)`` (the previous BatchNorm folded into the
  GEMM; the JAX package has it in ``tools/pallas_matmul_stats_experiment.py``
  only), with :func:`matmul_stats_prologue_plain` and its own count.
* :class:`FusedConvBN` is the 1x1 conv->BN(->ReLU) region over K5
  (``_fused_conv_bn``), taken by the blocks the plan marks ``pallas``.
* :class:`ConvBNAct` and :class:`FCAct` are the general regions
  (``_fused_conv_bn_act_xla``, ``_fused_fc_act_xla``); the BN->ReLU
  region (``_fused_bn_act_xla``) is ``ops.nn.BNCore`` with ``act="relu"``.

The BN math of every region is ``ops.nn.bn_forward``/``bn_backward``:
statistics shifted by c = the moving mean, and a ReLU's mask in a backward
recomputed from the pre-activation ``y*scale + shift > 0``, as in the JAX
package, not saved.  The
TPU-era rewrites of the JAX module (the conv1x1+BN pass, stem
space-to-depth, the phase-decomposed backward, the dX elision) are not
ported.
"""
from __future__ import annotations

import ctypes

import torch

from .. import config as _config
from .. import cuda_build
from ..autotune import cache as _tune_cache
from ..base import MXNetError
from ..telemetry import costdb as _costdb
from .nn import BNCore, bn_apply, bn_backward, bn_forward, bn_moments, \
    conv2d, conv_statics

__all__ = ["block_fusion", "block_fusion_enabled", "matmul_stats",
           "matmul_stats_plain", "matmul_stats_prologue", "pad_operands",
           "matmul_stats_prologue_plain", "FusedConvBN", "ConvBNAct", "FCAct",
           "fused_block_conv_bn_act", "fused_block_bn_act",
           "fused_block_fc_act", "conv_eligible"]

_BLOCK_FUSION = {"v": None}


class block_fusion:
    """Context manager switching the block-granularity fusion pass
    (:mod:`mxnet_tpu_torch.analysis.fusion`) on or off for the graphs run
    inside it.  A tri-state flag, as the JAX package's: inside no context
    (or a context of ``None``) ``MXNET_FUSE_BLOCKS=1`` turns it on, through
    :mod:`mxnet_tpu_torch.config`; ``True``/``False`` force it."""

    def __init__(self, enable):
        self.enable = None if enable is None else bool(enable)

    def __enter__(self):
        self._prev = _BLOCK_FUSION["v"]
        _BLOCK_FUSION["v"] = self.enable
        return self

    def __exit__(self, *exc):
        _BLOCK_FUSION["v"] = self._prev
        return False


def block_fusion_enabled():
    if _BLOCK_FUSION["v"] is not None:
        return _BLOCK_FUSION["v"]
    return _config.get("MXNET_FUSE_BLOCKS") == "1"


# ------------------------------------------------------------- K5
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_stats_plain(x2d, w2d, c):
    """``(y, s1, s2)`` in plain PyTorch, the JAX fallback's math: the f32
    product of the given inputs, the column sums of ``(y - c)`` and of its
    square, then ``y`` cast to ``x2d``'s dtype."""
    y = x2d.float() @ w2d.float()
    ys = y - c.float().reshape(1, -1)
    return y.to(x2d.dtype), ys.sum(0), (ys * ys).sum(0)


def matmul_stats_prologue_plain(x2d, w2d, scale, shift):
    """K8's ``(y, s1, s2)`` in plain PyTorch: ``xh = relu(x * scale +
    shift)`` in f32, rounded to ``x2d``'s dtype, then
    :func:`matmul_stats_plain` of ``xh`` with ``c = 0``."""
    xh = torch.relu(x2d.float() * scale.float().reshape(1, -1)
                    + shift.float().reshape(1, -1)).to(x2d.dtype)
    return matmul_stats_plain(xh, w2d, torch.zeros(
        w2d.shape[1], dtype=torch.float32, device=x2d.device))


def pad_operands(x2d, w2d, c=None, scale=None, shift=None):
    """The padded operands of a launch that TMA does not take as they
    are: ``x2d`` (M, K) and ``w2d`` (K, N) into fresh zero buffers of depth
    Kp = K rounded up to 8 and width Np = N rounded up to 8, ``w2d`` as the
    (Kp, Np) transpose of a contiguous (Np, Kp) buffer (the rows the kernel
    reads); ``c`` to Np and ``scale``, ``shift`` to Kp with zeros.  Zero
    depth columns add nothing to y, and zero columns of w give y = 0 and
    statistics 0 - 0 there, so the first N columns of y, s1 and s2 are the
    unpadded ones.  Returns ``(x, w, c, scale, shift)``; ``None`` stays
    ``None``."""
    m, k = x2d.shape
    n = w2d.shape[1]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    x = x2d.new_zeros((m, kp))
    x[:, :k] = x2d
    w_nk = w2d.new_zeros((np_, kp))
    w_nk[:n, :k] = w2d.t()

    def vec(v, size):
        if v is None:
            return None
        out = v.new_zeros(size)
        out[:v.numel()] = v.reshape(-1)
        return out

    return x, w_nk.t(), vec(c, np_), vec(scale, kp), vec(shift, kp)


def _kernel(entry):
    lib = cuda_build.library("matmul_stats")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        # x, w, [scale, shift,] c, y, part, s; M, N, K, part_rows, tile,
        # rows, dtype; stream
        pointers = 6 if entry == "mxtt_matmul_stats" else 8
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_matmul_stats_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_matmul_stats_error_string.restype = ctypes.c_char_p
    return lib, fn


_SM_COUNT = {}


def _partial_rows(dev):
    """Rows of the kernel's partial sums: one a block of an n-tile, at most
    the card's SM count, in both dtypes (both kernels are persistent, one
    block an SM)."""
    rows = _SM_COUNT.get(dev.index)
    if rows is None:
        rows = _SM_COUNT[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return rows


#: elements in the 16 bytes TMA wants as a row stride, by dtype
_TMA_ALIGN = {torch.float32: 4, torch.bfloat16: 8}

#: rows of one of K5's m-tiles (BM in csrc/matmul_stats.cu, both dtypes)
K5_ROWS = 128
#: the tile widths (columns of w an n-tile) K5 is built for, by dtype
K5_TILES = {torch.bfloat16: (64, 128, 256), torch.float32: (64, 128)}
#: K5's per-item cost in columns, csrc/matmul_stats.cu's ITEM_COST
_ITEM_COST = 64
#: the SM count the heuristic assumes where no card is at hand (an H100)
H100_SMS = 132


def widest_tile(n, dtype=torch.bfloat16):
    """The widest tile N needs (``widest_tile`` in the source; f32 stops at
    128)."""
    if n <= 64:
        return 64
    return 128 if n <= 128 or dtype == torch.float32 else 256


def grid_rows(m, n, bn, sms):
    """The built-in persistent grid's rows (``bf16_rows``, both dtypes):
    the blocks of one n-tile, one an SM at most, no more than the
    m-tiles."""
    n_tiles = -(-n // bn)
    m_tiles = -(-m // K5_ROWS)
    return max(1, min(sms // n_tiles, m_tiles))


def heuristic_config(m, n, dtype, sms=H100_SMS, prologue=False):
    """``{"bn", "rows"}``, the tile and grid K5 (or K8, ``prologue``) takes
    when it is passed 0 for both: ``bf16_tile``'s width of least cost (K8
    and f32 the widest), and :func:`grid_rows`."""
    widest = widest_tile(n, dtype)
    best = widest
    if dtype == torch.bfloat16 and not prologue:
        m_tiles = -(-m // K5_ROWS)
        best_cost = None
        bn = widest
        while bn >= 64:
            rows = grid_rows(m, n, bn, sms)
            cost = -(-m_tiles // rows) * (bn + _ITEM_COST)
            if best_cost is None or cost < best_cost:
                best, best_cost = bn, cost
            bn //= 2
    return {"bn": best, "rows": grid_rows(m, n, best, sms)}


def config_takes(cfg, m, n, dtype, sms=H100_SMS):
    """Whether K5 takes ``cfg`` (``{"bn", "rows"}``, either may be absent or
    0 for the built-in choice) at this (M, N) and dtype: a width it is
    built for, no wider than N needs, and rows from 1 to the SM count and
    the m-tiles."""
    try:
        bn = int(cfg.get("bn", 0) or 0)
        rows = int(cfg.get("rows", 0) or 0)
    except (AttributeError, TypeError, ValueError):
        return False
    if bn and (bn not in K5_TILES.get(dtype, ()) or
               bn > widest_tile(n, dtype)):
        return False
    return rows == 0 or 1 <= rows <= min(sms, -(-m // K5_ROWS))


# select_config's answers: (x shape, w shape, dtype, device) -> (the
# cache's resolution token, (bn, rows)), as flash_attention.select_tile's
_SELECTED = {}


def select_config(x2d, w2d, config=None, prologue=False):
    """``(bn, rows)`` for the C entry (0 for the built-in choice): an
    explicit ``config`` (``{"bn", "rows"}``; the tuners measure through it)
    must be one K5 takes or raises; else K5 (not K8, which JAX does not
    tune) consults the tuning cache under the JAX key (``matmul_stats``,
    ``[(m, k), (k, n)]``, both dtypes), and a cached config K5 does not take
    at this shape degrades to the built-in choice."""
    if config is None and prologue:
        return 0, 0
    if config is None:
        token = _tune_cache.resolution_token()
        if token[0] == "off":
            return 0, 0
        key = (x2d.shape, w2d.shape, x2d.dtype, x2d.device)
        got = _SELECTED.get(key)
        if got is not None and got[0] == token and token[0] == "cache":
            return got[1]
    m, k = x2d.shape
    n = w2d.shape[1]
    # the width the kernel sees: pad_operands rounds an N TMA cannot take
    # up to a multiple of 8
    np_ = -(-n // 8) * 8 if n % _TMA_ALIGN.get(x2d.dtype, 1) else n
    sms = _partial_rows(x2d.device) if x2d.device.type == "cuda" \
        else H100_SMS
    if config is not None:
        if not config_takes(config, m, np_, x2d.dtype, sms):
            raise MXNetError("matmul_stats: config %r is not one K5 takes "
                             "at (%d, %d, %d) %s" % (config, m, k, n,
                                                     x2d.dtype))
        return int(config.get("bn", 0) or 0), int(config.get("rows", 0) or 0)
    cfg = _tune_cache.kernel_config(
        "matmul_stats", [(m, k), (k, n)],
        [str(x2d.dtype).replace("torch.", ""),
         str(w2d.dtype).replace("torch.", "")],
        backend=_costdb.backend_name(x2d.device))
    out = (0, 0)
    if cfg and config_takes(cfg, m, np_, x2d.dtype, sms):
        out = (int(cfg.get("bn", 0) or 0), int(cfg.get("rows", 0) or 0))
    _SELECTED[key] = (_tune_cache.resolution_token(), out)
    return out


def _launch(x2d, w2d, c, scale=None, shift=None, config=None):
    """K5, or K8 when ``scale`` and ``shift`` are given (``c`` may then be
    None, read as 0), at the tile and grid :func:`select_config` picks.
    Returns ``(y, s1, s2, padded, cfg)``: ``padded`` when a shape TMA does
    not take (K or N not a multiple of 16 bytes, an unaligned base) went
    through :func:`pad_operands`; ``cfg`` the ``{"bn", "rows"}`` that
    ran inside a sampled cost-database dispatch, else None."""
    name = "matmul_stats" if scale is None else "matmul_stats_prologue"
    if x2d.dim() != 2 or w2d.dim() != 2 or x2d.shape[1] != w2d.shape[0]:
        raise MXNetError("%s: need x (M, K) and w (K, N), got %s and %s"
                         % (name, tuple(x2d.shape), tuple(w2d.shape)))
    m, k = x2d.shape
    n = w2d.shape[1]
    if x2d.dtype not in _KERNEL_DTYPES or w2d.dtype != x2d.dtype:
        raise MXNetError("%s: the kernel takes float32 or bfloat16 x and w "
                         "of one dtype, got %s and %s"
                         % (name, x2d.dtype, w2d.dtype))
    vectors = [w2d]
    if c is not None:
        if c.shape != (n,) or c.dtype != torch.float32:
            raise MXNetError("%s: c must be float32 of shape (%d,), got %s "
                             "%s" % (name, n, c.dtype, tuple(c.shape)))
        vectors.append(c)
    if scale is not None:
        for what, v in (("scale", scale), ("shift", shift)):
            if v.numel() != k or v.dtype != torch.float32:
                raise MXNetError("%s: %s must be float32 with %d values, "
                                 "got %s %s" % (name, what, k, v.dtype,
                                                tuple(v.shape)))
        vectors += [scale, shift]
    if any(v.device != x2d.device for v in vectors):
        raise MXNetError("%s: inputs on different devices" % name)
    if min(m, n, k) < 1:
        raise MXNetError("%s: empty product (%d, %d) @ (%d, %d)"
                         % (name, m, k, k, n))
    bn, grid = select_config(x2d, w2d, config, prologue=scale is not None)
    x2d = x2d.contiguous()
    # the kernel reads w as (N, K) rows: the transpose of a (K, N) view of
    # an OIHW weight is that layout already, and costs no copy
    w_nk = w2d.t().contiguous()
    q = _TMA_ALIGN[x2d.dtype]
    padded = bool(k % q or n % q or x2d.data_ptr() % 16
                  or w_nk.data_ptr() % 16)
    if padded:
        x2d, w2d, c, scale, shift = pad_operands(x2d, w_nk.t(), c, scale,
                                                 shift)
        w_nk = w2d.t()
    kp = x2d.shape[1]
    np_ = w_nk.shape[0]
    # every tensor a pointer is taken from stays referenced until the
    # launch; K8 reads scale and shift 16 bytes at a time
    vectors = [v if v.dim() == 1 and v.is_contiguous() and
               not v.data_ptr() % 16 else v.reshape(-1).clone()
               for v in (scale, shift, c) if v is not None]
    pointers = [x2d.data_ptr(), w_nk.data_ptr()] \
        + [v.data_ptr() for v in vectors] + ([None] if c is None else [])
    dev = x2d.device
    rows = _partial_rows(dev)
    y = torch.empty((m, np_), dtype=x2d.dtype, device=dev)
    # rows 0 to 2 rows - 1: the partial sums of s1, then of s2; the last
    # two rows: s1 and s2
    buf = torch.empty((2 * rows + 2, np_), dtype=torch.float32, device=dev)
    lib, fn = _kernel("mxtt_" + name)
    base = buf.data_ptr()
    rc = cuda_build.on_device(dev, lambda stream: fn(
        *pointers, y.data_ptr(), base, base + 8 * rows * np_, m, np_, kp,
        rows, bn, grid, _KERNEL_DTYPES[x2d.dtype], stream))
    if rc != 0:
        raise MXNetError("%s: CUDA launch failed (tile %s, rows %s): %s (%d)"
                         % (name, bn or "built-in", grid or "built-in",
                            lib.mxtt_matmul_stats_error_string(rc).decode(),
                            rc))
    # the config that ran, for the cost note (only a sampled dispatch
    # spends the host's time on the built-in choice's arithmetic)
    ran = None
    if _costdb.SAMPLING:
        ran = heuristic_config(m, np_, x2d.dtype, rows,
                               prologue=scale is not None)
        ran = {"bn": bn or ran["bn"],
               "rows": grid or grid_rows(m, np_, bn or ran["bn"], rows)}
    if padded:
        return y[:, :n].contiguous(), buf[-2, :n], buf[-1, :n], True, ran
    return y, buf[-2], buf[-1], False, ran


def _note_matmul_stats(x2d, w2d, op="matmul_stats", cfg=None):
    """The JAX ``matmul_stats`` cost note: 2MNK flops, x and w read and y
    written; the block config is the m-tile's rows (``bm``, 128 in both
    dtypes, and ``grid_m`` m-tiles) with the width and grid rows that ran
    (``cfg``; on the CPU, the ones an H100 would take)."""
    m, k = x2d.shape
    n = w2d.shape[1]
    if cfg is None:
        cfg = heuristic_config(m, n, x2d.dtype,
                               prologue=op != "matmul_stats")
    _costdb.note_kernel(
        op, [(m, k), (k, n)],
        [str(x2d.dtype).replace("torch.", ""),
         str(w2d.dtype).replace("torch.", "")],
        flops=2.0 * m * n * k,
        bytes_accessed=float(m * k * x2d.element_size()
                             + k * n * w2d.element_size()
                             + m * n * x2d.element_size()),
        block_config={"bm": K5_ROWS, "grid_m": -(-m // K5_ROWS),
                      "bn": int(cfg["bn"]), "rows": int(cfg["rows"])})


def matmul_stats(x2d, w2d, c, config=None):
    """``(M, K) @ (K, N) -> y`` (M, N) in x's dtype, plus the f32 (N,)
    sums of ``(y - c)`` and ``(y - c)^2`` taken from the f32 accumulator
    before ``y`` is rounded.  A CUDA tensor launches the hand-written K5
    kernel (or raises) at the tile and grid :func:`select_config` picks
    (``config``, an explicit ``{"bn", "rows"}``, else the tuning cache, else
    the built-in choice); a CPU or meta tensor takes
    :func:`matmul_stats_plain`.  ``matmul_stats.launches`` counts the
    launches, ``matmul_stats.f32_launches`` those of them on the f32 (split
    TF32) kernel, ``matmul_stats.padded`` those that went through
    :func:`pad_operands`.  Inside a sampled cost-database dispatch the
    call is noted with the JAX kernel's flops and bytes estimates."""
    kind = x2d.device.type
    if kind == "cuda":
        y, s1, s2, padded, ran = _launch(x2d, w2d, c, config=config)
        matmul_stats.launches += 1
        matmul_stats.f32_launches += x2d.dtype == torch.float32
        matmul_stats.padded += padded
        if _costdb.SAMPLING:
            _note_matmul_stats(x2d, w2d, cfg=ran)
        return y, s1, s2
    if config is not None:       # an explicit config is checked everywhere
        select_config(x2d, w2d, config)
    if _costdb.SAMPLING:
        _note_matmul_stats(x2d, w2d)
    if kind in ("cpu", "meta"):
        return matmul_stats_plain(x2d, w2d, c)
    raise MXNetError("matmul_stats: no path for device %s" % x2d.device)


matmul_stats.launches = 0
matmul_stats.f32_launches = 0
matmul_stats.padded = 0


def matmul_stats_prologue(x2d, w2d, scale, shift, config=None):
    """K8: :func:`matmul_stats` with ``c = 0`` of ``relu(x2d * scale +
    shift)``, computed in f32 and rounded to ``x2d``'s dtype before the
    product; ``scale`` and ``shift`` are f32 with K values.  A CUDA tensor
    launches the prologue variant of ``csrc/matmul_stats.cu`` (or raises),
    at its built-in tile (the widest N needs) unless ``config`` asks for
    another (the tuning cache is not consulted: JAX does not tune K8); a
    CPU or meta tensor takes :func:`matmul_stats_prologue_plain`.  Counts
    and notes as :func:`matmul_stats` does."""
    kind = x2d.device.type
    if kind == "cuda":
        y, s1, s2, padded, ran = _launch(x2d, w2d, None, scale, shift,
                                         config=config)
        matmul_stats_prologue.launches += 1
        matmul_stats_prologue.padded += padded
        if _costdb.SAMPLING:
            _note_matmul_stats(x2d, w2d, "matmul_stats_prologue", ran)
        return y, s1, s2
    if config is not None:
        select_config(x2d, w2d, config, prologue=True)
    if _costdb.SAMPLING:
        _note_matmul_stats(x2d, w2d, "matmul_stats_prologue")
    if kind in ("cpu", "meta"):
        return matmul_stats_prologue_plain(x2d, w2d, scale, shift)
    raise MXNetError("matmul_stats_prologue: no path for device %s"
                     % x2d.device)


matmul_stats_prologue.launches = 0
matmul_stats_prologue.padded = 0


# ------------------------------------------------ the K5 region
class FusedConvBN(torch.autograd.Function):
    """1x1 stride-1 conv -> training BN (-> ReLU) over NHWC ``x`` (N, H,
    W, K) and the OIHW weight ``w`` (Nout, K, 1, 1); the counterpart of
    ``_fused_conv_bn``.  The forward is one K5 launch (the product and the
    statistics from its f32 accumulator) and one epilogue pass; the
    backward is the BN math by hand and dX, dW as plain products of the
    rounded ``y``'s cotangent.  Returns ``(out, new_mm, new_mv)``."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, mm, mv, eps, momentum, relu):
        nb, h, wd, k = x.shape
        nout = w.shape[0]
        m = nb * h * wd
        x2d = x.reshape(m, k)
        w2d = w.reshape(nout, k).to(x.dtype).t()
        c = mm.float()
        y2d, s1, s2 = matmul_stats(x2d, w2d, c)
        mean, var, new_mm, new_mv = bn_moments(s1, s2, m, c, mm, mv,
                                               momentum)
        act = "relu" if relu else None
        out2d, inv = bn_apply(y2d.float(), gamma, beta, mean, var, eps,
                              (1, nout), act)
        ctx.save_for_backward(x, w, y2d, gamma, beta, mean, inv, c)
        ctx.cfg = (momentum, act)
        return out2d.to(x.dtype).reshape(nb, h, wd, nout), new_mm, new_mv

    @staticmethod
    def backward(ctx, dout, dmm_o, dmv_o):
        x, w, y2d, gamma, beta, mean, inv, c = ctx.saved_tensors
        momentum, act = ctx.cfg
        nb, h, wd, k = x.shape
        nout = w.shape[0]
        m = nb * h * wd
        dY, dgamma, dbeta, dmm, dmv = bn_backward(
            dout.reshape(m, nout), y2d.float(), gamma, beta, mean, inv, c,
            [0], (1, nout), momentum, True, act, 0.0, 0.0, dmm_o, dmv_o)
        dYc = dY.to(x.dtype)
        w2d = w.reshape(nout, k).to(x.dtype)
        dx = (dYc @ w2d).reshape(x.shape)              # (M, Nout) (Nout, K)
        dw = (dYc.t() @ x.reshape(m, k)).reshape(w.shape).to(w.dtype)
        return (dx, dw, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), dmm,
                dmv, None, None, None)


# ------------------------------------------------ the general regions
def _conv_backward(dy, x, w, statics, nhwc):
    """``(dx, dw)`` of :func:`nn.conv2d` without bias for the output
    cotangent ``dy`` in ``x``'s layout, through the library's convolution
    backward (no second forward)."""
    _kernel_shape, stride, dilate, pad, groups = statics
    if nhwc:
        x = x.permute(0, 3, 1, 2)
        dy = dy.permute(0, 3, 1, 2)
        w = w.contiguous(memory_format=torch.channels_last)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, x, w, None, list(stride), list(pad), list(dilate), False,
        [0, 0], groups, [True, True, False])
    if nhwc:
        dx = dx.permute(0, 2, 3, 1)
    return dx, dw


class ConvBNAct(torch.autograd.Function):
    """Any 2-d conv -> BN (-> ReLU), NCHW or NHWC, with or without a conv
    bias: the counterpart of ``_fused_conv_bn_act_xla``.  The forward saves
    the conv output ``y`` in the compute dtype; the backward is the BN math
    by hand and the conv's dX/dW from the library's convolution backward
    (the JAX region takes them from ``jax.vjp`` of the conv).  Returns
    ``(out, new_mm, new_mv)``."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, mm, mv, statics, nhwc, eps,
                momentum, train_stats, act):
        _kernel_shape, stride, dilate, pad, groups = statics
        y = conv2d(x, w, None, stride, pad, dilate, groups, nhwc) \
            .to(x.dtype)
        ch = 3 if nhwc else 1
        if b is not None:
            y = y + b.reshape((-1,) if nhwc else (1, -1, 1, 1)).to(x.dtype)
        bshape = [1] * 4
        bshape[ch] = y.shape[ch]
        red = [i for i in range(4) if i != ch]
        out, mean, _var, inv, new_mm, new_mv = bn_forward(
            y.float(), gamma, beta, mm, mv, red, bshape, eps, momentum,
            train_stats, act)
        ctx.save_for_backward(x, w, y, gamma, beta, mean, inv, mm)
        ctx.cfg = (statics, nhwc, momentum, train_stats, act, bshape, red,
                   b is not None, None if b is None else b.dtype)
        return out.to(x.dtype), new_mm, new_mv

    @staticmethod
    def backward(ctx, dout, dmm_o, dmv_o):
        x, w, y, gamma, beta, mean, inv, mm = ctx.saved_tensors
        statics, nhwc, momentum, train_stats, act, bshape, red, has_bias, \
            b_dtype = ctx.cfg
        dY, dgamma, dbeta, dmm, dmv = bn_backward(
            dout, y.float(), gamma, beta, mean, inv, mm, red, bshape,
            momentum, train_stats, act, 0.0, 0.0, dmm_o, dmv_o)
        dx, dw = _conv_backward(dY.to(x.dtype), x, w, statics, nhwc)
        db = dY.sum(red).to(b_dtype) if has_bias else None
        return (dx, dw, db, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                dmm, dmv) + (None,) * 6


_FC_ACTS = {
    "relu": (torch.relu,
             lambda out, g: torch.where(out > 0, g, torch.zeros_like(g))),
    "sigmoid": (torch.sigmoid, lambda out, g: g * out * (1 - out)),
    "tanh": (torch.tanh, lambda out, g: g * (1 - out.square())),
}


class FCAct(torch.autograd.Function):
    """FullyConnected -> relu/sigmoid/tanh with the activation's derivative
    in the hand-written backward, taken from the saved output: the
    counterpart of ``_fused_fc_act_xla``."""

    @staticmethod
    def forward(ctx, x, w, b, act, flatten):
        if act not in _FC_ACTS:
            raise MXNetError("unfusable activation %r" % (act,))
        x2 = x.reshape(x.shape[0], -1) if flatten and x.dim() > 2 else x
        y = x2 @ w.t()
        if b is not None:
            y = y + b
        out = _FC_ACTS[act][0](y.to(x.dtype))
        ctx.save_for_backward(x, w, out)
        ctx.cfg = (act, flatten, None if b is None else b.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        act, flatten, b_dtype = ctx.cfg
        x2 = x.reshape(x.shape[0], -1) if flatten and x.dim() > 2 else x
        gy = _FC_ACTS[act][1](out, g).to(x.dtype)
        # flatten=False keeps leading batch dims: contract all of them
        lead = list(range(gy.dim() - 1))
        dx = (gy @ w).reshape(x.shape).to(x.dtype)
        dw = torch.tensordot(gy, x2, dims=(lead, lead)).to(w.dtype)
        db = gy.float().sum(lead).to(b_dtype) if b_dtype is not None \
            else None
        return dx, dw, db, None, None


# ------------------------------------------------ block entry points
def fused_block_conv_bn_act(conv_attrs, bn_attrs, layout, is_train, act,
                            pallas, x, w, b, gamma, beta, mm, mv):
    """Evaluate a planned conv->BN(->act) block; returns ``(out, new_mm,
    new_mv)``.  ``pallas`` (the plan's name for the K5 route) sends a 1x1
    training block over NHWC through :class:`FusedConvBN`; every other
    block runs :class:`ConvBNAct`."""
    eps = float(bn_attrs["eps"])
    momentum = float(bn_attrs["momentum"])
    train_stats = bool(is_train and not bn_attrs.get("use_global_stats"))
    if bn_attrs.get("fix_gamma"):
        gamma = torch.ones_like(gamma)
    mm32, mv32 = mm.float(), mv.float()
    if pallas and train_stats and b is None and layout == "NHWC":
        out, new_mm, new_mv = FusedConvBN.apply(
            x, w, gamma, beta, mm32, mv32, eps, momentum, act == "relu")
    else:
        out, new_mm, new_mv = ConvBNAct.apply(
            x, w, b, gamma, beta, mm32, mv32, conv_statics(conv_attrs),
            layout == "NHWC", eps, momentum, train_stats, act)
    return out, new_mm.to(mm.dtype), new_mv.to(mv.dtype)


def fused_block_bn_act(bn_attrs, ch, is_train, act, x, gamma, beta, mm, mv):
    """Evaluate a planned BN(->act) block; returns ``(out, new_mm,
    new_mv)``."""
    train_stats = bool(is_train and not bn_attrs.get("use_global_stats"))
    if bn_attrs.get("fix_gamma"):
        gamma = torch.ones_like(gamma)
    out, _mean, _var, new_mm, new_mv = BNCore.apply(
        x, gamma, beta, mm.float(), mv.float(), float(bn_attrs["eps"]),
        float(bn_attrs["momentum"]), train_stats, ch, act)
    return out, new_mm.to(mm.dtype), new_mv.to(mv.dtype)


def fused_block_fc_act(fc_attrs, act, x, w, b):
    """Evaluate a planned FullyConnected(->act) block."""
    return FCAct.apply(x, w, b, act, bool(fc_attrs.get("flatten", True)))


def conv_eligible(node):
    """True for a Convolution node that K5 takes: 1x1, stride 1, no
    padding or dilation, one group, no bias."""
    a = node.attrs
    kernel = tuple(a.get("kernel") or ())
    stride = tuple(a.get("stride") or ()) or (1,) * len(kernel)
    pad = tuple(a.get("pad") or ()) or (0,) * len(kernel)
    dilate = tuple(a.get("dilate") or ()) or (1,) * len(kernel)
    return (kernel == (1, 1) and stride == (1, 1) and pad == (0, 0)
            and dilate == (1, 1) and int(a.get("num_group", 1)) == 1
            and bool(a.get("no_bias")))
