"""Experiment: one ResNet stage-1 bottleneck block as one CUDA kernel (K9)
against three library convolutions with eager BatchNorm-ReLU between them.

    python -m mxnet_tpu_torch.tools.block_experiment [--batch 128]
        [--dtype float32] [--cin 256 --cmid 64 --cout 256]
    python -m mxnet_tpu_torch.tools.block_experiment \\
        --baseline OLD/mxnet_tpu_torch/csrc --bands --variants \\
        product_guard,no_prefetch,store_in_flight --profile

The counterpart of ``tools/pallas_block_experiment.py``: BN-ReLU, 1x1
cin -> cmid, BN-ReLU, 3x3 cmid -> cmid, BN-ReLU, 1x1 cmid -> cout over an
NHWC (N, 56, 56, cin) activation, each BatchNorm folded to a per-channel
scale and shift (the inference form), y in x's dtype.  :func:`block_kernel`
launches a CUDA kernel for a CUDA tensor (or raises) and takes
:func:`block_plain` for a CPU tensor.  Two routes (:func:`route`):

* ``sm90``, ``csrc/bottleneck_block.cu`` (wgmma, TMA, resident weights):
  bf16 with cin and cout multiples of 16 in [16, 256] and cmid 16, 32, 48
  or 64 (:func:`kernel_takes`), both stage-1 channel sets of a deep ResNet,
  (64, 64, 256) and (256, 64, 256) (``STAGE1_SETS``);
* ``general``, ``csrc/bottleneck_block_general.cu`` (mma.sync, weights
  streamed in chunks, loads by threads): everything else the JAX tool
  takes up to cin and cout 2048 and cmid 256 (:func:`general_takes`): f32
  as split TF32, and the other bf16 channel sets.

``block_kernel.launches`` counts the sm90 kernel's launches,
``block_kernel.general_launches`` the general kernel's.
:func:`library_block` is the yardstick, the JAX tool's ``xla_block``:
cuDNN's convolutions on the channels-last view, the BatchNorm-ReLU passes
in eager f32, each input rounded to x's dtype before its convolution.

``rows`` is the TPU kernel's band height (any divisor of 56, default 8 as
there); it does not change y, and each CUDA kernel picks its own band
(:func:`plan`).  The tool prints one JSON line: its error against
``library_block`` and the times in ms a call from
:func:`mxnet_tpu_torch.autotune.measure` (``--repeats`` samples of 10
chained calls, the wrapper's host time included where it exceeds the
card's), then the card's time alone (``device_ms``, the replay of a CUDA
graph of 20 launches) and the wrapper's host microseconds a call, the
kernel's plan, the card's name and power limit; with ``--baseline DIR``
the device time of an older checkout's sm90 kernel (its ``csrc``
directory, launched through its own C entry with rows 4, at (64, 64,
256) in bf16) in the same call, and whether its y has the committed
kernel's bits; with ``--variants`` the device time and error of text
edits of the committed sm90 source, each undoing one design choice
(``VARIANTS``); with ``--profile`` a consumer's clock cycles by phase
(``PROFILE_PHASES``, from an instrumented build); with ``--bands`` the
device time at every band height.  It needs a CUDA device (and nvcc for
the variants and the baseline).  ``--check-only`` runs batch 2 and checks
the error alone.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..cuda_build import on_device

__all__ = ["H", "W", "ROWS", "BANDS", "STAGE1_SETS", "kernel_takes",
           "general_takes", "route", "block_kernel", "block_plain",
           "library_block", "inputs",
           "rel_err", "plan", "times", "experiment", "VARIANTS",
           "PROFILE_PHASES", "build_variants", "profile", "main"]

H = W = 56
#: every band height the TPU kernel takes: the divisors of 56
ROWS = tuple(r for r in range(1, H + 1) if H % r == 0)
#: the band heights the CUDA kernel can be held to (its own choice is one):
#: the even divisors, so that its two consumers take as many rows each
BANDS = tuple(r for r in ROWS if r % 2 == 0)
#: (cin, cmid, cout) of the blocks of stage 1 of a deep ResNet: the first,
#: and the two after it (mxnet_tpu/models/resnet.py, filter_list)
STAGE1_SETS = ((64, 64, 256), (256, 64, 256))
#: the general route's limits: its t1 rows and t2 of one row live in
#: shared memory, in tiles of the widest divisor of 56 positions that fits
#: (14 at cmid 512 in f32, 4 at cmid 2048); the weights stream, so cin and
#: cout do not touch it
MAX_C = 2048
MAX_CMID = 2048
_GENERAL_RANGE = ("cin, cmid and cout 1 to %d (t1's three rows and t2 "
                  "live in the 227 KB of shared memory a block may have)"
                  % MAX_C)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_takes(cin, cmid, cout):
    """True for the channel counts ``csrc/bottleneck_block.cu`` takes (in
    bf16)."""
    def ok(c):
        return 16 <= c <= 256 and c % 16 == 0
    return ok(cin) and ok(cout) and cmid in (16, 32, 48, 64)


def general_takes(cin, cmid, cout):
    """True for the channel counts ``csrc/bottleneck_block_general.cu``
    takes, in f32 or bf16."""
    return 1 <= cin <= MAX_C and 1 <= cout <= MAX_C and 1 <= cmid <= MAX_CMID


def _channels(x, w1, w2, w3, scales, shifts, rows):
    """``(cin, cmid, cout)``; raises on shapes the block does not take."""
    if x.dim() != 4 or tuple(x.shape[1:3]) != (H, W) or rows not in ROWS:
        raise MXNetError("bottleneck block: x must be (N, %d, %d, cin) with "
                         "rows dividing %d, got %s and rows %s"
                         % (H, W, H, tuple(x.shape), rows))
    cin = x.shape[3]
    cmid, cout = w1.shape[1], w3.shape[1]
    if tuple(w1.shape) != (cin, cmid) or tuple(w2.shape) != (9, cmid, cmid) \
            or tuple(w3.shape) != (cmid, cout):
        raise MXNetError("bottleneck block: need w1 (cin, cmid), w2 (9, "
                         "cmid, cmid), w3 (cmid, cout), got %s %s %s"
                         % (tuple(w1.shape), tuple(w2.shape),
                            tuple(w3.shape)))
    if scales.shape != shifts.shape or scales.dim() != 2 or \
            scales.shape[0] != 3 or scales.shape[1] < max(cin, cmid):
        raise MXNetError("bottleneck block: scales and shifts must be (3, "
                         ">= max(cin, cmid)), got %s and %s"
                         % (tuple(scales.shape), tuple(shifts.shape)))
    return cin, cmid, cout


def block_plain(x, w1, w2, w3, scales, shifts):
    """The TPU kernel's math in f32 over the whole image: the one-cell zero
    halo, BN-ReLU, the 1x1, BN-ReLU, the image-edge ring set to 0 (the
    pointwise chain turned its zeros into relu(b1)), the 3x3 as 9 shifted
    products, BN-ReLU, the 1x1 expand; ``y`` in x's dtype."""
    cin, cmid, cout = _channels(x, w1, w2, w3, scales, shifts, 1)
    s, b = scales.float(), shifts.float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))          # (N, H+2, W+2, cin)
    a = torch.relu(xp * s[0, :cin] + b[0, :cin])
    t1 = torch.relu((a @ w1.float()) * s[1, :cmid] + b[1, :cmid])
    interior = torch.zeros(H + 2, W + 2, 1, dtype=torch.bool,
                           device=x.device)
    interior[1:H + 1, 1:W + 1] = True
    t1 = torch.where(interior, t1, torch.zeros((), device=x.device))
    acc = 0
    for dy in range(3):
        for dx in range(3):
            acc = acc + t1[:, dy:dy + H, dx:dx + W] @ w2[dy * 3 + dx].float()
    t2 = torch.relu(acc * s[2, :cmid] + b[2, :cmid])
    return (t2 @ w3.float()).to(x.dtype)


def library_block(x, w1, w2, w3, scales, shifts):
    """The same block through the library's convolutions (cuDNN on the
    card) on the channels-last view of the NHWC activations, with the
    weights in ``channels_last`` OIHW form, BN-ReLU in f32 and each
    convolution's input rounded to x's dtype: the JAX tool's
    ``xla_block``."""
    cin, cmid, cout = _channels(x, w1, w2, w3, scales, shifts, 1)

    def bn_relu(t, i, c):
        return torch.relu(t.float() * scales[i, :c] + shifts[i, :c]) \
            .to(x.dtype)

    def conv(t, w_oihw, pad):
        w_oihw = w_oihw.to(x.dtype).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(t.permute(0, 3, 1, 2), w_oihw, padding=pad) \
            .permute(0, 2, 3, 1)

    t1 = conv(bn_relu(x, 0, cin), w1.t()[:, :, None, None], 0)
    w2k = w2.reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)
    t2 = conv(bn_relu(t1, 1, cmid), w2k, 1)
    return conv(bn_relu(t2, 2, cmid), w3.t()[:, :, None, None], 0)


def _bind(lib):
    """Set the argument types of a K9 library's C entry (this checkout's or
    an older one's: the same signature) once; returns the entry."""
    fn = lib.mxtt_bottleneck_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_bottleneck_block_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_bottleneck_block_error_string.restype = ctypes.c_char_p
    return fn


def _kernel():
    from .. import cuda_build
    lib = cuda_build.library("bottleneck_block")
    return lib, _bind(lib)


def _call(lib, fn, args, cout, last):
    """Launch ``fn`` (a K9 C entry) on ``args``, contiguous; ``last`` is the
    entry's last int (the band, or an older entry's rows).  Returns y."""
    x, w1, w2, w3, scales, shifts = args
    cin, cmid = w1.shape
    y = torch.empty(x.shape[:3] + (cout,), dtype=x.dtype, device=x.device)
    rc = on_device(x.device, lambda stream: fn(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
        scales.data_ptr(), shifts.data_ptr(), y.data_ptr(), x.shape[0], H, W,
        cin, cmid, cout, scales.shape[1], last, stream))
    if rc != 0:
        raise MXNetError("bottleneck block: CUDA launch failed: %s (%d)" % (
            lib.mxtt_bottleneck_block_error_string(rc).decode(), rc))
    return y


def route(x, w1, w2, w3, scales, shifts, rows=1):
    """The kernel that takes these inputs: ``"sm90"`` (bf16 within
    :func:`kernel_takes`) or ``"general"`` (f32, and bf16 outside it, within
    :func:`general_takes`).  Raises on inputs neither takes; builds
    nothing."""
    cin, cmid, cout = _channels(x, w1, w2, w3, scales, shifts, rows)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (w1, w2, w3)) or \
            scales.dtype != torch.float32 or shifts.dtype != torch.float32:
        raise MXNetError("bottleneck block: the kernels take x and weights "
                         "of one dtype, float32 or bfloat16, and f32 scales "
                         "and shifts; got %s, %s, %s, %s, %s, %s"
                         % tuple(t.dtype for t in (x, w1, w2, w3, scales,
                                                   shifts)))
    if any(t.device != x.device for t in (w1, w2, w3, scales, shifts)):
        raise MXNetError("bottleneck block: inputs on different devices")
    if x.dtype == torch.bfloat16 and kernel_takes(cin, cmid, cout):
        return "sm90"
    if general_takes(cin, cmid, cout):
        return "general"
    raise MXNetError("bottleneck block: the general kernel takes %s, got "
                     "(cin, cmid, cout) %s" % (_GENERAL_RANGE,
                                               (cin, cmid, cout)))


def _general_kernel():
    from .. import cuda_build
    lib = cuda_build.library("bottleneck_block_general")
    fn = lib.mxtt_bottleneck_general
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_bottleneck_general_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_bottleneck_general_error_string.restype = ctypes.c_char_p
    return lib, fn


def _call_general(args, band):
    x, w1, w2, w3, scales, shifts = args
    cin, cmid = w1.shape
    cout = w3.shape[1]
    lib, fn = _general_kernel()
    y = torch.empty(x.shape[:3] + (cout,), dtype=x.dtype, device=x.device)
    rc = on_device(x.device, lambda stream: fn(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
        scales.data_ptr(), shifts.data_ptr(), y.data_ptr(), x.shape[0], H, W,
        cin, cmid, cout, scales.shape[1], band, _DTYPES[x.dtype], stream))
    if rc != 0:
        raise MXNetError("bottleneck block: CUDA launch failed: %s (%d)" % (
            lib.mxtt_bottleneck_general_error_string(rc).decode(), rc))
    return y


def _launch_route(x, w1, w2, w3, scales, shifts, band=0, rows=1):
    """K9 on CUDA tensors through the kernel :func:`route` picks; ``band``
    the band height (one of ``BANDS``), 0 for the kernel's own; ``rows`` is
    checked as :func:`block_kernel` checks it.  Returns ``(y, route)``;
    raises on what neither kernel takes."""
    which = route(x, w1, w2, w3, scales, shifts, rows)
    if band and band not in BANDS:
        raise MXNetError("bottleneck block: band %s is not one of %s"
                         % (band, BANDS))
    if x.device.type != "cuda":
        raise MXNetError("bottleneck block: the kernels take CUDA tensors, "
                         "got %s" % x.device)
    args = tuple(t.contiguous() for t in (x, w1, w2, w3, scales, shifts))
    if which == "general":
        return _call_general(args, band), which
    lib, fn = _kernel()
    return _call(lib, fn, args, w3.shape[1], band), which


def _launch(x, w1, w2, w3, scales, shifts, band=0, rows=1):
    """:func:`_launch_route`'s y alone."""
    return _launch_route(x, w1, w2, w3, scales, shifts, band, rows)[0]


def block_kernel(x, w1, w2, w3, scales, shifts, rows=8):
    """``x`` (N, 56, 56, cin) -> (N, 56, 56, cout), weights as the JAX
    tool's ``pallas_block`` takes them: w1 (cin, cmid), w2 (9, cmid, cmid),
    w3 (cmid, cout) in x's dtype; scales, shifts (3, >= max(cin, cmid))
    f32.  ``rows``, the TPU kernel's band height, must divide 56 and does
    not change y.  A CUDA tensor launches the kernel :func:`route` picks
    (or raises), counted in ``block_kernel.launches`` (sm90) or
    ``block_kernel.general_launches``; a CPU tensor takes
    :func:`block_plain`."""
    kind = x.device.type
    if kind == "cuda":
        y, which = _launch_route(x, w1, w2, w3, scales, shifts, rows=rows)
        if which == "general":
            block_kernel.general_launches += 1
        else:
            block_kernel.launches += 1
        return y
    if kind == "cpu":
        _channels(x, w1, w2, w3, scales, shifts, rows)
        return block_plain(x, w1, w2, w3, scales, shifts)
    raise MXNetError("bottleneck block: no path for device %s" % x.device)


block_kernel.launches = 0
block_kernel.general_launches = 0


def plan(n, cin=64, cmid=64, cout=256, band=0, dtype=torch.bfloat16):
    """The plan of a launch on this card by the kernel that takes it: for
    sm90 its band height, items, x stages a consumer, t1 rows, dynamic
    shared memory and grid; for the general kernel its band height, items,
    positions a tile (a divisor of 56), dynamic shared memory, grid, blocks
    an SM and positions computed a tile."""
    if dtype == torch.bfloat16 and kernel_takes(cin, cmid, cout):
        lib, _fn = _kernel()
        entry, keys = lib.mxtt_bottleneck_block_plan, (
            "band", "items", "stages", "slots", "smem", "grid")
        argv = (n, cin, cmid, cout, band)
    else:
        lib, _fn = _general_kernel()
        entry, keys = lib.mxtt_bottleneck_general_plan, (
            "band", "items", "tile", "smem", "grid", "per_sm", "positions")
        argv = (n, cin, cmid, cout, band, _DTYPES[dtype])
    entry.argtypes = [ctypes.c_int] * len(argv) \
        + [ctypes.POINTER(ctypes.c_int)]
    entry.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    rc = entry(*argv, out)
    if rc != 0:
        raise MXNetError("bottleneck block: no plan for %s"
                         % ((n, cin, cmid, cout, band, dtype),))
    plan_ = dict(zip(keys, list(out)))
    plan_["route"] = "sm90" if "stages" in plan_ else "general"
    return plan_


def inputs(n, cin=64, cmid=64, cout=256, device="cuda", seed=0,
           dtype=torch.bfloat16):
    """``(x, w1, w2, w3, scales, shifts)`` from ``RandomState(seed)``, drawn
    as the JAX tool draws them: the activation and weights in ``dtype``
    (bf16 as the tool's default), f32 scales in [0.5, 1.5) and shifts in
    [-0.2, 0.2)."""
    rng = np.random.RandomState(seed)
    cmax = max(cin, cmid)
    arrays = (rng.uniform(-1, 1, (n, H, W, cin)),
              rng.normal(0, 0.1, (cin, cmid)),
              rng.normal(0, 0.05, (9, cmid, cmid)),
              rng.normal(0, 0.1, (cmid, cout)),
              rng.uniform(0.5, 1.5, (3, cmax)),
              rng.uniform(-0.2, 0.2, (3, cmax)))
    out = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]
    return tuple(t.to(dtype) for t in out[:4]) + tuple(out[4:])


def rel_err(args, rows):
    """max |kernel - library| over max |library| on ``args``, as the JAX
    tool reports its error."""
    y = block_kernel(*args, rows=rows).float()
    ref = library_block(*args).float()
    return ((y - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()


def times(fn):
    """The card's time a call of ``fn()`` in ms (``device_ms``: a CUDA
    graph's replay, so the host does not set it) and the host's
    microseconds a call (``host_us``), from
    :mod:`~mxnet_tpu_torch.tools.matmul_stats_experiment`."""
    from .matmul_stats_experiment import device_ms, host_us
    return {"device_ms": device_ms(fn), "host_us": host_us(fn)}


def experiment(batch=128, cin=64, cmid=64, cout=256, rows=8, repeats=10,
               device="cuda", dtype=torch.bfloat16):
    """K9 against :func:`library_block` at ``batch``: :func:`rel_err` and
    the times in ms per call (``2 + 10 * repeats`` launches of K9)."""
    from ..autotune import measure

    args = inputs(batch, cin, cmid, cout, device, dtype=dtype)
    err = rel_err(args, rows)
    chain = 10
    t_k = measure(lambda *a: block_kernel(*a, rows=rows), args, repeats,
                  chain)
    t_l = measure(library_block, args, repeats, chain)
    gflop = 2 * batch * H * W * (cin * cmid + 9 * cmid * cmid
                                 + cmid * cout) / 1e9
    return {"metric": "stage1_block_kernel_vs_library",
            "kernel_ms": t_k * 1e3, "library_ms": t_l * 1e3,
            "speedup": t_l / t_k, "rel_err": err, "gflop": gflop,
            "kernel_tflops": gflop / t_k / 1e3,
            "library_tflops": gflop / t_l / 1e3,
            "batch": batch, "rows": rows, "channels": [cin, cmid, cout],
            "dtype": str(dtype).replace("torch.", "")}


# ------------------------------------------------ variants and a baseline
_SOURCE = "bottleneck_block.cu"

#: stage 3 with the next chunk's products issued before this chunk's
#: epilogue (two accumulators in turn), so the leader's y store runs while
#: products are in flight
_STORE_IN_FLIGHT = [
    ("// Stage 3 of one output row over all cout columns",
     """template <int CMID>
__device__ __forceinline__ void s3_issue(float (&acc)[32],
                                         const uint32_t (&a)[CMID / 16][4],
                                         uint32_t w3a, int cout, int n0) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CMID / 16; ++kk)
    wgmma_rs<1>(acc, a[kk],
                interleaved_mnmajor(w3a + (n0 / 8 * CMID + 16 * kk) * 16,
                                    CMID * 16),
                kk > 0);
  wgmma_commit();
}

__device__ __forceinline__ void s3_store(float (&acc)[32], uint8_t* ys,
                                         const CUtensorMap* tm_y, int n0,
                                         int yrow, int c, int warp, int lane,
                                         bool leader) {
  fence_regs(acc);
  if (leader) bulk_wait_read<0>();
  bar_sync(BAR_Y + c, WG);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = acc_row(warp, lane, i), col = acc_col(lane, i);
    *reinterpret_cast<uint32_t*>(
        ys + XT::offset(row, col, XT::swizzle_key(row))) =
        pack_bf16(acc[i], acc[i + 1]);
  }
  fence_proxy_async();
  bar_sync(BAR_Y + c, WG);
  if (leader) {
    tma_store_2d(tm_y, ys, n0, yrow);
    bulk_commit();
  }
}

// Stage 3 of one output row over all cout columns"""),
    ("""  const int nfull = cout / 64;
  for (int n = 0; n < nfull; ++n)
    s3_chunk<64, CMID>(a, w3a, cout, n * 64, ys, tm_y, yrow, c, warp, lane,
                       leader);
""", """  const int nfull = cout / 64;
  float acc0[32], acc1[32];
  if (nfull > 0) s3_issue<CMID>(acc0, a, w3a, cout, 0);
  for (int n = 0; n < nfull; n += 2) {
    if (n + 1 < nfull) {
      s3_issue<CMID>(acc1, a, w3a, cout, (n + 1) * 64);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    s3_store(acc0, ys, tm_y, n * 64, yrow, c, warp, lane, leader);
    if (n + 1 < nfull) {
      if (n + 2 < nfull) {
        s3_issue<CMID>(acc0, a, w3a, cout, (n + 2) * 64);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      s3_store(acc1, ys, tm_y, (n + 1) * 64, yrow, c, warp, lane, leader);
    }
  }
""")]

#: a consumer's cycles by phase (clock64 in every consumer thread, thread 0
#: of each consumer writing its block's sums once, at the end), read back
#: by mxtt_bottleneck_block_profile
PROFILE_PHASES = ("x_wait", "x_rewrite", "stage1", "t1_slot_wait",
                  "t1_epilogue", "t1_wait", "stage2", "t2_pack", "stage3",
                  "release", "weights", "total")
_PROFILE_BLOCKS = 1024
_PROFILE = [
    ("using namespace sm90;\n",
     "using namespace sm90;\n__device__ long long k9_profile[%d * 2 * 16];\n"
     % _PROFILE_BLOCKS),
    ("  const int c = role;\n",
     "  const int c = role;\n  long long prof[12] = {};\n"
     "  long long pt = clock64();\n  const long long pstart = pt;\n"
     "#define PMARK(i) { const long long n_ = clock64(); "
     "prof[i] += n_ - pt; pt = n_; }\n"),
    ("        mbar_wait(&full_x[c][s], (qx / stages) & 1);\n",
     "        PMARK(11)\n        mbar_wait(&full_x[c][s], (qx / stages) & 1);"
     "\n        PMARK(0)\n"),
    ("        bar_sync(BAR_X + c, WG);\n",
     "        bar_sync(BAR_X + c, WG);\n        PMARK(1)\n"),
    ("        mbar_arrive(&empty_x[c][s]);   // the chunk's stage goes back\n",
     "        PMARK(2)\n        mbar_arrive(&empty_x[c][s]);\n"),
    ("      if (G >= slots) mbar_wait(&empty_t1[slot], (G / slots - 1) & 1);"
     "\n",
     "      if (G >= slots) mbar_wait(&empty_t1[slot], (G / slots - 1) & 1);"
     "\n      PMARK(3)\n"),
    ("      mbar_arrive(&full_t1[slot]);\n",
     "      mbar_arrive(&full_t1[slot]);\n      PMARK(4)\n"),
    ("      __syncwarp();   // wgmma is .aligned: the warp leaves the waits "
     "together\n",
     "      __syncwarp();\n      PMARK(5)\n"),
    ("      fence_regs(acc);\n      // t2 = bf16",
     "      fence_regs(acc);\n      PMARK(6)\n      // t2 = bf16"),
    ("      stage3<CMID>(a, w3a,", "      PMARK(7)\n      stage3<CMID>(a, w3a,"),
    ("                   lane, leader);\n    };\n",
     "                   lane, leader);\n      PMARK(8)\n    };\n"),
    ("      release_upto(j + 1, j);   // this consumer reads j + 2 on from "
     "here\n",
     "      PMARK(11)\n      release_upto(j + 1, j);\n      PMARK(9)\n"),
    ("  mbar_wait(&wbar[0], 0);   // w1; w2 and w3 before the first output "
     "row\n",
     "  mbar_wait(&wbar[0], 0);\n  PMARK(10)\n"),
    ("  if (leader) bulk_wait<0>();\n}\n",
     "  prof[11] = clock64() - pstart;\n"
     "  if (ctid == 0 && blockIdx.x < %d)\n"
     "    for (int i = 0; i < 12; ++i)\n"
     "      k9_profile[(blockIdx.x * 2 + c) * 16 + i] = prof[i];\n"
     "  if (leader) bulk_wait<0>();\n}\n" % _PROFILE_BLOCKS),
    ('extern "C" {\n',
     'extern "C" {\n\nint mxtt_bottleneck_block_profile(long long* out) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, k9_profile, "
     "sizeof(k9_profile));\n}\n"),
]

#: text edits of the committed source, each undoing one design choice
VARIANTS = {
    # a guard on each stage-1 product (the k-steps of a partial chunk), not
    # a switch over whole groups: ptxas serializes every wgmma (C7520)
    "product_guard": [("""  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<0, 1>(acc,""", """  for (int kk = 0; kk < CH / 16; ++kk)
    if (kk < (cin - k * CH) / 16)
    wgmma_ss<0, 1>(acc,""")],
    # no L2 prefetch of a consumer's next row
    "no_prefetch": [("""          // consumer c's next row, into L2 while this one waits for room
          if (h + 2 < p.band + 2)
            for (int k = 0; k < p.nch; ++k)
              tma_prefetch_4d(&tm_x, k * CH, -1, r0 + 1 + h, img);
""", "")],
    "store_in_flight": _STORE_IN_FLIGHT,
    "profile": _PROFILE,
}


def _sources(name, baseline):
    """{file name: text} of variant ``name``'s csrc directory ("baseline":
    the csrc directory ``baseline`` as it is)."""
    from .. import cuda_build
    csrc = Path(baseline) if name == "baseline" \
        else Path(cuda_build.__file__).resolve().parent / "csrc"
    texts = {f.name: f.read_text() for f in csrc.iterdir()
             if f.suffix in (".cu", ".cuh")}
    for old, new in VARIANTS.get(name, ()):
        if old not in texts[_SOURCE]:
            raise MXNetError("block_experiment: %r is not in %s"
                             % (old, _SOURCE))
        texts[_SOURCE] = texts[_SOURCE].replace(old, new)
    return texts


def build_variants(names, baseline=None):
    """Build the K9 of each variant in ``names`` ("baseline": the
    ``bottleneck_block.cu`` of the csrc directory ``baseline``), one nvcc
    each, all started together, with this checkout's nvcc flags.  Returns
    {variant: (library, C entry, ptxas report)}."""
    from .. import cuda_build
    procs = {}
    for name in names:
        out = cuda_build.build_dir() / "experiment_k9" / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in _sources(name, baseline).items():
            (out / fname).write_text(text)
        lib = out / "libbottleneck_block.so"
        procs[name] = (lib, subprocess.Popen(
            cuda_build.nvcc_command(out / _SOURCE, lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise MXNetError("nvcc failed for %s:\n%s" % (name, log))
        lib = ctypes.CDLL(str(path))
        built[name] = (lib, _bind(lib), "\n".join(
            ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln))
    return built


def profile(built, args, cout, grid):
    """The profile variant's cycles a consumer by phase
    (``PROFILE_PHASES``), the mean over the ``grid`` blocks' consumers of
    one launch on ``args``."""
    lib, fn, _ptxas = built
    read = lib.mxtt_bottleneck_block_profile
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    _call(lib, fn, args, cout, 0)
    torch.cuda.synchronize()
    buf = np.zeros(_PROFILE_BLOCKS * 2 * 16, np.int64)
    if read(buf.ctypes.data):
        raise MXNetError("block_experiment: the profile could not be read")
    cycles = buf.reshape(_PROFILE_BLOCKS, 2, 16)[:grid, :, :12].mean((0, 1))
    return dict(zip(PROFILE_PHASES, cycles.tolist()))


def main(argv=None):
    from . import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--cmid", type=int, default=64)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--baseline", default=None,
                    help="an older checkout's csrc directory, whose "
                    "bottleneck_block.cu is timed too (rows 4; it takes "
                    "(64, 64, 256))")
    ap.add_argument("--bands", action="store_true",
                    help="time every band height as well")
    ap.add_argument("--variants", default="",
                    help="comma-separated subset of %s" % ", ".join(
                        v for v in VARIANTS if v != "profile"))
    ap.add_argument("--profile", action="store_true",
                    help="a consumer's cycles by phase")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_experiment: no CUDA device; this tool "
                         "measures the GPU")
    # f32 means f32: cuDNN's convolutions (library_block) and cuBLAS's
    # products (block_plain) run TF32 by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, a.dtype)
    if a.check_only:
        err = rel_err(inputs(2, a.cin, a.cmid, a.cout, dtype=dtype), a.rows)
        print("rel err %.3e" % err)
        if not err < 5e-2:
            raise SystemExit("block_experiment: rel err %g >= 5e-2" % err)
        print("OK")
        return None
    out = experiment(a.batch, a.cin, a.cmid, a.cout, a.rows, a.repeats,
                     dtype=dtype)
    args = tuple(t.contiguous() for t in inputs(a.batch, a.cin, a.cmid,
                                                 a.cout, dtype=dtype))
    out.update(times(lambda: block_kernel(*args, rows=a.rows)),
               plan=plan(a.batch, a.cin, a.cmid, a.cout, dtype=dtype),
               library_device_ms=times(
                   lambda: library_block(*args))["device_ms"])
    names = [v for v in a.variants.split(",") if v]
    build = names + (["baseline"] if a.baseline else []) \
        + (["profile"] if a.profile else [])
    built = build_variants(build, a.baseline) if build else {}
    ref = block_plain(*args).float() if built else None
    mine = block_kernel(*args, rows=a.rows) if built else None
    for name in names + (["baseline"] if a.baseline else []):
        lib, fn, ptxas = built[name]
        last = 4 if name == "baseline" else 0
        y = _call(lib, fn, args, a.cout, last)
        out[name] = {
            "device_ms": times(lambda: _call(
                lib, fn, args, a.cout, last))["device_ms"],
            "max_abs_err": (y.float() - ref).abs().max().item(),
            "bit_identical_to_committed": torch.equal(y, mine),
            "ptxas_serialized": sorted({
                ln.split(")")[0].split("(")[-1] for ln in ptxas.splitlines()
                if "(C75" in ln})}
        del y
    if built:
        # the committed kernel once more after the others, in turns
        out["device_ms_after"] = times(
            lambda: block_kernel(*args, rows=a.rows))["device_ms"]
    if a.profile:
        out["profile_cycles"] = profile(built["profile"], args, a.cout,
                                        out["plan"]["grid"])
    if a.bands:
        out["bands"] = {
            r: times(lambda r=r: _launch(*args, band=r))["device_ms"]
            for r in BANDS}
    out.update(device=torch.cuda.get_device_name(0),
               nvidia_smi=nvidia_smi())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
