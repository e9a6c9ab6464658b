"""Experiment: the GEMM with a BatchNorm-statistics epilogue, with and without
the previous BatchNorm folded into its prologue, against cuBLAS and separate
statistics passes, at the ResNet-50 1x1-convolution shapes.

    python -m mxnet_tpu_torch.tools.matmul_stats_experiment
    python -m mxnet_tpu_torch.tools.matmul_stats_experiment \\
        --baseline OLD/mxnet_tpu_torch/csrc --variants bn128
    python -m mxnet_tpu_torch.tools.matmul_stats_experiment --f32 \\
        --variants wgmma_tf32

The counterpart of ``tools/pallas_matmul_stats_experiment.py``.  K7,
:func:`matmul_stats`, is ``y = x @ w``, ``s = sum(y)``, ``ss = sum(y * y)``
over the rows from the f32 accumulator: the K5 kernel
(``csrc/matmul_stats.cu``) with ``c = 0``.  K8, :func:`matmul_stats_prologue`,
is the same of ``bf16(relu(x * scale + shift))``, the kernel's prologue
variant.  The yardsticks are cuBLAS ``x @ w`` in bf16, alone
(:func:`library_dot_only`), followed by two f32 ``torch.sum`` passes over
the rounded ``y`` (:func:`library_ref`), and after an eager prologue
(:func:`library_prologue`).  Any M.

The weight lies as the kernel reads it, (N, K) rows, and is passed as its
(K, N) transpose, so the K5 wrapper's ``w.t().contiguous()`` makes no copy
and none is timed; K7's ``c = 0`` vector is made once per width and device
(:func:`_zeros`), and K8 passes none.  The table's times are
:func:`mxnet_tpu_torch.autotune.measure`'s: min over ``repeats`` samples of
``chain`` calls each, closed by ``torch.cuda.synchronize()``, so they hold
the host's time a call where it exceeds the card's.

Then, one JSON line each: at the tool's 8 shapes and at the 8 shapes one
ResNet-50 training step gives K5 (:func:`k5_shapes`), the device time a
launch of K7, K8 and cuBLAS's product (:func:`device_ms`: CUDA events
around the replay of a CUDA graph of 20 launches, so the wrapper's host
time does not set it) and the wrapper's host time a call
(:func:`host_us`); the same of each variant (``--variants``: text edits of
the committed source: ``bn128`` 128-column tiles above N = 256,
``widest`` K5 in the widest tile N needs, ``pro_registers`` K8's prologue
on A fragments in registers through the register-A form of wgmma) and of an
older checkout's kernel (``--baseline DIR``, its ``csrc`` directory, launched
through its own C entries); and the host's costs a call at a tiny shape
(:func:`host_costs`).  ``--f32`` times the f32 route alone (split TF32)
at ``F32_SHAPES``, K5 and K8, the committed kernel against the variants
(``wgmma_tf32``: the products on wgmma's .tf32 form instead of mma.sync),
with each one's error against the plain version (:func:`compare_f32`).  It prints the card's name and power limit first, and
needs a CUDA device (and nvcc for the variants and the baseline).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from .. import cuda_build
from ..base import MXNetError
from ..ops import fused

__all__ = ["shapes", "k5_shapes", "matmul_stats", "matmul_stats_prologue",
           "library_ref", "library_dot_only", "library_prologue",
           "experiment", "device_ms", "host_us", "host_costs",
           "build_variants", "VARIANTS", "F32_SHAPES", "compare_f32",
           "main"]

_KERNEL = "matmul_stats"
_SOURCE = "matmul_stats.cu"
_CSRC = Path(cuda_build.__file__).resolve().parent / "csrc"

_NAMESPACE = "namespace {\n\nusing namespace sm90;"


def _wgmma_rs(n):
    """The source of ``wgmma_rs`` for an m64n``n``k16 product with A from
    registers (``n`` / 2 accumulator registers a thread), as
    ``sm90_common.cuh`` writes those it has."""
    regs = n // 2
    outs = ", ".join('"+f"(d[%d])' % i for i in range(regs))
    return (
        "template <int TB>\n"
        "__device__ __forceinline__ void wgmma_rs(float (&d)[%d], "
        "const uint32_t (&a)[4], uint64_t db, int scale_d) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %%%d, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n%dk16.f32.bf16.bf16 {%s}, '
        '{%%%d, %%%d, %%%d, %%%d}, %%%d, p, 1, 1, %%%d;\\n}\\n"\n'
        "      : %s\n"
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
        '"r"(scale_d), "n"(TB));\n'
        "}\n\n" % (
            regs, regs + 5, n, ", ".join("%%%d" % i for i in range(regs)),
            regs, regs + 1, regs + 2, regs + 3, regs + 4, regs + 6, outs))


#: K8's route (b): the x tile is not rewritten in shared memory; each
#: consumer loads its A fragments of a k-block into registers, transforms
#: them there and runs the register-A form of wgmma.  The fragments are
#: read by the products while they run, so a k-block's are made only once
#: the previous k-block's products have ended (one k-block in flight).
_A_FRAGMENT = """// K8, route (b): consumer wg's A fragment of k-step kk of a landed x
// tile, bf16(relu(f32(x) * scale + shift)) in registers
template <typename XT>
__device__ __forceinline__ void a_fragment(const uint8_t* xs,
                                           uint32_t (&af)[4], int wg,
                                           int warp, int lane, int k0, int kk,
                                           const Args& a) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * (h & 1);
    const int col = kk * 16 + 2 * (lane & 3) + 8 * (h >> 1);
    const int k = k0 + col;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            xs + XT::offset(r, col, XT::swizzle_key(r))));
    const float v0 = k < a.K ? fmaxf(__fadd_rn(__fmul_rn(
        f.x, __ldg(a.scale + k)), __ldg(a.shift + k)), 0.f) : 0.f;
    const float v1 = k + 1 < a.K ? fmaxf(__fadd_rn(__fmul_rn(
        f.y, __ldg(a.scale + k + 1)), __ldg(a.shift + k + 1)), 0.f) : 0.f;
    af[h] = pack_bf16(v0, v1);
  }
}

// The statistics of one item"""

_PRO_REGISTERS = [
    (_NAMESPACE, "namespace sm90 {\n" + _wgmma_rs(256) + "}\n\n" + _NAMESPACE),
    ("// The statistics of one item", _A_FRAGMENT),
    ("""    float acc[BN / 2];
""", """    float acc[BN / 2];
    uint32_t af[BK / 16][4];
"""),
    ("""        if (PRO) {
          prologue_rows<XT>(st, wg, ctid, kb * BK, a);
          fence_proxy_async();
          bar_sync(BAR_PRO + wg, WG);
        }
        const uint32_t xs = smem_u32(st);
        const uint32_t ws = xs + XT::BYTES;
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<0, 0>(acc, XT::kmajor(xs, wg * 64, kk),
                         WT::kmajor(ws, 0, kk), kb > 0 || kk > 0);
""", """        const uint32_t xs = smem_u32(st);
        const uint32_t ws = xs + XT::BYTES;
        if (PRO) {
          wgmma_wait<0>();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(af[kk][h]));
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            a_fragment<XT>(st, af[kk], wg, warp, lane, kb * BK, kk, a);
        }
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (PRO)
            wgmma_rs<0>(acc, af[kk], WT::kmajor(ws, 0, kk),
                        kb > 0 || kk > 0);
          else
            wgmma_ss<0, 0>(acc, XT::kmajor(xs, wg * 64, kk),
                           WT::kmajor(ws, 0, kk), kb > 0 || kk > 0);
        }
"""),
    ("""      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);
""", """      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(af[kk][h]));
      mbar_arrive(&empty[(it - 1) % STAGES]);
""")]

def _wgmma_tf32(n):
    """The source of ``wgmma_tf32`` for an m64n``n``k8 TF32 product with A
    from registers (``n`` / 2 accumulator registers a thread); the .tf32
    form has no transpose arguments (both operands K-major)."""
    regs = n // 2
    outs = ", ".join('"+f"(d[%d])' % i for i in range(regs))
    return (
        "__device__ __forceinline__ void wgmma_tf32(float (&d)[%d], "
        "const uint32_t (&a)[4], uint64_t db, int scale_d) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %%%d, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n%dk8.f32.tf32.tf32 {%s}, '
        '{%%%d, %%%d, %%%d, %%%d}, %%%d, p, 1, 1;\\n}\\n"\n'
        "      : %s\n"
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
        '"r"(scale_d));\n'
        "}\n\n" % (
            regs, regs + 5, n, ", ".join("%%%d" % i for i in range(regs)),
            regs, regs + 1, regs + 2, regs + 3, regs + 4, outs))


#: The f32 route on wgmma (the .tf32 form), in place of mma.sync: two
#: consumer warpgroups of 64 rows, A (x) split in registers from ldsm_x4
#: fragments, B (w) split once a stage by all threads into hi and lo tiles
#: in shared memory (the TMA tile's swizzled layout, so the K-major
#: descriptors read them), three wgmma a k-step into a zeroed stage
#: accumulator (scale-d 0 on the first), added on the CUDA cores after the
#: stage's products end.  The next stage's A fragments and split run while
#: the products do (two register and two shared-memory buffers); y leaves
#: from registers (no staging: the ring keeps four stages), the statistics
#: through the bf16 kernel's Stats.
_WGMMA_TF32_KERNEL = """
template <int BN>
struct WCfg {
  using XT = tf32::TileF32<BK, BM>;
  using WT = tf32::TileF32<BK, BN>;
  static constexpr int STAGE_BYTES = XT::BYTES + WT::BYTES;
  static constexpr int SPLIT_BYTES = 2 * WT::BYTES;   // hi, lo
  static constexpr int SUM_BYTES = THREADS * (BN / 16) * 4;
  static constexpr int FIT = (SMEM_LIMIT - SMEM_STATIC - 1024 -
                              2 * SPLIT_BYTES - SUM_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 2 * SPLIT_BYTES + SUM_BYTES;
  static_assert(STAGES >= 3, "three stages at least");
};

template <int BN, bool PRO>
__global__ void __launch_bounds__(THREADS, 1)
matmul_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_y, Args a,
                          float* __restrict__ yout) {
  using C = WCfg<BN>;
  using XT = typename C::XT;
  using WT = typename C::WT;
  constexpr int STAGES = C::STAGES;
  constexpr int KS = BK / 8;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ float cs[BN];
  uint8_t* ring = align1024(smem_raw);
  uint8_t* split = ring + STAGES * C::STAGE_BYTES;
  float* sums = reinterpret_cast<float*>(split + 2 * C::SPLIT_BYTES);

  const int tid = threadIdx.x;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m_first = blockIdx.x / n_tiles;
  const int m_step = gridDim.x / n_tiles;
  const int m_tiles = (a.M + BM - 1) / BM;
  const int k_blocks = (a.K + BK - 1) / BK;
  const int uses = (m_tiles - m_first + m_step - 1) / m_step * k_blocks;
  auto load = [&](int u) {
    const int s = u % STAGES, kb = u % k_blocks;
    const int mt = m_first + u / k_blocks * m_step;
    uint8_t* st = ring + s * C::STAGE_BYTES;
    mbar_expect_tx(&full[s], C::STAGE_BYTES);
    tma_load_2d(st, &tm_x, &full[s], kb * BK, mt * BM);
    tma_load_2d(st + XT::BYTES, &tm_w, &full[s], kb * BK, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    fence_barrier_init();
    for (int u = 0; u < STAGES && u < uses; ++u) load(u);
  }
  for (int j = tid; j < BN; j += THREADS)
    cs[j] = a.c != nullptr && n0 + j < a.N ? a.c[n0 + j] : 0.f;
#pragma unroll
  for (int q = 0; q < BN / 16; ++q) sums[q * THREADS + tid] = 0.f;
  __syncthreads();

  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
  const tf32::Lane ln(lane);
  const int row = warp * 16 + (lane >> 2);
  float acc[BN / 2], p[BN / 2];
  uint32_t ah[2][KS][4], al[2][KS][4];

  // stage v: its A fragments split into buffer c, its w split into split
  // buffer c; then the ring stage goes back
  auto prep = [&](int v, int c) {
    const int s = v % STAGES, kb = v % k_blocks;
    mbar_wait(&full[s], (v / STAGES) & 1);
    __syncwarp();
    const uint8_t* xs = ring + s * C::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float x[4];
      tf32::ldsm_x4(x, xs + (wg * 64 + warp * 16) * 128 + ln.a_row +
                           (((2 * kk) << 4) ^ ln.a_xor));
      if (PRO) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = kb * BK + 8 * kk + 4 * j + ln.t;
          const float sc = k < a.K ? __ldg(a.scale + k) : 0.f;
          const float sh = k < a.K ? __ldg(a.shift + k) : 0.f;
          x[2 * j] = prologue(x[2 * j], sc, sh);
          x[2 * j + 1] = prologue(x[2 * j + 1], sc, sh);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32::split(x[i], ah[c][kk][i], al[c][kk][i]);
    }
    const float4* raw = reinterpret_cast<const float4*>(xs + XT::BYTES);
    float4* hi = reinterpret_cast<float4*>(split + c * C::SPLIT_BYTES);
    float4* lo = hi + WT::BYTES / 16;
    for (int i = tid; i < WT::BYTES / 16; i += THREADS) {
      const float4 w = raw[i];
      uint32_t h[4], l[4];
      tf32::split(w.x, h[0], l[0]);
      tf32::split(w.y, h[1], l[1]);
      tf32::split(w.z, h[2], l[2]);
      tf32::split(w.w, h[3], l[3]);
      hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                          __uint_as_float(h[2]), __uint_as_float(h[3]));
      lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                          __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
    fence_proxy_async();
    mbar_arrive(&empty[s]);
    if (tid == 0 && v + STAGES < uses) {
      mbar_wait(&empty[s], (v / STAGES) & 1);
      load(v + STAGES);
    }
    __syncwarp();
  };

  if (uses > 0) prep(0, 0);
  __syncthreads();
  for (int u0 = 0; u0 < uses; u0 += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int u = u0 + b;
      if (u < uses) {
        const int kb = u % k_blocks;
        if (kb == 0) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        }
        const uint32_t hs = smem_u32(split + b * C::SPLIT_BYTES);
        const uint32_t ls = hs + WT::BYTES;
        wgmma_fence();
        fence_regs(p);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          wgmma_tf32(p, al[b][kk], gmma_desc(hs + 32 * kk, 16, 1024, 1),
                     kk > 0);
          wgmma_tf32(p, ah[b][kk], gmma_desc(ls + 32 * kk, 16, 1024, 1), 1);
          wgmma_tf32(p, ah[b][kk], gmma_desc(hs + 32 * kk, 16, 1024, 1), 1);
        }
        wgmma_commit();
        if (u + 1 < uses) prep(u + 1, 1 - b);
        wgmma_wait<0>();
        fence_regs(p);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            asm volatile("" : "+r"(ah[b][kk][i]), "+r"(al[b][kk][i]));
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += p[i];
        if (kb == k_blocks - 1) {
          const int m0 = (m_first + u / k_blocks * m_step) * BM;
          const int grow = m0 + wg * 64 + row;
          float* y = yout;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (grow + 8 * r < a.M)
#pragma unroll
              for (int n = 0; n < BN / 8; ++n) {
                const int col = n0 + 8 * n + 2 * (lane & 3);
                if (col < a.N)
                  *reinterpret_cast<float2*>(
                      y + (size_t)(grow + 8 * r) * a.N + col) =
                      make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
              }
          Stats<BN>::item(acc, sums + tid, cs, grow < a.M, grow + 8 < a.M,
                          lane);
        }
        __syncthreads();
      }
    }
  }

  float* red = reinterpret_cast<float*>(ring);   // [8 warps][2][BN]
  const int wq = wg * 4 + warp;
  const int stat = (lane >> 4) & 1;
#pragma unroll
  for (int q = 0; q < BN / 16; ++q)
    red[(wq * 2 + stat) * BN + Stats<BN>::column(q, lane)] =
        sums[q * THREADS + tid];
  __syncthreads();
  const size_t prow = (size_t)(blockIdx.x / n_tiles) * a.N;
  for (int e = tid; e < 2 * BN; e += THREADS) {
    const int st = e / BN, col = e % BN;
    float v = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) v += red[(w8 * 2 + st) * BN + col];
    if (n0 + col < a.N) (st ? a.part2 : a.part1)[prow + n0 + col] = v;
  }
}

"""

#: variant name -> [(text in the committed source, its replacement)]
VARIANTS = {
    # N above 256 in 128-column tiles, not 256
    "bn128": [("inline int widest_tile(int N) { return N <= 64 ? 64 : N <= "
               "128 ? 128 : 256; }",
               "inline int widest_tile(int N) { return N <= 64 ? 64 : N <= "
               "256 ? (N <= 128 ? 128 : 256) : 128; }")],
    # K5 too in the widest tile N needs, whatever the rounds
    "widest": [("  if (pro) return widest;\n", "  return widest;\n")],
    "pro_registers": _PRO_REGISTERS,
    # the split with hi truncated to TF32 (one AND) instead of rounded to
    # nearest (cvt.rna, three instructions on sm_90a): |lo| < 2^-10 |x|
    # where rounding leaves 2^-11
    "trunc_hi": [
        ("// relu(v * scale + shift), the product and the sum rounded apart",
         "__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,\n"
         "                                            uint32_t& lo) {\n"
         "  hi = __float_as_uint(x) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));\n"
         "}\n\n"
         "// relu(v * scale + shift), the product and the sum rounded apart"),
        ("          for (int i = 0; i < 4; ++i) tf32::split(x[i], fa[m].hi[i], "
         "fa[m].lo[i]);",
         "          for (int i = 0; i < 4; ++i) split_trunc(x[i], fa[m].hi[i], "
         "fa[m].lo[i]);"),
        ("          fb[n].set(w[0], w[1]);\n          fb[n + 1].set(w[2], w[3]);",
         "          split_trunc(w[0], fb[n].hi[0], fb[n].lo[0]);\n"
         "          split_trunc(w[1], fb[n].hi[1], fb[n].lo[1]);\n"
         "          split_trunc(w[2], fb[n + 1].hi[0], fb[n + 1].lo[0]);\n"
         "          split_trunc(w[3], fb[n + 1].hi[1], fb[n + 1].lo[1]);")],
    # the f32 route on wgmma's .tf32 form instead of mma.sync
    "wgmma_tf32": [
        ("// ----------------------------------------------------- the column "
         "sums\n",
         _wgmma_tf32(64) + _wgmma_tf32(128) + _WGMMA_TF32_KERNEL
         + "// ----------------------------------------------------- the "
         "column sums\n"),
        ("  auto kern = f32::matmul_stats_tf32_kernel<BN, PRO>;",
         "  using WC = f32::WCfg<BN>;\n"
         "  auto kern = f32::matmul_stats_wgmma_kernel<BN, PRO>;"),
        ("        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "(int)C::SMEM);\n    if (err != cudaSuccess) return (int)err;\n"
         "    if (dev < MAX_DEVICES) opted_in[dev] = true;\n  }\n"
         "  CUtensorMap tm_x, tm_w, tm_y;\n  const int rc = encode_maps_f32",
         "        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "(int)WC::SMEM);\n    if (err != cudaSuccess) return (int)err;\n"
         "    if (dev < MAX_DEVICES) opted_in[dev] = true;\n  }\n"
         "  CUtensorMap tm_x, tm_w, tm_y;\n  const int rc = encode_maps_f32"),
        ("  kern<<<rows * n_tiles, f32::THREADS, C::SMEM, st>>>(tm_x, tm_w, "
         "tm_y,\n                                                       "
         "args);",
         "  kern<<<rows * n_tiles, f32::THREADS, WC::SMEM, st>>>(tm_x, tm_w, "
         "tm_y, args,\n                                                        "
         "static_cast<float*>(y));")],
}


def shapes(batch=128):
    """``(M, K, N)`` of the ResNet-50 1x1 convolutions the JAX tool times,
    M = batch * H * W."""
    return [(batch * 56 * 56, 64, 256), (batch * 56 * 56, 256, 64),
            (batch * 28 * 28, 512, 128), (batch * 28 * 28, 128, 512),
            (batch * 14 * 14, 1024, 256), (batch * 14 * 14, 256, 1024),
            (batch * 7 * 7, 2048, 512), (batch * 7 * 7, 512, 2048)]


def k5_shapes(batch=128):
    """``(M, K, N)`` of K5's launches in one ResNet-50 v2 training step
    under block fusion (the 16 pointwise conv->BN blocks, 8 shapes)."""
    return [(batch * 56 * 56, 64, 64), (batch * 56 * 56, 256, 64),
            (batch * 56 * 56, 256, 128), (batch * 28 * 28, 512, 128),
            (batch * 28 * 28, 512, 256), (batch * 14 * 14, 1024, 256),
            (batch * 14 * 14, 1024, 512), (batch * 7 * 7, 2048, 512)]


_ZEROS = {}


def _zeros(n, device):
    """A cached f32 zero vector of ``n`` values on ``device``: K7's c."""
    key = (n, str(device))
    z = _ZEROS.get(key)
    if z is None:
        z = _ZEROS[key] = torch.zeros(n, dtype=torch.float32, device=device)
    return z


def _rows(out):
    y, s, ss = out
    return y, s.reshape(1, -1), ss.reshape(1, -1)


def matmul_stats(x, w):
    """K7: ``(y, s, ss)``, ``y = x @ w`` in x's dtype and the f32 (1, N)
    sums of y and y^2 from the accumulator (``ops.fused.matmul_stats`` with
    ``c = 0``)."""
    return _rows(fused.matmul_stats(x, w, _zeros(w.shape[1], x.device)))


def matmul_stats_prologue(x, w, scale, shift):
    """K8: :func:`matmul_stats` of ``relu(x * scale + shift)`` rounded to
    x's dtype; ``scale``, ``shift`` (1, K) f32."""
    return _rows(fused.matmul_stats_prologue(x, w, scale, shift))


def library_ref(x, w):
    """cuBLAS ``x @ w`` in x's dtype, then the f32 sums of the rounded y
    and its square over the rows (the JAX tool's ``xla_ref``)."""
    y = x @ w
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def library_dot_only(x, w):
    """cuBLAS ``x @ w`` alone (the JAX tool's ``xla_dot_only``)."""
    return x @ w


def library_prologue(x, w, scale, shift):
    """:func:`library_ref` after the prologue in eager PyTorch."""
    return library_ref(torch.relu(x.float() * scale + shift).to(x.dtype), w)


def _inputs(m, k, n, rng, device):
    x, w, scale, shift = (
        torch.from_numpy(a.astype(np.float32)).to(device)
        for a in (rng.randn(m, k), rng.randn(k, n) * 0.05,
                  rng.rand(1, k), rng.randn(1, k)))
    # (N, K) rows as the kernel reads them, passed as the (K, N) view
    return (x.to(torch.bfloat16), w.to(torch.bfloat16).t().contiguous().t(),
            scale, shift)


def experiment(batch=128, repeats=2, chain=24, device="cuda"):
    """For each shape: inputs from ``RandomState(0)``, K7 held against
    :func:`library_ref` as the JAX tool holds its kernel against XLA, then
    the five timings.  Returns one dict a shape, times in ms."""
    from ..autotune import measure

    rng = np.random.RandomState(0)
    out = []
    for m, k, n in shapes(batch):
        x, w, scale, shift = _inputs(m, k, n, rng, device)
        # y within bf16 rounding; the statistics within the slack of
        # summing the rounded y (the kernel sums the f32 accumulator)
        y0, s0, ss0 = library_ref(x, w)
        y1, s1, _ss1 = matmul_stats(x, w)
        torch.testing.assert_close(y1.float(), y0.float(), rtol=2e-2,
                                   atol=2e-1)
        stat_scale = ss0.mean().sqrt().item()
        err = ((s1[0] - s0).abs() / stat_scale).max().item()
        if not err < 0.05:
            raise AssertionError("stats diverge: %g" % err)
        del y0, y1

        def ms(fn, *args):
            return measure(fn, args, repeats=repeats, chain=chain) * 1e3

        out.append({
            "M": m, "K": k, "N": n,
            "dot_ms": ms(library_dot_only, x, w),
            "library_ms": ms(library_ref, x, w),
            "kernel_ms": ms(matmul_stats, x, w),
            "prologue_ms": ms(matmul_stats_prologue, x, w, scale, shift),
            "library_prologue_ms": ms(library_prologue, x, w, scale, shift)})
    return out


# ------------------------------------------------------- device and host
def device_ms(fn, launches=20, replays=3):
    """Milliseconds of device time a call of ``fn()``: ``launches`` calls
    captured in one CUDA graph, whose replay is timed by CUDA events (the
    least of ``replays``), divided by ``launches``.  The host's work a
    call (checks, allocation, ctypes) is not replayed, so it does not set
    the time; the gaps between the graph's kernels are in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm: builds, loads, opts in
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = None
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    del graph
    return best / launches


def host_us(fn, calls=20):
    """Microseconds of the host's time a call of ``fn()``: ``calls`` calls
    enqueued back to back, the clock read before the closing
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def host_costs(calls=2000, shape=(256, 64, 64)):
    """Microseconds a call at a tiny bf16 shape, where the card's work is a
    few microseconds: the wrapper's wall a call (argument checks,
    allocation, ctypes, the C entry), the C entry's alone (three
    tensor-map encodes and the two launches) on preallocated outputs, and
    the three encodes alone."""
    m, k, n = shape
    x, w, _scale, _shift = _inputs(m, k, n, np.random.RandomState(1),
                                   "cuda")
    w_nk = w.t()
    c = _zeros(n, x.device)
    rows = fused._partial_rows(x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    buf = torch.empty(2 * (rows + 1) * n, dtype=torch.float32,
                      device="cuda")
    lib, fn = fused._kernel("mxtt_matmul_stats")
    lib.mxtt_matmul_stats_encode.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), w_nk.data_ptr(), c.data_ptr(), y.data_ptr(),
            buf.data_ptr(), buf[2 * rows * n:].data_ptr(), m, n, k, rows,
            0, 0, 1, stream)

    def wall(f):
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    return {"shape": list(shape),
            "wrapper_us": wall(lambda: fused.matmul_stats(x, w, c)),
            "c_entry_us": wall(lambda: fn(*args)),
            "encode_us": wall(lambda: lib.mxtt_matmul_stats_encode(
                x.data_ptr(), w_nk.data_ptr(), y.data_ptr(), m, n, k))}


# ------------------------------------------------ variants and a baseline
def _sources(name, baseline):
    """{file name: text} of variant ``name``'s csrc directory."""
    if name == "baseline":
        return {f.name: f.read_text() for f in Path(baseline).iterdir()
                if f.suffix in (".cu", ".cuh")}
    texts = {f.name: f.read_text() for f in _CSRC.iterdir()
             if f.suffix in (".cu", ".cuh")}
    for old, new in VARIANTS[name]:
        if old not in texts[_SOURCE]:
            raise MXNetError("matmul_stats_experiment: %r is not in %s"
                             % (old, _SOURCE))
        texts[_SOURCE] = texts[_SOURCE].replace(old, new)
    return texts


def build_variants(names, baseline=None):
    """Build the kernel of each variant in ``names`` ("baseline": the
    ``matmul_stats.cu`` of the csrc directory ``baseline``), one nvcc each,
    all started together.  Returns {variant: (library path, ptxas
    report)}."""
    procs = {}
    for name in names:
        out = cuda_build.build_dir() / "experiment_k5" / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in _sources(name, baseline).items():
            (out / fname).write_text(text)
        lib = out / ("lib%s.so" % _KERNEL)
        procs[name] = (lib, subprocess.Popen(
            cuda_build.nvcc_command(out / _SOURCE, lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise MXNetError("nvcc failed for %s:\n%s" % (name, log))
        built[name] = (str(lib), "\n".join(
            ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln))
    return built


@contextmanager
def _standing_in(path):
    """The K5 wrapper launches the library at ``path`` in place of the
    committed one until the block ends."""
    saved = cuda_build.library(_KERNEL)
    try:
        cuda_build._libs[_KERNEL] = ctypes.CDLL(path)
        yield
    finally:
        cuda_build._libs[_KERNEL] = saved


class _OldEntry:
    """An older ``matmul_stats.cu``'s C entries, whose partial buffers
    take ``ceil(M / mxtt_matmul_stats_block_rows())`` rows and whose K8
    takes a c vector: K5 ``(x, w_nk, c)`` and K8 ``(x, w_nk, scale,
    shift)``, both bf16, returning y."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(path)
        self.rows = self.lib.mxtt_matmul_stats_block_rows()
        for entry, pointers in (("mxtt_matmul_stats", 8),
                                ("mxtt_matmul_stats_prologue", 10)):
            fn = getattr(self.lib, entry)
            fn.argtypes = [ctypes.c_void_p] * pointers \
                + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def _call(self, fn, x, w_nk, vectors, c):
        m, k = x.shape
        n = w_nk.shape[0]
        y = torch.empty((m, n), dtype=x.dtype, device=x.device)
        part = torch.empty((2, -(-m // self.rows), n), dtype=torch.float32,
                           device=x.device)
        s = torch.empty((2, n), dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), w_nk.data_ptr(),
                *[v.data_ptr() for v in vectors], c.data_ptr(),
                y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                s[0].data_ptr(), s[1].data_ptr(), m, n, k, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise MXNetError("baseline matmul_stats failed: %d" % rc)
        return y, s[0], s[1]

    def k5(self, x, w_nk, c):
        return self._call(self.lib.mxtt_matmul_stats, x, w_nk, [], c)

    def k8(self, x, w_nk, scale, shift, zero):
        return self._call(self.lib.mxtt_matmul_stats_prologue, x, w_nk,
                          [scale, shift], zero)


def compare(batch=128, names=(), built=None):
    """One dict a shape: at :func:`k5_shapes` K5 (c drawn from a seed), at
    :func:`shapes` K7 and K8; each with the committed kernel's, every
    variant's and the baseline's :func:`device_ms` (``built`` as
    :func:`build_variants` returns it), cuBLAS's product's, and the
    wrapper's :func:`host_us`."""
    built = built or {}
    old = _OldEntry(built["baseline"][0]) if "baseline" in built else None
    rng = np.random.RandomState(2)
    rows = []
    cases = [("k5", s) for s in k5_shapes(batch)] \
        + [("k7", s) for s in shapes(batch)] \
        + [("k8", s) for s in shapes(batch)]
    for kind, (m, k, n) in cases:
        x, w, scale, shift = _inputs(m, k, n, rng, "cuda")
        w_nk = w.t()
        zero = _zeros(n, x.device)
        c = zero if kind != "k5" else \
            0.1 * torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        if kind == "k8":
            def run():
                return fused.matmul_stats_prologue(x, w, scale, shift)
        else:
            def run():
                return fused.matmul_stats(x, w, c)
        row = {"kernel": kind, "shape": [m, k, n],
               "device_ms": device_ms(run), "host_us": host_us(run),
               "dot_ms": device_ms(lambda: x @ w)}
        for name in names:
            with _standing_in(built[name][0]):
                row[name + "_device_ms"] = device_ms(run)
        if old is not None:
            row["baseline_device_ms"] = device_ms(
                (lambda: old.k8(x, w_nk, scale, shift, zero))
                if kind == "k8" else (lambda: old.k5(x, w_nk, c)))
        rows.append(row)
        del x, w, w_nk, scale, shift
    return rows


#: the f32 route's shapes: ResNet-50's first pointwise convolution and its
#: deepest well-fed one, at batch 128
F32_SHAPES = [(401408, 64, 64), (25088, 1024, 256)]


def compare_f32(names=(), built=None, shapes_=F32_SHAPES):
    """The f32 route (split TF32): one dict a shape and entry (K5 with c
    drawn from a seed, K8), with the committed kernel's and every
    variant's :func:`device_ms`, max |y - plain| over max |plain|, the
    sums' relative norms and whether two launches give the same bits, and
    cuBLAS's f32 product (TF32 off) as ``dot_ms``."""
    built = built or {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for m, k, n in shapes_:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).t()
        c = 0.1 * torch.randn(n, generator=gen, device="cuda")
        scale = torch.rand(k, generator=gen, device="cuda") + 0.5
        shift = torch.randn(k, generator=gen, device="cuda")
        for kind in ("k5", "k8"):
            if kind == "k8":
                def run():
                    return fused.matmul_stats_prologue(x, w, scale, shift)
                ref = fused.matmul_stats_prologue_plain(x, w, scale, shift)
            else:
                def run():
                    return fused.matmul_stats(x, w, c)
                ref = fused.matmul_stats_plain(x, w, c)

            def check(out, again):
                y, s1, s2 = out
                return {
                    "y_rel_err": ((y - ref[0]).abs().max()
                                  / ref[0].abs().max()).item(),
                    "s1_rel_norm": ((s1 - ref[1]).norm()
                                    / ref[1].norm()).item(),
                    "s2_rel_norm": ((s2 - ref[2]).norm()
                                    / ref[2].norm()).item(),
                    "bit_identical": all(torch.equal(p, q)
                                         for p, q in zip(out, again))}

            row = {"kernel": kind, "shape": [m, k, n],
                   "device_ms": device_ms(run),
                   "dot_ms": device_ms(lambda: x @ w), **check(run(), run())}
            for name in names:
                with _standing_in(built[name][0]):
                    row[name] = dict(device_ms=device_ms(run),
                                     **check(run(), run()))
            row["device_ms_after"] = device_ms(run)
            rows.append(row)
        del x, w, c, scale, shift
    return rows


def main(argv=None):
    from . import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--chain", type=int, default=24)
    ap.add_argument("--variants", default="",
                    help="comma-separated subset of %s" % ", ".join(VARIANTS))
    ap.add_argument("--baseline", default=None,
                    help="an older checkout's csrc directory, whose "
                    "matmul_stats.cu is timed too")
    ap.add_argument("--f32", action="store_true",
                    help="the f32 route alone: the committed kernel and "
                    "the variants at F32_SHAPES (K5 and K8)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_stats_experiment: no CUDA device; this "
                         "tool measures the GPU")
    print(nvidia_smi(), flush=True)
    if a.f32:
        torch.backends.cuda.matmul.allow_tf32 = False
        names = [n for n in a.variants.split(",") if n]
        built = build_variants(names) if names else {}
        for name in names:
            print(json.dumps({"variant": name, "ptxas": built[name][1]}),
                  flush=True)
        rows = compare_f32(names, built)
        for row in rows:
            print(json.dumps(row), flush=True)
        return rows
    rows = experiment(a.batch, a.repeats, a.chain)
    print(f"{'M':>9} {'K':>5} {'N':>5} | {'lib dot':>8} {'lib+st':>8} "
          f"{'kernel':>8} {'ker+pro':>8} {'lib+pro':>8}  (ms)")
    for r in rows:
        print(f"{r['M']:>9} {r['K']:>5} {r['N']:>5} | {r['dot_ms']:8.3f} "
              f"{r['library_ms']:8.3f} {r['kernel_ms']:8.3f} "
              f"{r['prologue_ms']:8.3f} {r['library_prologue_ms']:8.3f}",
              flush=True)
    names = [n for n in a.variants.split(",") if n]
    build = names + (["baseline"] if a.baseline else [])
    built = build_variants(build, a.baseline) if build else {}
    for name in build:
        print(json.dumps({"variant": name, "ptxas": built[name][1]}),
              flush=True)
    for row in compare(a.batch, names, built):
        print(json.dumps(row), flush=True)
    print(json.dumps({"host": host_costs()}), flush=True)
    return rows


if __name__ == "__main__":
    main()
