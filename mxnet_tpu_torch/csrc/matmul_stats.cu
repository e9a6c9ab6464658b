// K5: a GEMM whose epilogue also returns the BatchNorm statistics, for
// Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/fused.py, matmul_stats (its Pallas kernel
// _stats_kernel).  There it is the forward of a pointwise (1x1, stride 1)
// convolution followed by a training BatchNorm: the conv is a GEMM over the
// NHWC activation, and the statistics of its output come out of the same
// pass instead of a second read of y.
//
// Computes, for x (M, K) row-major (the contiguous NHWC activation as
// (N*H*W, C)), w (N, K) row-major (the OIHW 1x1 weight as it lies, so
// y = x w^T is a B^T GEMM and no transpose is made) and c (N,) f32 (the
// moving mean, the shift of the statistics):
//   y  = x w^T                    (M, N), x's dtype
//   s1 = sum over rows (y - c)    (N,) f32
//   s2 = sum over rows (y - c)^2  (N,) f32
// where y inside the sums is the f32 accumulator, before y is rounded to
// x's dtype, as in the TPU kernel.  Any M, N, K: every tile is
// bounds-checked.
//
// K8, the prologue variant (mxtt_matmul_stats_prologue), replaces
// tools/pallas_matmul_stats_experiment.py, matmul_stats_prologue (its
// Pallas kernel _kernel_prologue): the same function of
//   xh = relu(x * scale + shift)   scale, shift (K,) f32
// computed in f32 and rounded to x's dtype before the product, the previous
// BatchNorm's transform folded into this GEMM.  The x tile lands in shared
// memory by cp.async; one pass over it applies the transform after the copy
// and before the fragment loads.  Depth columns past K get 0 (the scale and
// shift there are never read), so they add nothing; rows past M become
// relu(shift) and not 0, but the epilogue neither stores nor sums rows past
// M.  K7 (tools/pallas_matmul_stats_experiment.py, matmul_stats) is this
// file's K5 entry with c = 0.
//
// What bounds it on this card: at ResNet-50's shapes (K 64 to 2048, N 64 to
// 512) the product does 2K flops for every 2(K + N) bytes of x and y that
// one row moves in bf16, under the 295 flops a byte at which the H100's
// tensor cores overtake its memory: the 16 launches of a training step are
// bound by bytes (1.9 GB at 3.35 TB/s) more than by operations.  So the
// design reads x once, keeps y's statistics out of device memory, and
// leaves the speed of the product itself to a later wgmma/TMA version.
//
// What the design does:
// * bf16: mma.sync m16n8k16 on the tensor cores with f32 accumulation.  A
//   block of 8 warps owns a 128 x 64 tile of y; each warp a 32 x 32 part
//   of it (2 x 4 mma tiles).  x and w tiles of depth 32 are staged in
//   shared memory by cp.async, two stages deep, rows padded to 40 values so
//   that the fragment loads of a warp hit 32 different banks.
// * f32: the same tiling on the CUDA cores, each thread an 8 x 4 block of
//   FMAs, tiles of depth 16 stored k-major.  No tensor cores, so no TF32:
//   f32 means f32.
// * The statistics: each thread sums (acc - c) and its square over the rows
//   it owns, a warp reduces over its rows by shuffles, the warps of a block
//   through shared memory, always in one order.  The block writes one row
//   of a (blocks along M, N) partial buffer; a second kernel sums each
//   column of it in a fixed order.  The TPU summed across its grid in
//   order; H100 blocks run in no order, so each sum has one owner and no
//   atomics are used: the result is the same on every run.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmatmul_stats-<hash>.so this file
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows of y per block
constexpr int BN = 64;        // columns of y per block
constexpr int THREADS = 256;  // 8 warps

// ------------------------------------------------------------- bf16 path
constexpr int BK16 = 32;          // depth of a staged tile
constexpr int LDS16 = BK16 + 8;   // padded row, in bf16 values (80 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + ROWS) x depth [k0, k0 + BK16) of a row-major
// (rows, K) bf16 matrix into dst[ROWS][LDS16].  VEC: K % 8 == 0 and the
// base 16-byte aligned, so each 8-value chunk lies wholly inside or
// outside the matrix and moves by cp.async; otherwise value by value.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16 (*dst)[LDS16],
                                           const __nv_bfloat16* src,
                                           int rows, int K, int r0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int CHUNKS = ROWS * BK16 / 8;
#pragma unroll
    for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int chunk = tid + i * THREADS;
      if (chunk < CHUNKS) {
        const int r = chunk / (BK16 / 8);
        const int kc = (chunk % (BK16 / 8)) * 8;
        const bool in = (r0 + r < rows) && (k0 + kc < K);
        const __nv_bfloat16* g =
            in ? src + (size_t)(r0 + r) * K + (k0 + kc) : src;
        cp_async16(&dst[r][kc], g, in ? 16 : 0);
      }
    }
  } else {
    for (int e = tid; e < ROWS * BK16; e += THREADS) {
      const int r = e / BK16;
      const int kc = e % BK16;
      const bool in = (r0 + r < rows) && (k0 + kc < K);
      dst[r][kc] = in ? src[(size_t)(r0 + r) * K + (k0 + kc)]
                      : __float2bfloat16(0.0f);
    }
  }
}

// relu(v * scale + shift) for depth column k, 0 past K; the product and the
// sum rounded apart, as the plain version computes them
__device__ __forceinline__ float prologue(float v, const float* scale,
                                          const float* shift, int k, int K) {
  return k < K ? fmaxf(__fadd_rn(__fmul_rn(v, scale[k]), shift[k]), 0.0f)
               : 0.0f;
}

template <bool VEC, bool PRO>
__global__ void __launch_bounds__(THREADS)
matmul_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         const float* __restrict__ c,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ part1, float* __restrict__ part2,
                         int M, int N, int K, int n_tiles) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][BM][LDS16];
  __shared__ __align__(16) __nv_bfloat16 ws[2][BN][LDS16];
  __shared__ float red1[4][BN];
  __shared__ float red2[4][BN];

  const int tile_m = blockIdx.x / n_tiles;
  const int tile_n = blockIdx.x % n_tiles;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 1;  // 0..3: 32 rows each
  const int warp_n = warp & 1;   // 0..1: 32 columns each
  const int g = lane >> 2;       // mma group: row (A, C) or column (B)
  const int t = lane & 3;        // thread in group

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  const int k_tiles = (K + BK16 - 1) / BK16;
  stage_bf16<BM, VEC>(xs[0], x, M, K, m0, 0);
  stage_bf16<BN, VEC>(ws[0], w, N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < k_tiles) {
      // the other stage was released by the barrier at the end of the
      // previous iteration
      stage_bf16<BM, VEC>(xs[s ^ 1], x, M, K, m0, (kt + 1) * BK16);
      stage_bf16<BN, VEC>(ws[s ^ 1], w, N, K, n0, (kt + 1) * BK16);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (PRO) {
      // the landed x tile, in place: bf16(relu(f32(x) * scale + shift))
      const int k0 = kt * BK16;
      for (int e = threadIdx.x; e < BM * BK16 / 2; e += THREADS) {
        const int r = e / (BK16 / 2);
        const int kc = (e % (BK16 / 2)) * 2;
        auto* p = reinterpret_cast<__nv_bfloat162*>(&xs[s][r][kc]);
        const float2 v = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(prologue(v.x, scale, shift, k0 + kc, K),
                                   prologue(v.y, scale, shift, k0 + kc + 1, K));
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = warp_m * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[s][r][kk + 2 * t]);
        a[mi][1] =
            *reinterpret_cast<const uint32_t*>(&xs[s][r + 8][kk + 2 * t]);
        a[mi][2] =
            *reinterpret_cast<const uint32_t*>(&xs[s][r][kk + 2 * t + 8]);
        a[mi][3] =
            *reinterpret_cast<const uint32_t*>(&xs[s][r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp_n * 32 + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&ws[s][n][kk + 2 * t]);
        b[ni][1] =
            *reinterpret_cast<const uint32_t*>(&ws[s][n][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue.  acc[mi][ni][j] is y at row warp_m*32 + mi*16 + g + 8*(j/2),
  // column warp_n*32 + ni*8 + 2*t + (j%2) of the block's tile.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int nl = warp_n * 32 + ni * 8 + 2 * t;  // local column, pair
    const int n = n0 + nl;
    const float c0 = n < N ? c[n] : 0.0f;
    const float c1 = n + 1 < N ? c[n + 1] : 0.0f;
    float s1a = 0.0f, s1b = 0.0f, s2a = 0.0f, s2b = 0.0f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
        if (r >= M) continue;
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        __nv_bfloat16* yr = y + (size_t)r * N;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < N) yr[n] = __float2bfloat16(v0);
          if (n + 1 < N) yr[n + 1] = __float2bfloat16(v1);
        }
        const float d0 = v0 - c0, d1 = v1 - c1;
        s1a += d0;
        s2a += d0 * d0;
        s1b += d1;
        s2b += d1 * d1;
      }
    }
    // reduce over the 8 groups of the warp (lanes differing in bits 2-4)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s1a += __shfl_xor_sync(0xffffffffu, s1a, off);
      s1b += __shfl_xor_sync(0xffffffffu, s1b, off);
      s2a += __shfl_xor_sync(0xffffffffu, s2a, off);
      s2b += __shfl_xor_sync(0xffffffffu, s2b, off);
    }
    if (g == 0) {
      red1[warp_m][nl] = s1a;
      red1[warp_m][nl + 1] = s1b;
      red2[warp_m][nl] = s2a;
      red2[warp_m][nl + 1] = s2b;
    }
  }
  __syncthreads();
  if (threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
    const int nl = threadIdx.x;
    const float a1 = ((red1[0][nl] + red1[1][nl]) + red1[2][nl]) + red1[3][nl];
    const float a2 = ((red2[0][nl] + red2[1][nl]) + red2[2][nl]) + red2[3][nl];
    part1[(size_t)tile_m * N + n0 + nl] = a1;
    part2[(size_t)tile_m * N + n0 + nl] = a2;
  }
}

// -------------------------------------------------------------- f32 path
constexpr int BK32 = 16;

// Stage rows [r0, r0 + ROWS) x depth [k0, k0 + BK32) of a row-major
// (rows, K) f32 matrix into dst[BK32][ROWS + 4], k-major.  VEC: K % 4 == 0
// and the base 16-byte aligned (float4 loads).  PRO: each value through
// prologue() on its way in.
template <int ROWS, bool VEC, bool PRO>
__device__ __forceinline__ void stage_f32(float (*dst)[ROWS + 4],
                                          const float* src, int rows, int K,
                                          int r0, int k0, const float* scale,
                                          const float* shift) {
  const int tid = threadIdx.x;
  constexpr int CHUNKS = ROWS * BK32 / 4;
#pragma unroll
  for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int chunk = tid + i * THREADS;
    if (chunk >= CHUNKS) continue;
    const int r = chunk / (BK32 / 4);
    const int kc = (chunk % (BK32 / 4)) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + r < rows) {
      const float* p = src + (size_t)(r0 + r) * K + k0 + kc;
      if (VEC) {
        if (k0 + kc < K) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + kc + j < K) v[j] = p[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[kc + j][r] = PRO ? prologue(v[j], scale, shift, k0 + kc + j, K) : v[j];
  }
}

template <bool VEC, bool PRO>
__global__ void __launch_bounds__(THREADS)
matmul_stats_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const float* __restrict__ c, float* __restrict__ y,
                        float* __restrict__ part1, float* __restrict__ part2,
                        int M, int N, int K, int n_tiles) {
  __shared__ __align__(16) float xs[BK32][BM + 4];
  __shared__ __align__(16) float ws[BK32][BN + 4];
  __shared__ float red1[16][BN];
  __shared__ float red2[16][BN];

  const int tile_m = blockIdx.x / n_tiles;
  const int tile_n = blockIdx.x % n_tiles;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;
  const int tx = threadIdx.x & 15;  // columns tx*4 .. tx*4+3
  const int ty = threadIdx.x >> 4;  // rows ty*8 .. ty*8+7

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK32) {
    stage_f32<BM, VEC, PRO>(xs, x, M, K, m0, k0, scale, shift);
    stage_f32<BN, VEC, false>(ws, w, N, K, n0, k0, nullptr, nullptr);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    cc[j] = n < N ? c[n] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 8 + i;
    if (r >= M) continue;
    float* yr = y + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) yr[n] = acc[i][j];
      const float d = acc[i][j] - cc[j];
      s1[j] += d;
      s2[j] += d * d;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red1[ty][tx * 4 + j] = s1[j];
    red2[ty][tx * 4 + j] = s2[j];
  }
  __syncthreads();
  if (threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
    const int nl = threadIdx.x;
    float a1 = 0.0f, a2 = 0.0f;
    for (int i = 0; i < 16; ++i) {
      a1 += red1[i][nl];
      a2 += red2[i][nl];
    }
    part1[(size_t)tile_m * N + n0 + nl] = a1;
    part2[(size_t)tile_m * N + n0 + nl] = a2;
  }
}

// ----------------------------------------------------- the column sums
constexpr int RED_COLS = 32;
constexpr int RED_ROWS = 16;

// s[n] = sum over r of part[r][n], r in a fixed order: row group ty sums
// rows ty, ty + 16, ... in order, then the 16 group sums are added in order.
__global__ void __launch_bounds__(RED_COLS * RED_ROWS)
stats_reduce_kernel(const float* __restrict__ part1,
                    const float* __restrict__ part2, int m_tiles, int N,
                    float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float a1s[RED_ROWS][RED_COLS + 1];
  __shared__ float a2s[RED_ROWS][RED_COLS + 1];
  const int tx = threadIdx.x % RED_COLS;
  const int ty = threadIdx.x / RED_COLS;
  const int n = blockIdx.x * RED_COLS + tx;
  float a1 = 0.0f, a2 = 0.0f;
  if (n < N) {
    for (int r = ty; r < m_tiles; r += RED_ROWS) {
      a1 += part1[(size_t)r * N + n];
      a2 += part2[(size_t)r * N + n];
    }
  }
  a1s[ty][tx] = a1;
  a2s[ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && n < N) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int i = 0; i < RED_ROWS; ++i) {
      t1 += a1s[i][tx];
      t2 += a2s[i][tx];
    }
    s1[n] = t1;
    s2[n] = t2;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Both entries: PRO selects the prologue variant (scale and shift are then
// (K,) f32, else unused).
template <bool PRO>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, const float* c, void* y, float* part1,
           float* part2, float* s1, float* s2, int M, int N, int K, int dtype,
           void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks = (long long)m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const bool vec = aligned16(x) && aligned16(w);
  if (dtype == 1) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (vec && K % 8 == 0)
      matmul_stats_bf16_kernel<true, PRO><<<grid, THREADS, 0, st>>>(
          xb, wb, scale, shift, c, yb, part1, part2, M, N, K, n_tiles);
    else
      matmul_stats_bf16_kernel<false, PRO><<<grid, THREADS, 0, st>>>(
          xb, wb, scale, shift, c, yb, part1, part2, M, N, K, n_tiles);
  } else if (dtype == 0) {
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    auto* yf = static_cast<float*>(y);
    if (vec && K % 4 == 0)
      matmul_stats_f32_kernel<true, PRO><<<grid, THREADS, 0, st>>>(
          xf, wf, scale, shift, c, yf, part1, part2, M, N, K, n_tiles);
    else
      matmul_stats_f32_kernel<false, PRO><<<grid, THREADS, 0, st>>>(
          xf, wf, scale, shift, c, yf, part1, part2, M, N, K, n_tiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<(N + RED_COLS - 1) / RED_COLS, RED_COLS * RED_ROWS, 0,
                        st>>>(part1, part2, m_tiles, N, s1, s2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of y per block: the partial buffers hold ceil(M / this) rows of N.
int mxtt_matmul_stats_block_rows() { return BM; }

// dtype: 0 = float32, 1 = bfloat16.  part1/part2: f32 scratch of
// ceil(M / BM) * N values each.  Returns 0 or a cudaError_t code.
int mxtt_matmul_stats(const void* x, const void* w, const float* c, void* y,
                      float* part1, float* part2, float* s1, float* s2, int M,
                      int N, int K, int dtype, void* stream) {
  return launch<false>(x, w, nullptr, nullptr, c, y, part1, part2, s1, s2, M,
                       N, K, dtype, stream);
}

// K8: as mxtt_matmul_stats, of relu(x * scale + shift) rounded to x's dtype.
int mxtt_matmul_stats_prologue(const void* x, const void* w,
                               const float* scale, const float* shift,
                               const float* c, void* y, float* part1,
                               float* part2, float* s1, float* s2, int M,
                               int N, int K, int dtype, void* stream) {
  return launch<true>(x, w, scale, shift, c, y, part1, part2, s1, s2, M, N, K,
                      dtype, stream);
}

const char* mxtt_matmul_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
