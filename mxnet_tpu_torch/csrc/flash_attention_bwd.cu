// Flash-attention backward for Hopper (sm_90a), written for CUDA cores: the
// float32 route of flash_attention_bwd.  The bfloat16 route runs on the
// tensor cores, in flash_attention_bwd_sm90.cu.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _flash_attention_bwd_pallas,
// in both of its forms: the panel form (_flash_bwd_panel_kernel, T <= 2048)
// and the streamed form (_flash_bwd_kernel, T > 2048).  One pair of kernels
// covers every length by streaming tiles through shared memory.
//
// Computes, for q, k, v, dO of shape (B, T, H, D) read through their strides
// (the last dim must be contiguous) and the forward's lse and the row sums
// delta = rowsum(dO * O), both (B*H, T, 1) f32 with row bh = b*H + h:
//   P  = exp(q k^T * scale - lse)   [causal mask]      rebuilt per tile
//   dV = P^T dO
//   dP = dO V^T ;  dS = P * (dP - delta) * scale
//   dQ = dS K ;    dK = dS^T Q
// dq, dk, dv are written contiguous (B, T, H, D) in q's dtype, summed in f32.
// The (T, T) matrices never reach device memory.
//
// What cannot be carried over from the TPU: the Pallas kernels summed dK/dV
// (and, streamed, dQ) across a grid axis that the TPU runs in order.  Blocks
// on this card run in no order, so each sum has one owner instead:
//   flash_bwd_dkdv_kernel: one block owns one 64-row K/V tile, keeps its dK
//     and dV in registers and loops over the Q tiles; under causal the loop
//     starts at the diagonal tile, so fully masked tiles are never visited.
//   flash_bwd_dq_kernel: one block owns one 64-row Q tile and loops over the
//     K tiles up to the diagonal (causal) or the end.
// No atomics: the result is the same on every run.  The price is that S and
// dP are computed in both kernels, 7 tile products where the TPU did 5.
//
// What bounds it on this card: at the training shape (B=16, T=1024, H=16,
// D=64, causal) the five products of the algorithm do 10*B*H*D flops per
// live (query, key) pair, 86 GFLOP, on 8 (B, T, H, D) tensors of traffic
// (268 MB in bf16): about 320 flops per byte, just above the card's bf16
// ridge, and far above it for f32 on the CUDA cores, where the work is bound
// by arithmetic.  Here it runs as f32 FMAs on the CUDA cores (67 TFLOP/s peak),
// fed from shared memory: each thread holds a 4x4 register micro-tile of S
// and dP (16 shared loads per 32 FMAs) and a 4 x (D/16) micro-tile of its
// accumulators.  The tensor cores offer f32 only as TF32, so the f32 route
// stays on the CUDA cores.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd-<hash>.so this file
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // key rows per tile
constexpr int THREADS = 256;         // 16 x 16 threads
constexpr int S_STRIDE = BK + 4;     // P / dS tile row stride (bank spread)

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  long long b, t, h;   // in elements; the d stride is 1
};

// Shared-memory layout, in floats.  Q and dO tiles keep row stride D (the
// products read them by row, broadcast across a half-warp); K and V rows
// are padded to D+1 so that 16 threads reading 16 different rows at one d
// hit 16 banks.
template <int D>
struct Smem {
  static constexpr int kQ = BQ * D;
  static constexpr int kKV = BK * (D + 1);
  static constexpr int kP = BQ * S_STRIDE;
  static constexpr int kRows = 2 * BQ;   // lse, delta per query row
  // dK/dV kernel: Q, dO, K, V, P, dS, rows
  static constexpr size_t dkdv_bytes =
      sizeof(float) * (2 * kQ + 2 * kKV + 2 * kP + kRows);
  // dQ kernel: Q, dO, K, V, dS, rows
  static constexpr size_t dq_bytes =
      sizeof(float) * (2 * kQ + 2 * kKV + kP + kRows);
};

// rows [t0, t0 + ROWS) of one (b, h) slice into shared memory with row
// stride LD, widened to f32; rows at or past seq read as 0
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int t0, int seq,
                                          int tid) {
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int t = t0 + r;
    dst[r * LD + d] = t < seq ? to_f32(src[(long long)t * st + d]) : 0.f;
  }
}

// lse and delta of query rows [q0, q0 + BQ) into shared memory
__device__ __forceinline__ void load_rows(float* lse_s, float* del_s,
                                          const float* lse,
                                          const float* delta, long long bh,
                                          int q0, int seq, int tid) {
  if (tid < BQ) {
    const int t = q0 + tid;
    lse_s[tid] = t < seq ? lse[bh * seq + t] : 0.f;
    del_s[tid] = t < seq ? delta[bh * seq + t] : 0.f;
  }
}

// The thread's 4x4 micro-tiles of S = Q K^T (unscaled) and dP = dO V^T:
// query rows ty + 16i, key rows tx + 16j of the current tiles.
template <int D>
__device__ __forceinline__ void tile_products(const float* qs,
                                              const float* dos,
                                              const float* ks,
                                              const float* vs, int ty, int tx,
                                              float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * D + d];
      ov[i] = dos[(ty + 16 * i) * D + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
      vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P and dS of the thread's micro-tile, in place of S and dP.  A masked
// entry (key past the diagonal, or a row or key past seq) gets P = 0 from
// the branch, never from exp(-inf), so no NaN can arise.
__device__ __forceinline__ void tile_p_ds(float s[4][4], float dp[4][4],
                                          const float* lse_s,
                                          const float* del_s, int q0, int k0,
                                          int ty, int tx, int seq, int causal,
                                          float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qt = q0 + r;
    const float lse_r = lse_s[r];
    const float del_r = del_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kt = k0 + tx + 16 * j;
      const bool live = qt < seq && kt < seq && (!causal || kt <= qt);
      const float p = live ? expf(s[i][j] * scale - lse_r) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - del_r) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int seq, int heads, Strides qs_,
                      Strides ks_, Strides vs_, Strides os_, float scale,
                      int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int NJ = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + Smem<D>::kQ;
  float* ks = dos + Smem<D>::kQ;
  float* vs = ks + Smem<D>::kKV;
  float* ps = vs + Smem<D>::kKV;
  float* dss = ps + Smem<D>::kP;
  float* lse_s = dss + Smem<D>::kP;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const T* ob = dout + b * os_.b + h * os_.h;

  load_tile<T, D, D + 1, BK>(ks, kb, ks_.t, k0, seq, tid);
  load_tile<T, D, D + 1, BK>(vs, vb, vs_.t, k0, seq, tid);

  float acc_dk[4][NJ], acc_dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }

  // under causal, query rows before k0 see none of this tile's keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < seq; q0 += BQ) {
    __syncthreads();   // the previous tile's reads of qs, dos, ps, dss
    load_tile<T, D, D, BQ>(qs, qb, qs_.t, q0, seq, tid);
    load_tile<T, D, D, BQ>(dos, ob, os_.t, q0, seq, tid);
    load_rows(lse_s, del_s, lse, delta, bh, q0, seq, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<D>(qs, dos, ks, vs, ty, tx, s, dp);
    tile_p_ds(s, dp, lse_s, del_s, q0, k0, ty, tx, seq, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = s[i][j];
        dss[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: key rows ty + 16i, cols tx + 16j
    const int qn = min(BQ, seq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float pv[4], dsv[4], ov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[qq * S_STRIDE + ty + 16 * i];
        dsv[i] = dss[qq * S_STRIDE + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ov[j] = dos[qq * D + tx + 16 * j];
        qv[j] = qs[qq * D + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_dv[i][j] = fmaf(pv[i], ov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t < seq) {
      const long long row = (((long long)b * seq + t) * heads + h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dk[row + tx + 16 * j] = from_f32<T>(acc_dk[i][j]);
        dv[row + tx + 16 * j] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq, int heads, Strides qs_, Strides ks_,
                    Strides vs_, Strides os_, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int NJ = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + Smem<D>::kQ;
  float* ks = dos + Smem<D>::kQ;
  float* vs = ks + Smem<D>::kKV;
  float* dss = vs + Smem<D>::kKV;
  float* lse_s = dss + Smem<D>::kP;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // under causal the last Q tiles loop longest: hand them out first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const T* ob = dout + b * os_.b + h * os_.h;

  load_tile<T, D, D, BQ>(qs, qb, qs_.t, q0, seq, tid);
  load_tile<T, D, D, BQ>(dos, ob, os_.t, q0, seq, tid);
  load_rows(lse_s, del_s, lse, delta, bh, q0, seq, tid);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // keys at or past kv_end are masked for every row of this tile
  const int q_last = min(q0 + BQ, seq) - 1;
  const int kv_end = causal ? q_last + 1 : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's reads of ks, vs, dss
    load_tile<T, D, D + 1, BK>(ks, kb, ks_.t, k0, seq, tid);
    load_tile<T, D, D + 1, BK>(vs, vb, vs_.t, k0, seq, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<D>(qs, dos, ks, vs, ty, tx, s, dp);
    tile_p_ds(s, dp, lse_s, del_s, q0, k0, ty, tx, seq, causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ += dS K: query rows ty + 16i, cols tx + 16j
    const int kn = min(BK, kv_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float dsv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * S_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t < seq) {
      const long long row = (((long long)b * seq + t) * heads + h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) dq[row + tx + 16 * j] = from_f32<T>(acc[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int batch, seq, heads;
  Strides qs, ks, vs, os;
  int causal;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid_kv((a.seq + BK - 1) / BK, a.batch * a.heads);
  const dim3 grid_q((a.seq + BQ - 1) / BQ, a.batch * a.heads);

  // above 48 KB a block's dynamic shared memory needs this opt-in; a launch
  // refused for it would never run and synchronize() would not say so
  auto kdkdv = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D>::dkdv_bytes);
  if (err != cudaSuccess) return err;
  kdkdv<<<grid_kv, THREADS, Smem<D>::dkdv_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq, a.heads,
      a.qs, a.ks, a.vs, a.os, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem<D>::dq_bytes);
  if (err != cudaSuccess) return err;
  kdq<<<grid_q, THREADS, Smem<D>::dq_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.seq, a.heads, a.qs, a.ks, a.vs, a.os,
      scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// float32 only (bfloat16 runs on flash_attention_bwd_sm90.cu).  Strides are
// in elements, in the order (batch, seq, heads) for each of q, k, v, dO.
// Launches the dK/dV kernel, then the dQ kernel, on `stream`.  Returns 0 or
// a cudaError_t code.
int mxtt_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             int batch, int seq, int heads, int head_dim,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             long long o_sb, long long o_st, long long o_sh,
                             int causal, void* stream) {
  const Args a{q,     k,     v,     dout,  lse,
               delta, dq,    dk,    dv,    batch,
               seq,   heads, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
               {v_sb, v_st, v_sh}, {o_sb, o_st, o_sh}, causal};
  return (int)dispatch_d<float>(head_dim, a,
                                static_cast<cudaStream_t>(stream));
}

const char* mxtt_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
