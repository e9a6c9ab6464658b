// Flash-attention forward for Hopper (sm_90a), written for CUDA cores: the
// float32 route of flash_attention_fwd.  The bfloat16 route runs on the
// tensor cores, in flash_attention_fwd_sm90.cu.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _flash_attention_fwd_pallas,
// in both of its forms: the panel form (_flash_fwd_panel_kernel, T <= 2048)
// and the streamed form (_flash_fwd_kernel, T > 2048).  The split between the
// two was a matter of the TPU's VMEM budget; here one kernel covers every
// length by streaming K/V through shared memory.
//
// Computes, for q, k, v of shape (B, T, H, D) read through their strides
// (the last dim must be contiguous):
//   o   = softmax(q k^T / sqrt(D) [causal mask]) v     (B, T, H, D), q's dtype
//   lse = m + log(l) per query row                      (B*H, T, 1) f32,
//         row bh = b*H + h: the layout of _fold_heads, which the backward
//         kernel reads to rebuild P without a second softmax pass.
//
// What bounds it on this card: at the serving shape (B=4, T=1024, H=16,
// D=64) the two products do 4*B*H*T^2*D flops (half of it under causal) on
// ~17 MB of f32 inputs, hundreds of flops per byte, so the work is bound by
// arithmetic, not by device memory.  This kernel does that arithmetic as f32
// FMAs on the CUDA cores (67 TFLOP/s peak) and, inside each block, by the
// rate at which shared memory feeds those FMAs.
//
// What the design does about it: each block owns a 64-row Q tile and keeps
// it in shared memory; K/V tiles of 64 rows are staged once per block and
// every thread computes a 4x4 register micro-tile of S = Q K^T (8 shared
// loads per 16 FMAs), then a 4 x (D/16) micro-tile of the running output
// acc += P V.  The score tile never leaves shared memory, the running max m
// and sum l live in shared memory per row (online softmax), and under causal
// the K loop stops at the diagonal tile, which halves the work.  The tensor
// cores offer f32 only as TF32, which would change the served numbers, so
// the f32 route stays on the CUDA cores.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd-<hash>.so this file
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // key rows per staged tile
constexpr int THREADS = 256;         // 16 x 16 threads
constexpr int S_STRIDE = BK + 4;     // score-tile row stride (bank spread)

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Shared-memory layout, in floats.  K rows are padded to D+1 so that the 16
// threads of a half-warp reading 16 different K rows at one d hit 16 banks.
template <int D>
struct Smem {
  static constexpr int kQ = BQ * D;
  static constexpr int kK = BK * (D + 1);
  static constexpr int kV = BK * D;
  static constexpr int kS = BQ * S_STRIDE;
  static constexpr int kRows = 3 * BQ;   // m, l, alpha per query row
  static constexpr size_t bytes = sizeof(float) * (kQ + kK + kV + kS + kRows);
};

struct Strides {
  long long b, t, h;   // in elements; the d stride is 1
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, Strides qs_,
                 Strides ks_, Strides vs_, float scale, int causal) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int NJ = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + Smem<D>::kQ;
  float* vs = ks + Smem<D>::kK;
  float* ss = vs + Smem<D>::kV;
  float* m_s = ss + Smem<D>::kS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int t = q0 + r;
    qs[i] = t < seq ? to_f32(qb[(long long)t * qs_.t + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // keys at or past kv_end are masked for every row of this tile
  const int q_last = min(q0 + BQ, seq) - 1;
  const int kv_end = causal ? q_last + 1 : seq;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's reads of vs and ss are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D;
      const int d = i - r * D;
      const int t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < seq) {
        kv = to_f32(kb[(long long)t * ks_.t + d]);
        vv = to_f32(vb[(long long)t * vs_.t + d]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    // S = Q K^T * scale: rows ty + 16i, cols tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kc = k0 + c;
        const bool live = kc < seq && (!causal || kc <= q0 + r);
        ss[r * S_STRIDE + c] = live ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax over this tile: four neighbouring lanes share a row
    {
      const int r = tid >> 2;
      const int c4 = tid & 3;
      float* row = ss + r * S_STRIDE;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, row[c4 + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        // a row with nothing live yet has m_new = -inf: exp(-inf - -inf)
        // would be NaN, and its p is 0
        const float p =
            m_new == -INFINITY ? 0.f : expf(row[c4 + 4 * j] - m_new);
        row[c4 + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (c4 == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16i, cols tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
    const int kn = min(BK, kv_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * S_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t < seq) {
      const float inv = 1.f / l_s[r];
      T* orow = o + (((long long)b * seq + t) * heads + h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
  if (tid < BQ && q0 + tid < seq)
    lse[(long long)bh * seq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads, Strides qs_,
                   Strides ks_, Strides vs_, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  // above 48 KB a block's dynamic shared memory needs this opt-in; a launch
  // refused for it would never run and synchronize() would not say so
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, batch * heads);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, heads, qs_, ks_,
      vs_, 1.0f / sqrtf((float)D), causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, float* lse, int batch, int seq, int heads,
                       Strides qs_, Strides ks_, Strides vs_, int causal,
                       cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch, seq, heads, qs_, ks_, vs_,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, seq, heads, qs_, ks_, vs_,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, seq, heads, qs_, ks_, vs_,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// float32 only (bfloat16 runs on flash_attention_fwd_sm90.cu).  Returns 0
// or a cudaError_t code.
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int batch, int seq,
                             int heads, int head_dim, long long q_sb,
                             long long q_st, long long q_sh, long long k_sb,
                             long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, int causal,
                             void* stream) {
  const Strides qs_{q_sb, q_st, q_sh}, ks_{k_sb, k_st, k_sh},
      vs_{v_sb, v_st, v_sh};
  return (int)dispatch_d<float>(head_dim, q, k, v, o, lse, batch, seq, heads,
                                qs_, ks_, vs_, causal,
                                static_cast<cudaStream_t>(stream));
}

const char* mxtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
