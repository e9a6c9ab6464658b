// The flash-attention backward's row sums, delta = rowsum(dO * O), in one
// pass: the input of both backward routes (flash_attention_bwd.cu for f32,
// flash_attention_bwd_sm90.cu for bf16).
//
// Replaces: the delta of mxnet_tpu/ops/pallas_kernels.py,
// _flash_attention_bwd_pallas (:468-470), which the TPU code computes with
// jnp outside its pallas_call.  The port did it as four PyTorch launches
// over an f32 copy of dO.
//
// Computes, for dO and O of shape (B, T, H, D), D in {32, 64, 128}, both f32
// or both bf16, read through their strides (last dim contiguous, base and
// strides 16-byte aligned, as the backward's checks already require):
//   delta[b*H + h][t] = sum_d dO[b, t, h, d] * O[b, t, h, d]
// as (B*H, T, 1) f32, the layout of lse.  Each product is taken in f32 (a
// bf16 product is exact there), and each row is summed in a fixed order:
// lanes<T, D>() threads take neighbouring runs of at least 16 bytes each,
// and their partial sums meet in a fixed shuffle tree.  Two launches give
// the same bits.
//
// What bounds it on this card: it reads 2 B*T*H*D values and writes B*H*T
// f32 values, one flop pair a value read: bound by bytes (HBM 3.35 TB/s).
// Each thread reads its values with 16-byte loads, and neighbouring rows
// (heads, then positions) lie side by side in memory, so a warp's reads
// are whole sectors.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_delta-<hash>.so this file
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// threads a row: 8, or fewer where a row holds less than 8 x 16 bytes
template <typename T, int D>
__host__ __device__ constexpr int lanes() {
  return D * (int)sizeof(T) / 16 < 8 ? D * (int)sizeof(T) / 16 : 8;
}

struct Strides {
  long long b, t, h;   // in elements; the d stride is 1
};

// the products of N values (16-byte aligned runs) summed in order into acc
template <int N>
__device__ __forceinline__ float dot_run(const float* x, const float* y,
                                         float acc) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + i);
    const float4 c = *reinterpret_cast<const float4*>(y + i);
    acc = fmaf(a.x, c.x, acc);
    acc = fmaf(a.y, c.y, acc);
    acc = fmaf(a.z, c.z, acc);
    acc = fmaf(a.w, c.w, acc);
  }
  return acc;
}

template <int N>
__device__ __forceinline__ float dot_run(const __nv_bfloat16* x,
                                         const __nv_bfloat16* y, float acc) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(x + i);
    const uint4 c = *reinterpret_cast<const uint4*>(y + i);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 af = __bfloat1622float2(a2[e]);
      const float2 cf = __bfloat1622float2(c2[e]);
      acc = fmaf(af.x, cf.x, acc);
      acc = fmaf(af.y, cf.y, acc);
    }
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                   float* __restrict__ delta, long long n_rows, int seq,
                   int heads, Strides ds, Strides os) {
  constexpr int LANES = lanes<T, D>();
  constexpr int PER = D / LANES;   // values a thread
  const long long row =
      (long long)blockIdx.x * (THREADS / LANES) + threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  float acc = 0.f;
  long long b = 0, t = 0, h = 0;
  if (row < n_rows) {   // rows in memory order: (b, t, h)
    h = row % heads;
    const long long bt = row / heads;
    t = bt % seq;
    b = bt / seq;
    acc = dot_run<PER>(dout + b * ds.b + t * ds.t + h * ds.h + sub * PER,
                       o + b * os.b + t * os.t + h * os.h + sub * PER, 0.f);
  }
  // a fixed tree over the row's LANES threads (every lane takes part)
#pragma unroll
  for (int w = LANES / 2; w >= 1; w /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (row < n_rows && sub == 0) delta[(b * heads + h) * seq + t] = acc;
}

template <typename T, int D>
cudaError_t launch(const void* dout, const void* o, float* delta, int batch,
                   int seq, int heads, Strides ds, Strides os,
                   cudaStream_t stream) {
  const long long n_rows = (long long)batch * seq * heads;
  const long long rows_a_block = THREADS / lanes<T, D>();
  const long long blocks = (n_rows + rows_a_block - 1) / rows_a_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_delta_kernel<T, D><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(o), delta, n_rows,
      seq, heads, ds, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* dout, const void* o, float* delta,
                       int batch, int seq, int heads, Strides ds, Strides os,
                       cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(dout, o, delta, batch, seq, heads, ds, os, stream);
    case 64:
      return launch<T, 64>(dout, o, delta, batch, seq, heads, ds, os, stream);
    case 128:
      return launch<T, 128>(dout, o, delta, batch, seq, heads, ds, os,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  Strides are in elements, (batch, seq,
// heads) for each of dO and O.  Returns 0 or a cudaError_t code.
int mxtt_flash_attention_delta(const void* dout, const void* o, float* delta,
                               int batch, int seq, int heads, int head_dim,
                               long long d_sb, long long d_st, long long d_sh,
                               long long o_sb, long long o_st, long long o_sh,
                               int dtype, void* stream) {
  const Strides ds{d_sb, d_st, d_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(head_dim, dout, o, delta, batch, seq, heads,
                                  ds, os, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(head_dim, dout, o, delta, batch,
                                          seq, heads, ds, os, st);
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
