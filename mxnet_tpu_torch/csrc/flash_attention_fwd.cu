// Flash-attention forward for Hopper (sm_90a) on the tensor cores, in f32:
// the float32 route of flash_attention_fwd.  Its products run as split TF32
// (3xTF32, tf32_common.cuh), which keeps f32's accuracy; the bfloat16 route
// runs on wgmma, in flash_attention_fwd_sm90.cu.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _flash_attention_fwd_pallas
// (pallas_call at :283, the panel form, and :305, the streamed form, for
// T > 2048).  The split between the two was a matter of the TPU's VMEM
// budget; one kernel here covers every length by streaming K/V tiles.
//
// Computes, for f32 q, k, v of shape (B, T, H, D), D in {32, 64, 128}, any
// T >= 1, read through their strides (last dim contiguous, base and strides
// 16-byte aligned, as TMA needs):
//   o   = softmax(q k^T / sqrt(D) [causal mask]) v     (B, T, H, D) f32,
//         contiguous
//   lse = m + log(l) per query row                      (B*H, T, 1) f32,
//         row bh = b*H + h: the layout of _fold_heads, which the backward
//         reads to rebuild P without a second softmax pass.
//
// What bounds it on this card: at the serving shape (B=4, T=1024, H=16,
// D=64, causal) the two products do 4*B*H*D flops per live (query, key)
// pair, 8.6 GFLOP, on 4 (B, T, H, D) f32 tensors (67 MB): over 100 flops a
// byte, so the bound is arithmetic.  On the CUDA cores (67 TFLOP/s of f32
// FMAs, the design of earlier versions of this file) that is 0.128 ms; as
// three TF32 products on the tensor cores (495 TFLOP/s) it is 0.052 ms.
//
// What the design does about it: a block of WARPS warps owns BM = 16 MT
// WARPS query rows (MT m16 tiles a warp).  Thread 0 brings the Q tile in by
// TMA (SWIZZLE_128B) and streams the K and V tiles of BN keys through a
// ring of STAGES stages with full and empty mbarriers, so the next tiles
// load while this one is used.  Each warp computes S = Q K^T for its rows
// with mma.sync m16n8k8 in 3xTF32, splitting each fragment into hi and lo
// as it reads it from shared memory, keeps the online softmax (row max
// across the quad by __shfl_xor_sync, running sum) and O in registers, and
// feeds P back as the A operand of O += P V straight from S's accumulator:
// the m16n8k8 accumulator layout is not the A layout, and instead of
// moving P the contraction index of P V is permuted so that each thread's
// accumulator is its A fragment (mma_pv in tf32_common.cuh).  No score tile
// in shared memory.  Under causal the K loop stops at the diagonal, a
// warp skips the tiles that lie wholly past its rows, and the blocks take
// the query tiles heaviest first.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd-<hash>.so this file
#include "tf32_common.cuh"

namespace {

using namespace tf32;
using sm90::align1024;
using sm90::exp2_approx;
using sm90::Strides;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct DefaultTile {
  // m16 tiles a warp: two at D <= 64 share each K and V fragment's split
  // between 32 rows; at D=128 O alone is 64 registers a tile
  static constexpr int MT = D == 128 ? 1 : 2;
  static constexpr int BN = D == 128 ? 32 : 64;    // keys a tile
};

// The tiles a caller may ask for (the autotuner's candidates): at D = 32
// and 64, 64 or 128 query rows a block (MT 1 or 2) by 32 or 64 keys a
// tile; at D = 128 only the built-in 64 by 32, since a 64-key stage there
// (two 32 KB tiles) leaves two blocks an SM no room in shared memory.
template <int D, int MT_, int BN_>
struct Cfg {
  static constexpr int MT = MT_;
  static constexpr int BM = WARPS * 16 * MT;       // query rows a block
  static constexpr int BN = BN_;                   // keys a tile
  static constexpr int STAGES = 2;
  using QT = TileF32<D, BM>;
  using KT = TileF32<D, BN>;
  static constexpr int STAGE_BYTES = 2 * KT::BYTES;   // K then V
  static constexpr size_t SMEM = 1024 + QT::BYTES + STAGES * STAGE_BYTES;
  // two blocks an SM fit the shared memory at every D and leave ptxas 255
  // registers a thread
  static constexpr int MIN_BLOCKS = 2;
};

struct Params {
  float* o;
  float* lse;
  int seq, heads, causal;
  float scale_log2;   // log2(e) / sqrt(D)
};

template <int D, int MT_, int BN_>
__global__ void __launch_bounds__(THREADS, Cfg<D, MT_, BN_>::MIN_BLOCKS)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, Params p) {
  using C = Cfg<D, MT_, BN_>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int MT = C::MT;
  constexpr int BN = C::BN;
  constexpr int NT = BN / 8;   // n-tiles of S
  constexpr int DT = D / 8;    // n-tiles of O

  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring<C::STAGES, THREADS> ring;
  uint8_t* sq = align1024(smem_raw);
  uint8_t* stages = sq + QT::BYTES;

  const int tid = threadIdx.x;
  // under causal the last query tiles loop longest: hand them out first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * C::BM;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int kv_end = p.causal ? min(q0 + C::BM, p.seq) : p.seq;
  const int n_j = (kv_end + BN - 1) / BN;

  // tile j (keys [j BN, + BN)): K, V
  auto load = [&](int j, int s) {
    uint8_t* st = stages + s * C::STAGE_BYTES;
    mbar_expect_tx(&ring.full[s], C::STAGE_BYTES);
    KT::template load<BN>(st, &tm_k, &ring.full[s], h, j * BN, b);
    KT::template load<BN>(st + KT::BYTES, &tm_v, &ring.full[s], h, j * BN,
                          b);
  };
  if (tid == 0) {
    ring.init();
    mbar_expect_tx(&ring.own, QT::BYTES);
    QT::template load<C::BM>(sq, &tm_q, &ring.own, h, q0, b);
    for (int j = 0; j < min(C::STAGES, n_j); ++j) load(j, j);
  }
  __syncthreads();

  const int warp = tid / 32;
  const Lane ln(tid % 32);
  const int wr0 = warp * 16 * MT;   // the warp's first row in the tile
  const int wq0 = q0 + wr0;         // and its query
  const int wq_last = wq0 + 16 * MT - 1;

  float o[MT][DT][4];
  float m[MT][2], l[MT][2];   // rows g and g + 8 of each m-tile; m in
                              // log2 units, l this thread's part of the sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  mbar_wait(&ring.own, 0);
  __syncwarp();
  for (int j = 0; j < n_j; ++j) {
    const int k0 = j * BN;
    ring.wait_full(j);
    const uint8_t* sk = stages + (j % C::STAGES) * C::STAGE_BYTES;
    // under causal a tile wholly past the warp's last row adds nothing
    if (!p.causal || k0 <= wq_last) {
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][jn][e] = 0.f;
      mma_nt<D, MT, BN, QT, KT>(s, sq, wr0, sk, ln);

      // mask keys past seq and, under causal, past the row
      if ((p.causal && k0 + BN - 1 > wq0) || k0 + BN > p.seq) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * jn + 2 * ln.t + (e & 1);
              const int row = wq0 + 16 * mt + ln.g + 8 * (e >> 1);
              if (key >= p.seq || (p.causal && key > row))
                s[mt][jn][e] = -INFINITY;
            }
      }
      // online softmax: the row max on the raw scores (scale > 0), p =
      // exp2(s scale log2e - m_new), the old sum and output shrink by
      // exp2(m_old - m_new)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float base[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            mx = fmaxf(mx, fmaxf(s[mt][jn][2 * r], s[mt][jn][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][r], mx * p.scale_log2);
          // a row with nothing live yet keeps m = -inf: exp2(-inf - -inf)
          // would be NaN, and its p and correction are 0
          base[r] = m_new == -INFINITY ? 0.f : m_new;
          corr[r] = exp2_approx(m[mt][r] - base[r]);
          m[mt][r] = m_new;
          l[mt][r] *= corr[r];
        }
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            s[mt][jn][e] =
                exp2_approx(fmaf(s[mt][jn][e], p.scale_log2, -base[r]));
            l[mt][r] += s[mt][jn][e];
          }
#pragma unroll
        for (int n = 0; n < DT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][n][e] *= corr[e >> 1];
      }
      mma_pv<D, MT, BN, KT>(o, s, sk + KT::BYTES, ln);
    }
    ring.release(j, n_j, load);
  }

  // o / l, lse = m ln 2 + log l
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int t = wq0 + 16 * mt + ln.g + 8 * r;
      if (t >= p.seq) continue;
      const float inv = 1.f / sum;
      float* orow = p.o + (((long long)b * p.seq + t) * p.heads + h) * D +
                    2 * ln.t;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[mt][n][2 * r] * inv, o[mt][n][2 * r + 1] * inv);
      if (ln.t == 0)
        p.lse[(long long)bh * p.seq + t] = m[mt][r] * LN2 + logf(sum);
    }
}

template <int D, int MT, int BN>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq, int heads, Strides qs, Strides ks, Strides vs,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, MT, BN>;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = sm90::encode_tile_map<typename C::QT>(&tm_q, q, batch, seq, heads,
                                                 qs, C::BM);
  if (rc == 0)
    rc = sm90::encode_tile_map<typename C::KT>(&tm_k, k, batch, seq, heads,
                                               ks, C::BN);
  if (rc == 0)
    rc = sm90::encode_tile_map<typename C::KT>(&tm_v, v, batch, seq, heads,
                                               vs, C::BN);
  if (rc != 0) return rc;
  auto kern = flash_fwd_tf32<D, MT, BN>;
  // above 48 KB a block's dynamic shared memory needs this opt-in; a launch
  // refused for it would never run and synchronize() would not say so
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Params p{static_cast<float*>(o), lse, seq, heads, causal,
                 LOG2E / sqrtf((float)D)};
  const dim3 grid((seq + C::BM - 1) / C::BM, batch * heads);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tm_q, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

// The launch at tile (block_q, block_k): 0 for either is DefaultTile's;
// a pair Cfg does not list is refused.
template <int D>
int launch_tile(int block_q, int block_k, const void* q, const void* k,
                const void* v, void* o, float* lse, int batch, int seq,
                int heads, Strides qs, Strides ks, Strides vs, int causal,
                cudaStream_t st) {
  using T = DefaultTile<D>;
  const int mt = block_q == 0 ? T::MT : block_q / (WARPS * 16);
  const int bn = block_k == 0 ? T::BN : block_k;
  if (block_q != 0 && block_q != mt * WARPS * 16)
    return (int)cudaErrorInvalidValue;
  if (mt == T::MT && bn == T::BN)
    return launch<D, T::MT, T::BN>(q, k, v, o, lse, batch, seq, heads, qs,
                                   ks, vs, causal, st);
  if constexpr (D <= 64) {
#define MXTT_FWD_TILE(M, N)                                              \
  if (mt == M && bn == N)                                                \
    return launch<D, M, N>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs, \
                           causal, st);
    MXTT_FWD_TILE(1, 32)
    MXTT_FWD_TILE(1, 64)
    MXTT_FWD_TILE(2, 32)
    MXTT_FWD_TILE(2, 64)
#undef MXTT_FWD_TILE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// float32 only (bfloat16 runs on flash_attention_fwd_sm90.cu).  Strides are
// in elements, (batch, seq, heads) for each of q, k, v.  block_q, block_k:
// query rows a block and keys a tile, 0 for the built-in choice
// (DefaultTile), else a pair Cfg lists.  Returns 0, a cudaError_t code, or
// an sm90 encode error (see mxtt_error_string).
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int batch, int seq,
                             int heads, int head_dim, long long q_sb,
                             long long q_st, long long q_sh, long long k_sb,
                             long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, int causal,
                             int block_q, int block_k, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_tile<32>(block_q, block_k, q, k, v, o, lse, batch, seq,
                             heads, qs, ks, vs, causal, st);
    case 64:
      return launch_tile<64>(block_q, block_k, q, k, v, o, lse, batch, seq,
                             heads, qs, ks, vs, causal, st);
    case 128:
      return launch_tile<128>(block_q, block_k, q, k, v, o, lse, batch, seq,
                              heads, qs, ks, vs, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxtt_error_string(int code) { return sm90::error_string(code); }

}  // extern "C"
