// Flash-attention backward for Hopper (sm_90a) on the tensor cores, in f32:
// the float32 route of flash_attention_bwd.  Its products run as split TF32
// (3xTF32, tf32_common.cuh), which keeps f32's accuracy; the bfloat16 route
// runs on wgmma, in flash_attention_bwd_sm90.cu.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _flash_attention_bwd_pallas
// (pallas_call at :486, the panel form, and :499, the streamed form, for
// T > 2048).  One pair of kernels covers every length.
//
// Computes, for f32 q, k, v, dO of shape (B, T, H, D), D in {32, 64, 128},
// any T >= 1, read through their strides (last dim contiguous, base and
// strides 16-byte aligned, as TMA needs), and the forward's lse and the row
// sums delta = rowsum(dO * O), both (B*H, T, 1) f32 with row bh = b*H + h:
//   P  = exp(q k^T * scale - lse)   [causal mask]      rebuilt per tile
//   dV = P^T dO
//   dP = dO V^T ;  dS = P * (dP - delta) * scale
//   dQ = dS K ;    dK = dS^T Q
// dq, dk, dv are written contiguous (B, T, H, D) in f32.  The (T, T)
// matrices never reach device memory.
//
// What cannot be carried over from the TPU: the Pallas kernels summed dK/dV
// (and, streamed, dQ) across a grid axis that the TPU runs in order.  Blocks
// on this card run in no order, so each sum has one owner instead:
//   flash_bwd_dkdv_tf32: a block owns BLOCK keys and loops over the TILE-row
//     query tiles, from the diagonal under causal:
//       S^T  = K Q^T ;  P^T = exp2(S^T scale log2e - lse log2e)
//       dV  += P^T dO
//       dP^T = V dO^T ;  dS^T = P^T (dP^T - delta) scale
//       dK  += dS^T Q
//   flash_bwd_dq_tf32: a block owns BLOCK query rows and loops over the
//     TILE-key tiles up to the diagonal (causal) or the end:
//       S = Q K^T, P ;  dP = dO V^T ;  dS ;  dQ += dS K
// No atomics: the result is the same on every run.  The price is that S and
// dP are computed in both kernels, 7 products where the algorithm needs 5.
//
// What bounds it on this card: at the f32 train check's shape (B=1, T=1024,
// H=16, D=64, causal) and the kernels phase's (B=4) the five products of
// the algorithm do 10*B*H*D flops per live (query, key) pair, on 8 (B, T, H,
// D) f32 tensors of traffic: some 160 flops a byte, so the bound is
// arithmetic: f32 FMAs on the CUDA cores (67 TFLOP/s, the design of earlier
// versions of this file), or three TF32 products on the tensor cores (495
// TFLOP/s), 2.5x less time.
//
// What the design does about it: all 7 products are mma.sync m16n8k8 in
// 3xTF32; each warp owns 16 rows of the block (4 warps, BLOCK = 64).  The
// block's own tiles come in once by TMA, and the tiles its loop walks
// (Q, dO and the lse and delta rows in the dK/dV pass; K and V in the dQ
// pass) stream through a ring of STAGES stages with full and empty
// mbarriers.  Operands are split into hi and lo as their fragments are read
// from the swizzled tiles; P^T and dS^T (P and dS) stay in registers and
// are the A operands of the next products straight from the accumulator,
// the contraction index permuted to match (mma_pv in tf32_common.cuh).
// The gradients are sums over every tile of the loop, thousands of
// products long; the tensor cores' accumulator adds with truncation, and
// summed in it dK and dV drifted to 1.1e-5 of their norm at T=1024 and
// 4.4e-5 at T=4096 on the H100.  So each tile's share is summed in a zeroed
// accumulator and added to the gradient by the CUDA cores, rounded to
// nearest (mma_pv_add).  Registers: the dK/dV pass holds dK and dV (D/2
// registers a thread each), S^T and dP^T (TILE/4 each) and a tile's partial
// sum; at D=128 the partial sum covers half the columns at a time, so that
// these and the fragments fit 255 registers without spilling.
// -Xptxas -v gives the counts (PERF.md).
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd-<hash>.so this file
#include "tf32_common.cuh"

namespace {

using namespace tf32;
using sm90::align1024;
using sm90::encode_f32_1d;
using sm90::exp2_approx;
using sm90::Strides;
using sm90::tma_load_1d;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 2;
constexpr int BLOCK = WARPS * 16;   // rows a block owns
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DefaultTile {
  // rows a streamed tile: 32 ran the backward 8% faster than 64 at D=64 on
  // the H100 (two blocks an SM either way, by registers)
  static constexpr int TILE = 32;
};

// The streamed tiles a caller may ask for (the autotuner's candidates): 32
// or 64 rows at D = 32 and 64; at D = 128 only the built-in 32, since
// 64-row stages (two 32 KB tiles) leave two blocks an SM no room in shared
// memory.
template <int D, int TILE_>
struct Cfg {
  static constexpr int TILE = TILE_;
  // n-tiles of a gradient summed at a time before it is added (mma_pv_add):
  // at D=128 half the columns, so the partial sum is 32 registers
  static constexpr int NCH = D == 128 ? 8 : D / 8;
  using OT = TileF32<D, BLOCK>;   // the block's own tiles
  using ST = TileF32<D, TILE>;    // a streamed tile
  static constexpr int STAGE_BYTES = 2 * ST::BYTES;
  // lse and delta rows of a tile come by a 1-d TMA box, which must start on
  // 16 bytes in device memory: a box of ROWS_BOX values starts at the first
  // row rounded down to a multiple of 4, in a slot of ROWS_SLOT values
  // (128-byte aligned)
  static constexpr int ROWS_BOX = TILE + 4;
  static constexpr int ROWS_SLOT = TILE + 32;
  // own tiles, the stages of two streamed tiles, then (dK/dV pass) per
  // stage a slot of lse and a slot of delta values
  static constexpr size_t SMEM = 1024 + 2 * OT::BYTES +
                                 STAGES * STAGE_BYTES +
                                 STAGES * 2 * ROWS_SLOT * sizeof(float);
};

struct Params {
  const float* lse;
  const float* delta;
  float* g0;   // dk (dK/dV pass) or dq (dQ pass)
  float* g1;   // dv (dK/dV pass)
  int seq, heads, causal;
  float scale, scale_log2;
};

// stores a warp's 16 x D accumulator, rows [r0, r0 + 16), as rows of a
// contiguous (B, T, H, D) f32 tensor; rows at or past seq are skipped
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[1][D / 8][4],
                                           int b, int h, int r0,
                                           const Lane& ln, const Params& p) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + ln.g + 8 * r;
    if (t >= p.seq) continue;
    float* row = out + (((long long)b * p.seq + t) * p.heads + h) * D +
                 2 * ln.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[0][n][2 * r], acc[0][n][2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[1][N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[0][n][e] = 0.f;
}

template <int D, int TILE_>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dkdv_tf32(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_delta, Params p) {
  using C = Cfg<D, TILE_>;
  using OT = typename C::OT;
  using ST = typename C::ST;
  constexpr int TILE = C::TILE;
  constexpr int NT = TILE / 8;

  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring<STAGES, THREADS> ring;
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + OT::BYTES;
  uint8_t* stages = sv + OT::BYTES;
  float* rows = reinterpret_cast<float*>(stages + STAGES * C::STAGE_BYTES);

  const int tid = threadIdx.x;
  // under causal the first key tiles loop longest and come first already
  const int k0 = blockIdx.x * BLOCK;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int j0 = p.causal ? k0 / TILE : 0;
  const int n_u = (p.seq + TILE - 1) / TILE - j0;   // tiles the loop visits

  // tile u (queries [(j0 + u) TILE, + TILE)): Q, dO, lse, delta.  lse and
  // delta are flat (B*H*T) arrays: rows past T read the next head's values
  // (or zeros at the end), and are masked below
  auto load = [&](int u, int s) {
    const int t0 = (j0 + u) * TILE;
    uint8_t* st = stages + s * C::STAGE_BYTES;
    float* rs = rows + s * 2 * C::ROWS_SLOT;
    mbar_expect_tx(&ring.full[s],
                   C::STAGE_BYTES + 2 * C::ROWS_BOX * sizeof(float));
    ST::template load<TILE>(st, &tm_q, &ring.full[s], h, t0, b);
    ST::template load<TILE>(st + ST::BYTES, &tm_do, &ring.full[s], h, t0, b);
    const int x0 = (bh * p.seq + t0) & ~3;
    tma_load_1d(rs, &tm_lse, &ring.full[s], x0);
    tma_load_1d(rs + C::ROWS_SLOT, &tm_delta, &ring.full[s], x0);
  };
  if (tid == 0) {
    ring.init();
    mbar_expect_tx(&ring.own, 2 * OT::BYTES);
    OT::template load<TILE>(sk, &tm_k, &ring.own, h, k0, b);
    OT::template load<TILE>(sv, &tm_v, &ring.own, h, k0, b);
    for (int u = 0; u < min(STAGES, n_u); ++u) load(u, u);
  }
  __syncthreads();

  // the warp's keys [wk0, wk0 + 16)
  const int warp = tid / 32;
  const Lane ln(tid % 32);
  const int wr0 = warp * 16;
  const int wk0 = k0 + wr0;

  float dk[1][D / 8][4], dv[1][D / 8][4];
  zero(dk);
  zero(dv);

  mbar_wait(&ring.own, 0);
  __syncwarp();
  for (int u = 0; u < n_u; ++u) {
    const int q0 = (j0 + u) * TILE;
    ring.wait_full(u);
    const uint8_t* sq = stages + (u % STAGES) * C::STAGE_BYTES;
    const uint8_t* sdo = sq + ST::BYTES;
    // under causal a query tile wholly before the warp's first key adds
    // nothing
    if (!p.causal || q0 + TILE - 1 >= wk0) {
      const float* lse_s =
          rows + (u % STAGES) * 2 * C::ROWS_SLOT + ((bh * p.seq + q0) & 3);
      const float* del_s = lse_s + C::ROWS_SLOT;
      float st[1][NT][4], dpt[1][NT][4];
      zero(st);
      zero(dpt);
      mma_nt<D, 1, TILE, OT, ST>(st, sk, wr0, sq, ln);    // S^T = K Q^T
      mma_nt<D, 1, TILE, OT, ST>(dpt, sv, wr0, sdo, ln);  // dP^T = V dO^T
      // P^T and dS^T in place: rows are keys, columns queries
      const bool edge =
          (p.causal && q0 < wk0 + 15) || q0 + TILE > p.seq;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * jn + 2 * ln.t + (e & 1);
          float pt = exp2_approx(
              fmaf(st[0][jn][e], p.scale_log2, -lse_s[c] * LOG2E));
          if (edge) {
            const int qrow = q0 + c;
            const int key = wk0 + ln.g + 8 * (e >> 1);
            if (qrow >= p.seq || (p.causal && qrow < key)) pt = 0.f;
          }
          st[0][jn][e] = pt;
          dpt[0][jn][e] = pt * (dpt[0][jn][e] - del_s[c]) * p.scale;
        }
      mma_pv_add<D, 1, TILE, ST, C::NCH>(dv, st, sdo, ln);   // dV += P^T dO
      mma_pv_add<D, 1, TILE, ST, C::NCH>(dk, dpt, sq, ln);   // dK += dS^T Q
    }
    ring.release(u, n_u, load);
  }

  store_rows<D>(p.g0, dk, b, h, wk0, ln, p);
  store_rows<D>(p.g1, dv, b, h, wk0, ln, p);
}

template <int D, int TILE_>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dq_tf32(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, Params p) {
  using C = Cfg<D, TILE_>;
  using OT = typename C::OT;
  using ST = typename C::ST;
  constexpr int TILE = C::TILE;
  constexpr int NT = TILE / 8;

  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring<STAGES, THREADS> ring;
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + OT::BYTES;
  uint8_t* stages = sdo + OT::BYTES;

  const int tid = threadIdx.x;
  // under causal the last query tiles loop longest: hand them out first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BLOCK;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int kv_end = p.causal ? min(q0 + BLOCK, p.seq) : p.seq;
  const int n_j = (kv_end + TILE - 1) / TILE;

  // tile j (keys [j TILE, + TILE)): K, V
  auto load = [&](int j, int s) {
    uint8_t* st = stages + s * C::STAGE_BYTES;
    mbar_expect_tx(&ring.full[s], C::STAGE_BYTES);
    ST::template load<TILE>(st, &tm_k, &ring.full[s], h, j * TILE, b);
    ST::template load<TILE>(st + ST::BYTES, &tm_v, &ring.full[s], h,
                            j * TILE, b);
  };
  if (tid == 0) {
    ring.init();
    mbar_expect_tx(&ring.own, 2 * OT::BYTES);
    OT::template load<TILE>(sq, &tm_q, &ring.own, h, q0, b);
    OT::template load<TILE>(sdo, &tm_do, &ring.own, h, q0, b);
    for (int j = 0; j < min(STAGES, n_j); ++j) load(j, j);
  }
  __syncthreads();

  // the warp's query rows [wq0, wq0 + 16)
  const int warp = tid / 32;
  const Lane ln(tid % 32);
  const int wr0 = warp * 16;
  const int wq0 = q0 + wr0;

  // lse (log2 units) and delta of this thread's two rows
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = wq0 + ln.g + 8 * r;
    const long long at = (long long)bh * p.seq + t;
    lse2[r] = t < p.seq ? p.lse[at] * LOG2E : 0.f;
    del[r] = t < p.seq ? p.delta[at] : 0.f;
  }

  float dq[1][D / 8][4];
  zero(dq);

  mbar_wait(&ring.own, 0);
  __syncwarp();
  for (int j = 0; j < n_j; ++j) {
    const int k0 = j * TILE;
    ring.wait_full(j);
    const uint8_t* sk = stages + (j % STAGES) * C::STAGE_BYTES;
    const uint8_t* sv = sk + ST::BYTES;
    // under causal a key tile wholly past the warp's last row adds nothing
    if (!p.causal || k0 <= wq0 + 15) {
      float s[1][NT][4], dp[1][NT][4];
      zero(s);
      zero(dp);
      mma_nt<D, 1, TILE, OT, ST>(s, sq, wr0, sk, ln);     // S = Q K^T
      mma_nt<D, 1, TILE, OT, ST>(dp, sdo, wr0, sv, ln);   // dP = dO V^T
      const bool edge = (p.causal && k0 + TILE - 1 > wq0) || k0 + TILE > p.seq;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pv = exp2_approx(fmaf(s[0][jn][e], p.scale_log2, -lse2[r]));
          if (edge) {
            const int key = k0 + 8 * jn + 2 * ln.t + (e & 1);
            const int row = wq0 + ln.g + 8 * r;
            if (key >= p.seq || (p.causal && key > row)) pv = 0.f;
          }
          dp[0][jn][e] = pv * (dp[0][jn][e] - del[r]) * p.scale;
        }
      mma_pv_add<D, 1, TILE, ST, C::NCH>(dq, dp, sk, ln);   // dQ += dS K
    }
    ring.release(j, n_j, load);
  }

  store_rows<D>(p.g0, dq, b, h, wq0, ln, p);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int batch, seq, heads;
  Strides qs, ks, vs, os;
  int causal;
};

template <int D, int TILE>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<D, TILE>;
  using ST = typename C::ST;
  // own tiles load as BLOCK / TILE boxes of TILE rows: one map a tensor
  CUtensorMap m_q, m_do, m_k, m_v, m_lse, m_del;
  const long long n_rows = (long long)a.batch * a.heads * a.seq;
  int rc = sm90::encode_tile_map<ST>(&m_q, a.q, a.batch, a.seq, a.heads,
                                     a.qs, C::TILE);
  if (rc == 0)
    rc = sm90::encode_tile_map<ST>(&m_do, a.dout, a.batch, a.seq, a.heads,
                                   a.os, C::TILE);
  if (rc == 0)
    rc = sm90::encode_tile_map<ST>(&m_k, a.k, a.batch, a.seq, a.heads, a.ks,
                                   C::TILE);
  if (rc == 0)
    rc = sm90::encode_tile_map<ST>(&m_v, a.v, a.batch, a.seq, a.heads, a.vs,
                                   C::TILE);
  if (rc == 0) rc = encode_f32_1d(&m_lse, a.lse, n_rows, C::ROWS_BOX);
  if (rc == 0) rc = encode_f32_1d(&m_del, a.delta, n_rows, C::ROWS_BOX);
  if (rc != 0) return rc;

  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((a.seq + BLOCK - 1) / BLOCK, a.batch * a.heads);

  // above 48 KB a block's dynamic shared memory needs this opt-in; a launch
  // refused for it would never run and synchronize() would not say so
  auto kdkdv = flash_bwd_dkdv_tf32<D, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Params pkv{a.lse,  a.delta, static_cast<float*>(a.dk),
                   static_cast<float*>(a.dv), a.seq, a.heads, a.causal,
                   scale, scale * LOG2E};
  kdkdv<<<grid, THREADS, C::SMEM, stream>>>(m_q, m_k, m_v, m_do, m_lse,
                                            m_del, pkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kdq = flash_bwd_dq_tf32<D, TILE>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Params pq{a.lse, a.delta, static_cast<float*>(a.dq), nullptr, a.seq,
                  a.heads, a.causal, scale, scale * LOG2E};
  kdq<<<grid, THREADS, C::SMEM, stream>>>(m_q, m_k, m_v, m_do, pq);
  return (int)cudaGetLastError();
}

// The launch at streamed tile `tile`: 0 is DefaultTile's, 64 is the other
// at D <= 64; any other value is refused.
template <int D>
int launch_tile(int tile, const Args& a, cudaStream_t st) {
  constexpr int DEF = DefaultTile<D>::TILE;
  if (tile == 0 || tile == DEF) return launch<D, DEF>(a, st);
  if constexpr (D <= 64) {
    if (tile == 32) return launch<D, 32>(a, st);
    if (tile == 64) return launch<D, 64>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// float32 only (bfloat16 runs on flash_attention_bwd_sm90.cu).  Strides are
// in elements, in the order (batch, seq, heads) for each of q, k, v, dO.
// Launches the dK/dV kernel, then the dQ kernel, on `stream`.  tile: rows a
// streamed tile, 0 for the built-in choice (DefaultTile), else 32 or 64 at
// D <= 64.  Returns 0, a cudaError_t code, or an sm90 encode error (see
// mxtt_bwd_error_string).
int mxtt_flash_attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             int batch, int seq, int heads, int head_dim,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             long long o_sb, long long o_st, long long o_sh,
                             int causal, int tile, void* stream) {
  const Args a{q,     k,     v,     dout,  lse,
               delta, dq,    dk,    dv,    batch,
               seq,   heads, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
               {v_sb, v_st, v_sh}, {o_sb, o_st, o_sh}, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_tile<32>(tile, a, st);
    case 64:
      return launch_tile<64>(tile, a, st);
    case 128:
      return launch_tile<128>(tile, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxtt_bwd_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
