// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the bf16
// route of flash_attention_bwd (the f32 route stays on the CUDA-core kernels
// of flash_attention_bwd.cu).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _flash_attention_bwd_pallas
// (pallas_call at :486, the panel form, and :499, the streamed form, for
// T > 2048).  One pair of kernels covers every length.
//
// Computes, for bf16 q, k, v, dO of shape (B, T, H, D), D in {32, 64, 128},
// any T >= 1, read through their strides (last dim contiguous, base and
// strides 16-byte aligned, as TMA needs), and the forward's lse and the row
// sums delta = rowsum(dO * O), both (B*H, T, 1) f32 with row bh = b*H + h:
//   P  = exp(q k^T * scale - lse)   [causal mask]      rebuilt per tile
//   dV = P^T dO
//   dP = dO V^T ;  dS = P * (dP - delta) * scale
//   dQ = dS K ;    dK = dS^T Q
// dq, dk, dv are written contiguous (B, T, H, D) in bf16, summed in f32.
//
// Two passes and no atomics, as in the CUDA-core kernels: the result is the
// same on every run, as the TPU's ordered grid gave.
//   flash_bwd_dkdv_sm90: a block (one warpgroup) owns 64 keys and loops
//     over the 64-query tiles, from the diagonal under causal:
//       S^T  = K Q^T                (A = K, B = Q, both K-major)
//       P^T  = exp2(S^T scale log2e - lse log2e)
//       dV  += P^T dO               (A = P^T in registers, B = dO MN-major)
//       dP^T = V dO^T               (A = V, B = dO, both K-major)
//       dS^T = P^T (dP^T - delta) scale
//       dK  += dS^T Q               (A = dS^T in registers, B = Q MN-major)
//   flash_bwd_dq_sm90: a block owns 64 query rows and loops over the 64-key
//     tiles up to the diagonal (causal) or the end:
//       S = Q K^T, P ;  dP = dO V^T ;  dS ;  dQ += dS K (B = K MN-major)
// Every product is a wgmma (4 + 3 = 7 where the algorithm needs 5: S and dP
// are computed in both passes).  P^T and dS^T (P and dS) stay in registers,
// rounded to bf16 as the A operand of the next product.
//
// What bounds it on this card: at the training shape (B=16, T=1024, H=16,
// D=64, causal) the five products of the algorithm do 10*B*H*D flops per
// live pair, 86 GFLOP, on 8 (B, T, H, D) bf16 tensors (268 MB): about 320
// flops per byte, just above the bf16 ridge of 295, so the bound is the
// tensor cores (0.087 ms at 989 TFLOP/s).  The CUDA-core kernels this
// replaces ran their FMAs at 67 TFLOP/s peak.
//
// What the design does about it: the tiles a loop walks (Q, dO, and the lse
// and delta rows, in the dK/dV pass; K and V in the dQ pass) stream in by
// TMA through a ring of STAGES shared-memory stages with full and empty
// mbarriers, and the block's own tiles are loaded once.  The warpgroup runs
// the products on wgmma and the elementwise steps on the accumulator
// fragments in registers; while the tensor cores run the register-A
// products of one tile, the CUDA cores run the elementwise steps of the
// next, and two blocks share each SM.  Registers: at D=128 the dK/dV pass
// holds dK and dV (128 registers a thread) and S^T and dP^T (64) of its
// 64-query tiles; there it gives up that overlap, which would keep 32 more
// in flight and spilled.  -Xptxas -v gives the counts (PERF.md).
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd_sm90-<hash>.so this file
#include "sm90_common.cuh"

namespace {

using namespace sm90;

// A block is one warpgroup that owns 64 rows (keys in the dK/dV pass,
// queries in the dQ pass), and two blocks share an SM.  On the H100 this
// ran both passes faster than one block of two warpgroups: the two blocks
// drift apart, so one block's elementwise steps run on the CUDA cores while
// the other's products run on the tensor cores, and one block's start and
// end hide under the other's loop.  128 threads a block leave 255
// registers a thread.
constexpr int THREADS = WG;
constexpr int MIN_BLOCKS = 2;                     // resident blocks an SM
constexpr int BLOCK = 64;                         // rows a block owns
constexpr int DEFAULT_TILE = 64;                  // rows a streamed tile
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

// TILE: rows a streamed tile, DEFAULT_TILE when the caller passes 0, or 32
// (the autotuner's other candidate, at every D: S^T and dP^T, or S and dP,
// are then 16 registers each, and the products m64n32k16).
template <int D, int TILE_>
struct Cfg {
  static constexpr int TILE = TILE_;
  // lse and delta rows of a tile come by a 1-d TMA box, which must start on
  // 16 bytes in device memory: a box of ROWS_BOX values starts at the first
  // row rounded down to a multiple of 4, in a slot of ROWS_SLOT values
  // (128-byte aligned)
  static constexpr int ROWS_BOX = TILE + 4;
  static constexpr int ROWS_SLOT = TILE + 32;
  using OT = Tile<D, BLOCK>;   // the block's own tiles (K, V or Q, dO)
  using ST = Tile<D, TILE>;    // a streamed tile
  static constexpr int STAGE_BYTES = 2 * ST::BYTES;
  // own tiles, the stages of two streamed tiles, then (dK/dV pass) per
  // stage a slot of lse and a slot of delta values
  static constexpr size_t SMEM = 1024 + 2 * OT::BYTES +
                                 STAGES * STAGE_BYTES +
                                 STAGES * 2 * ROWS_SLOT * sizeof(float);
};

struct Params {
  const float* lse;
  const float* delta;
  __nv_bfloat16* g0;   // dk (dK/dV pass) or dq (dQ pass)
  __nv_bfloat16* g1;   // dv (dK/dV pass)
  int seq, heads, causal;
  float scale, scale_log2;
};

// stores a 64 x D f32 accumulator of warpgroup rows [r0, r0 + 64) as bf16
// rows of a contiguous (B, T, H, D) tensor; rows at or past seq are skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2], int b,
                                           int h, int r0, int warp, int lane,
                                           const Params& p) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + warp * 16 + (lane >> 2) + 8 * r;
    if (t >= p.seq) continue;
    __nv_bfloat16* row =
        out + (((long long)b * p.seq + t) * p.heads + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// The ring both passes stream their tiles through.  Thread 0 issues every
// load: the block's own tiles and the first STAGES tiles before the loop,
// and tile u + STAGES into the stage of tile u once every thread has
// released it.  (A producer warp of its own would make the block 160
// threads, and ptxas budgets registers for whole warpgroups: two blocks an
// SM would get 128 registers a thread.)
struct Ring {
  uint64_t own, full[STAGES], empty[STAGES];

  __device__ __forceinline__ void init() {
    mbar_init(&own, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    fence_barrier_init();
  }
  // wait for tile u; the warp leaves the wait together (wgmma is .aligned)
  __device__ __forceinline__ void wait_full(int u) {
    mbar_wait(&full[u % STAGES], (u / STAGES) & 1);
    __syncwarp();
  }
  // every consumer thread releases tile u; thread 0 then refills its stage
  // with tile u + STAGES by `load(tile, stage)`
  template <typename Load>
  __device__ __forceinline__ void release(int u, int n_tiles, Load load) {
    mbar_arrive(&empty[u % STAGES]);
    if (threadIdx.x == 0 && u + STAGES < n_tiles) {
      mbar_wait(&empty[u % STAGES], (u / STAGES) & 1);
      load(u + STAGES, u % STAGES);
    }
    __syncwarp();
  }
};

template <int D, int TILE_>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_delta, Params p) {
  using C = Cfg<D, TILE_>;
  using OT = typename C::OT;
  using ST = typename C::ST;
  constexpr int TILE = C::TILE;
  constexpr int ROWS_BOX = C::ROWS_BOX;
  constexpr int ROWS_SLOT = C::ROWS_SLOT;
  constexpr int STAGE_BYTES = C::STAGE_BYTES;   // Q then dO

  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + OT::BYTES;
  uint8_t* stages = sv + OT::BYTES;
  float* rows = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);

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
    uint8_t* st = stages + s * STAGE_BYTES;
    float* rs = rows + s * 2 * ROWS_SLOT;
    mbar_expect_tx(&ring.full[s],
                   STAGE_BYTES + 2 * ROWS_BOX * sizeof(float));
    ST::load(st, &tm_q, &ring.full[s], h, t0, b);
    ST::load(st + ST::BYTES, &tm_do, &ring.full[s], h, t0, b);
    const int x0 = (bh * p.seq + t0) & ~3;
    tma_load_1d(rs, &tm_lse, &ring.full[s], x0);
    tma_load_1d(rs + ROWS_SLOT, &tm_delta, &ring.full[s], x0);
  };
  if (tid == 0) {
    ring.init();
    mbar_expect_tx(&ring.own, 2 * OT::BYTES);
    OT::load(sk, &tm_k, &ring.own, h, k0, b);
    OT::load(sv, &tm_v, &ring.own, h, k0, b);
    for (int u = 0; u < min(STAGES, n_u); ++u) load(u, u);
  }
  __syncthreads();

  // keys [k0, k0 + 64)
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t sk_addr = smem_u32(sk);
  const uint32_t sv_addr = smem_u32(sv);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  float st[TILE / 2], dpt[TILE / 2];         // S^T, dP^T: 64 keys x TILE
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];

  auto stage_q = [&](int u) {
    return smem_u32(stages + (u % STAGES) * STAGE_BYTES);
  };
  // S^T = K Q^T and dP^T = V dO^T of tile u (committed, not waited for)
  auto issue_ss = [&](int u) {
    ring.wait_full(u);
    const uint32_t sq = stage_q(u);
    const uint32_t sdo = sq + ST::BYTES;
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(st, OT::kmajor(sk_addr, 0, kk),
                     ST::kmajor(sq, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(dpt, OT::kmajor(sv_addr, 0, kk),
                     ST::kmajor(sdo, 0, kk), kk > 0);
    wgmma_commit();
  };
  // dV += P^T dO and dK += dS^T Q of tile u: A in registers, B MN-major
  auto issue_rs = [&](int u) {
    const uint32_t sq = stage_q(u);
    const uint32_t sdo = sq + ST::BYTES;
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<1>(dv, pa[kk], ST::mnmajor(sdo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<1>(dk, da[kk], ST::mnmajor(sq, kk), 1);
    wgmma_commit();
  };
  // P^T and dS^T of tile u on the fragments, in place: columns are queries
  auto elementwise = [&](int u) {
    fence_regs(st);
    fence_regs(dpt);
    const int q0 = (j0 + u) * TILE;
    const float* lse_s =
        rows + (u % STAGES) * 2 * ROWS_SLOT + ((bh * p.seq + q0) & 3);
    const float* del_s = lse_s + ROWS_SLOT;
    const bool edge = (p.causal && q0 < k0 + 63) || q0 + TILE > p.seq;
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int c = acc_col(lane, i);
      float pt = exp2_approx(fmaf(st[i], p.scale_log2, -lse_s[c] * LOG2E));
      if (edge) {
        const int qrow = q0 + c;
        const int key = k0 + acc_row(warp, lane, i);
        if (qrow >= p.seq || (p.causal && qrow < key)) pt = 0.f;
      }
      st[i] = pt;
      dpt[i] = pt * (dpt[i] - del_s[c]) * p.scale;
    }
  };

  mbar_wait(&ring.own, 0);
  wgmma_fence();
  issue_ss(0);
  wgmma_wait<0>();
  for (int u = 0; u < n_u; ++u) {
    elementwise(u);
    if (u > 0) {   // the products of tile u - 1 have ended
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      ring.release(u - 1, n_u, load);
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      acc_to_a(st, kk, pa[kk]);
      acc_to_a(dpt, kk, da[kk]);
    }
    wgmma_fence();
    if (u + 1 < n_u) issue_ss(u + 1);
    issue_rs(u);
    // S^T and dP^T of tile u + 1 have ended; tile u's products run on
    // while the next pass of the loop does the elementwise steps of u + 1.
    // At D=128 the dK/dV pass waits for them too: keeping tile u's bf16
    // operands in flight beside dK, dV, S^T and dP^T spilled (-Xptxas -v:
    // 255 registers and 40 bytes of stack; 250 and none without).
    if (u + 1 < n_u) {
      if (D <= 64)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
    }
  }
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);

  store_rows<D>(p.g0, dk, b, h, k0, warp, lane, p);
  store_rows<D>(p.g1, dv, b, h, k0, warp, lane, p);
}

template <int D, int TILE_>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, Params p) {
  using C = Cfg<D, TILE_>;
  using OT = typename C::OT;
  using ST = typename C::ST;
  constexpr int TILE = C::TILE;
  constexpr int STAGE_BYTES = C::STAGE_BYTES;   // K then V

  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
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
    uint8_t* st = stages + s * STAGE_BYTES;
    mbar_expect_tx(&ring.full[s], STAGE_BYTES);
    ST::load(st, &tm_k, &ring.full[s], h, j * TILE, b);
    ST::load(st + ST::BYTES, &tm_v, &ring.full[s], h, j * TILE, b);
  };
  if (tid == 0) {
    ring.init();
    mbar_expect_tx(&ring.own, 2 * OT::BYTES);
    OT::load(sq, &tm_q, &ring.own, h, q0, b);
    OT::load(sdo, &tm_do, &ring.own, h, q0, b);
    for (int j = 0; j < min(STAGES, n_j); ++j) load(j, j);
  }
  __syncthreads();

  // query rows [q0, q0 + 64)
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint32_t sq_addr = smem_u32(sq);
  const uint32_t sdo_addr = smem_u32(sdo);

  // lse (log2 units) and delta of this thread's two rows
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + (lane >> 2) + 8 * r;
    const long long at = (long long)bh * p.seq + t;
    lse2[r] = t < p.seq ? p.lse[at] * LOG2E : 0.f;
    del[r] = t < p.seq ? p.delta[at] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[TILE / 2], dp[TILE / 2];   // S, dP: 64 rows x TILE keys
  uint32_t da[TILE / 16][4];

  auto stage_k = [&](int j) {
    return smem_u32(stages + (j % STAGES) * STAGE_BYTES);
  };
  // S = Q K^T and dP = dO V^T of tile j (committed, not waited for)
  auto issue_ss = [&](int j) {
    ring.wait_full(j);
    const uint32_t sk = stage_k(j);
    const uint32_t sv = sk + ST::BYTES;
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(sc, OT::kmajor(sq_addr, 0, kk),
                     ST::kmajor(sk, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(dp, OT::kmajor(sdo_addr, 0, kk),
                     ST::kmajor(sv, 0, kk), kk > 0);
    wgmma_commit();
  };
  // dQ += dS K of tile j: dS in registers, K MN-major
  auto issue_rs = [&](int j) {
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<1>(dq, da[kk], ST::mnmajor(stage_k(j), kk), 1);
    wgmma_commit();
  };
  // dS of tile j on the fragment, in place of dP
  auto elementwise = [&](int j) {
    fence_regs(sc);
    fence_regs(dp);
    const int k0 = j * TILE;
    const bool edge = (p.causal && k0 + TILE - 1 > q0) || k0 + TILE > p.seq;
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int r = (i >> 1) & 1;
      float pv = exp2_approx(fmaf(sc[i], p.scale_log2, -lse2[r]));
      if (edge) {
        const int key = k0 + acc_col(lane, i);
        const int row = q0 + acc_row(warp, lane, i);
        if (key >= p.seq || (p.causal && key > row)) pv = 0.f;
      }
      dp[i] = pv * (dp[i] - del[r]) * p.scale;
    }
  };

  mbar_wait(&ring.own, 0);
  wgmma_fence();
  issue_ss(0);
  wgmma_wait<0>();
  for (int j = 0; j < n_j; ++j) {
    elementwise(j);
    if (j > 0) {   // the product of tile j - 1 has ended
      wgmma_wait<0>();
      fence_regs(dq);
      ring.release(j - 1, n_j, load);
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) acc_to_a(dp, kk, da[kk]);
    wgmma_fence();
    if (j + 1 < n_j) issue_ss(j + 1);
    issue_rs(j);
    // S and dP of tile j + 1 have ended; tile j's dQ runs on while the
    // next pass of the loop does the elementwise steps of j + 1
    if (j + 1 < n_j) wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(dq);

  store_rows<D>(p.g0, dq, b, h, q0, warp, lane, p);
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
  // the block's own tiles load in boxes of BLOCK rows, the streamed ones in
  // boxes of TILE rows: the dK/dV pass owns K, V and streams Q, dO; the dQ
  // pass the reverse.  Equal sizes share one map a tensor.
  CUtensorMap m_q, m_do, m_k, m_v, m_lse, m_del;
  CUtensorMap o_q, o_do, o_k, o_v;   // BLOCK-row boxes when TILE differs
  const long long n_rows = (long long)a.batch * a.heads * a.seq;
  int rc = encode_bthd<D>(&m_q, a.q, a.batch, a.seq, a.heads, a.qs, TILE);
  if (rc == 0)
    rc = encode_bthd<D>(&m_do, a.dout, a.batch, a.seq, a.heads, a.os, TILE);
  if (rc == 0)
    rc = encode_bthd<D>(&m_k, a.k, a.batch, a.seq, a.heads, a.ks, TILE);
  if (rc == 0)
    rc = encode_bthd<D>(&m_v, a.v, a.batch, a.seq, a.heads, a.vs, TILE);
  if (TILE == BLOCK) {
    o_q = m_q;
    o_do = m_do;
    o_k = m_k;
    o_v = m_v;
  } else {
    if (rc == 0)
      rc = encode_bthd<D>(&o_q, a.q, a.batch, a.seq, a.heads, a.qs, BLOCK);
    if (rc == 0)
      rc = encode_bthd<D>(&o_do, a.dout, a.batch, a.seq, a.heads, a.os,
                          BLOCK);
    if (rc == 0)
      rc = encode_bthd<D>(&o_k, a.k, a.batch, a.seq, a.heads, a.ks, BLOCK);
    if (rc == 0)
      rc = encode_bthd<D>(&o_v, a.v, a.batch, a.seq, a.heads, a.vs, BLOCK);
  }
  if (rc == 0) rc = encode_f32_1d(&m_lse, a.lse, n_rows, C::ROWS_BOX);
  if (rc == 0) rc = encode_f32_1d(&m_del, a.delta, n_rows, C::ROWS_BOX);
  if (rc != 0) return rc;

  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((a.seq + BLOCK - 1) / BLOCK, a.batch * a.heads);

  // above 48 KB a block's dynamic shared memory needs this opt-in; a launch
  // refused for it would never run and synchronize() would not say so
  auto kdkdv = flash_bwd_dkdv_sm90<D, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Params pkv{a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
                   static_cast<__nv_bfloat16*>(a.dv), a.seq, a.heads,
                   a.causal, scale, scale * LOG2E};
  kdkdv<<<grid, THREADS, C::SMEM, stream>>>(m_q, o_k, o_v, m_do, m_lse,
                                            m_del, pkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kdq = flash_bwd_dq_sm90<D, TILE>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Params pq{a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), nullptr,
                  a.seq, a.heads, a.causal, scale, scale * LOG2E};
  kdq<<<grid, THREADS, C::SMEM, stream>>>(o_q, m_k, m_v, o_do, pq);
  return (int)cudaGetLastError();
}

// The launch at streamed tile `tile`: 0 is DEFAULT_TILE, 32 the other;
// any other value is refused.
template <int D>
int launch_tile(int tile, const Args& a, cudaStream_t st) {
  if (tile == 0 || tile == DEFAULT_TILE) return launch<D, DEFAULT_TILE>(a, st);
  if (tile == 32) return launch<D, 32>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16 only.  Strides are in elements, in the order (batch, seq, heads) for
// each of q, k, v, dO.  Launches the dK/dV kernel, then the dQ kernel, on
// `stream`.  tile: rows a streamed tile, 0 for the built-in 64, or 32.
// Returns 0, a cudaError_t code, or an sm90 encode error (see
// mxtt_bwd_sm90_error_string).
int mxtt_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int batch, int seq, int heads, int head_dim, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int causal, int tile,
    void* stream) {
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

const char* mxtt_bwd_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
