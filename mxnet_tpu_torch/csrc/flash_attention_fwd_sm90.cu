// Flash-attention forward for Hopper (sm_90a) on the tensor cores: the bf16
// route of flash_attention_fwd (the f32 route is flash_attention_fwd.cu).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py, _flash_attention_fwd_pallas
// (pallas_call at :283, the panel form, and :305, the streamed form, for
// T > 2048).  One kernel covers every length by streaming K/V tiles.
//
// Computes, for bf16 q, k, v of shape (B, T, H, D), D in {32, 64, 128}, any
// T >= 1, read through their strides (last dim contiguous, base and strides
// 16-byte aligned, as TMA needs):
//   o   = softmax(q k^T / sqrt(D) [causal mask]) v     (B, T, H, D) bf16,
//         contiguous
//   lse = m + log(l) per query row                      (B*H, T, 1) f32,
//         row bh = b*H + h, the layout the backward reads.
//
// What bounds it on this card: at the training shape (B=16, T=1024, H=16,
// D=64, causal) the two products do 2*2*B*H*D flops per live (query, key)
// pair, 35 GFLOP, on 4 (B, T, H, D) bf16 tensors (134 MB): about 260 flops
// per byte, near the card's bf16 ridge of 295, so the bound is the tensor
// cores' 989 TFLOP/s (0.036 ms) and the bytes (0.040 ms) about equally.
// Beside them: every 128 query rows read their head's K and V again, 302 MB
// at the training shape, from L2 if it still holds them; and one SFU exp2
// a score, 16 a clock an SM, which takes about as long as the products at
// D=64.
//
// What the design does about it: every product runs on wgmma, and the
// block is specialised by warpgroup, as FlashAttention-3 does it on this
// card.  Three warpgroups: two consumers of 64 query rows each (128 rows
// a block) and one producer.
//
// * The producer brings each Q tile in by TMA (cp.async.bulk.tensor,
//   swizzled) and streams the K and V tiles (128 keys, 64 at D=128)
//   through a ring of STAGES shared-memory stages, each with a full and an
//   empty mbarrier, so the loads of the next tiles run under the products
//   of this one.  It gives its registers up (setmaxnreg.dec to 40) and
//   the consumers take them (setmaxnreg.inc to 232): one if/else on the
//   warpgroup's role that never reconverges, so ptxas honours both, and
//   S (BN/2), O (D/2) and P (BN/4) fit without spills.
// * A consumer computes S = Q K^T with wgmma.m64nBNk16 (A = Q and B = K,
//   both K-major in shared memory), keeps the online softmax (row max m by
//   quad shuffles, running sum l) in registers on the accumulator fragment
//   (one FFMA and one SFU exp2 a score), rounds P to bf16 in registers and
//   feeds it as the register A operand of O += P V (B = V read MN-major
//   through the transpose bit).  P never leaves registers.  Inside a
//   warpgroup the softmax of tile j runs on the CUDA cores while the
//   tensor cores run P V of tile j - 1.
// * Ping-pong: the two consumers take turns to issue their products (named
//   barriers, bar.sync / bar.arrive over 256 threads), so one runs its
//   softmax on the CUDA cores while the other's S and P V occupy the
//   tensor cores, and the tensor cores are not left idle while both
//   exponentiate at once.
// * O leaves by TMA: a consumer writes o / l as bf16 into its own 64 rows
//   of the item's Q buffer (Q is no longer read), swizzled as TMA lays a
//   tile down, and one thread stores them with cp.async.bulk.tensor, which
//   writes whole 128-byte lines and clips rows past T.  The Q buffer is
//   given back to the producer once the store has read it, checked under
//   the next item's first product.  lse is one f32 a row from registers.
//   (Stored from registers, O took 8% longer at D=128; PERF.md.)
// * L2: a block takes a head's query tiles two at a time, one long and one
//   short under causal (Item), so the blocks run on a few heads at once,
//   whose K and V stay in L2, and still end together.
//
// Under causal the K loop stops at the diagonal and only the tiles that
// cross it (or T) are masked.  The kernel is persistent: one block an SM
// walks its (query tile, head) items, and the producer runs ahead into the
// next item (Q double-buffered), so a block's start and end hide under the
// loads and products of its neighbours in time.
//
// -Xptxas -v gives the registers (the entry's count is 168, ptxas's budget
// for 384 threads; the consumers' SASS names registers above it), spills
// and shared memory (PERF.md).  mxnet_tpu_torch/tools/
// flash_bf16_fwd_experiment.py times text edits of this source against it.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd_sm90-<hash>.so this file
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int CONSUMERS = 2;                      // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * WG;     // + the producer
constexpr int BM = 64 * CONSUMERS;                // query rows per block
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 <= 65536
// named barriers: BAR_TURN + c is consumer c's turn, BAR_OTILE + c its O
// tile written
constexpr int BAR_TURN = 1;
constexpr int BAR_OTILE = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct DefaultTile {
  // keys per K/V tile when the caller passes 0.  At D=128, 128-key tiles
  // (two stages of 64 KB) ran slower on the H100 than 64-key tiles (three
  // of 32 KB), and with O stored by TMA made ptxas spill and serialize the
  // wgmmas; at D=64, 192-key tiles spilled and ran slower still
  // (tools/flash_bf16_fwd_experiment.py)
  static constexpr int BN = D == 128 ? 64 : 128;
};

// The key tiles a caller may ask for (the autotuner's candidates): those
// whose S (BN/2), O (D/2) and P (BN/4) registers fit the consumers' 232
// without spills and whose stages fit shared memory: 64 and 128 keys at
// D = 32 and 64, 32 and 64 at D = 128.
template <int D, int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr int STAGES = 3;
  using QT = Tile<D, BM>;
  using KT = Tile<D, BN>;
  static constexpr int KV_BYTES = 2 * KT::BYTES;  // K then V
  static constexpr size_t SMEM = 1024 + 2 * QT::BYTES + STAGES * KV_BYTES;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int seq, heads, causal;
  float scale_log2;   // log2(e) / sqrt(D)
};

// The online softmax of one S tile on its accumulator fragment (a row lies
// in the 4 lanes of a quad): masks keys at or past seq and, under causal,
// past the row; turns the raw scores sc into p = exp2(s scale_log2 - m_new)
// and returns the factor exp2(m_old - m_new) by which the row's sum l and
// output o shrink.  m is kept in scaled log2 units; the row max is taken on
// the raw scores (scale > 0), so each score costs one FFMA and one SFU op.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int wq0, int warp,
                                             int lane, const Params& p) {
  if ((p.causal && k0 + BN - 1 > wq0) || k0 + BN > p.seq) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + acc_col(lane, i);
      const int row = wq0 + acc_row(warp, lane, i);
      if (key >= p.seq || (p.causal && key > row)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
    // a row with nothing live yet keeps m = -inf: exp2(-inf - -inf) would
    // be NaN, and its p and correction are 0
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = exp2_approx(m[r] - base[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2_approx(fmaf(sc[i], p.scale_log2, -base[r]));
    l[r] += sc[i];
  }
}

// Work item i of a launch: the query tile and (batch, head) it covers.
//
// The items of one head are neighbours, and a block takes them two at a
// time, items 2u and 2u + 1 of unit u = blockIdx.x + k gridDim.x.  Under
// causal the query tiles of a head come in the order n_q - 1, 0,
// n_q - 2, 1, ..., so a unit pairs a long tile with a short one and every
// unit costs about n_q + 1 K/V tiles: the blocks end together.  The 132
// blocks then work on some 2 x 132 / n_q heads at a time, whose K and V
// stay in L2 while each is read by every query tile of its head (every
// head's K and V at once, 64 MB at the training shape, do not stay in the
// 50 MB L2).
struct Item {
  int q0, b, h, bh, n_tiles;
  __device__ __forceinline__ Item(int i, int n_q, int BN, const Params& p) {
    bh = i / n_q;
    const int j = i - bh * n_q;
    const int qt = !p.causal ? j : (j & 1) ? j >> 1 : n_q - 1 - (j >> 1);
    b = bh / p.heads;
    h = bh - b * p.heads;
    q0 = qt * BM;
    const int kv_end = p.causal ? min(q0 + BM, p.seq) : p.seq;
    n_tiles = (kv_end + BN - 1) / BN;
  }
};

// The block's it-th work item, or n_items past its last.
__device__ __forceinline__ int item_index(int it, int n_items) {
  const int i = 2 * (blockIdx.x + (it >> 1) * gridDim.x) + (it & 1);
  return min(i, n_items);
}

// A persistent kernel: one block per SM walks its work items.  The
// producer runs ahead across items (Q double-buffered, the K/V ring
// continuing from item to item), so the next item's loads land while the
// consumers finish this one and store its output.
template <int D, int BN_>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, Params p,
                      int n_q, int n_items) {
  using C = Cfg<D, BN_>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BN = C::BN;
  constexpr int STAGES = C::STAGES;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[2], q_empty[2], full[STAGES], empty[STAGES];
  uint8_t* sq = align1024(smem_raw);            // two Q buffers
  uint8_t* skv = sq + 2 * QT::BYTES;

  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mbar_init(&q_full[x], 1);
      mbar_init(&q_empty[x], CONSUMERS * WG);
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform to the compiler as to the card
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  if (wg == CONSUMERS) {
    // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * WG) {
      int kv = 0;   // K/V tiles loaded so far, over all items
      for (int it = 0, i; (i = item_index(it, n_items)) < n_items; ++it) {
        const Item w(i, n_q, BN, p);
        const int x = it & 1;
        if (it >= 2) mbar_wait(&q_empty[x], ((it >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[x], QT::BYTES);
        QT::load(sq + x * QT::BYTES, &tm_q, &q_full[x], w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++kv) {
          const int s = kv % STAGES;
          if (kv >= STAGES) mbar_wait(&empty[s], (kv / STAGES - 1) & 1);
          uint8_t* sk = skv + s * C::KV_BYTES;
          mbar_expect_tx(&full[s], C::KV_BYTES);
          KT::load(sk, &tm_k, &full[s], w.h, j * BN, w.b);
          KT::load(sk + KT::BYTES, &tm_v, &full[s], w.h, j * BN, w.b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [wq0, wq0 + 64) of each item
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (tid % WG) / 32;
    const int lane = tid % 32;
    // this warpgroup's first thread issues its O stores; the Q buffer a
    // store reads is given back (its q_empty arrival) once it has been read
    const bool leader = tid % WG == 0;
    int stored = -1;   // the Q buffer of the leader's store not yet read
    float o[D / 2];
    float m[2], l[2], corr[2];   // rows r and r + 8; m in log2 units, l
                                 // this thread's part of the row sum
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];

    // consumer 0 takes the first turn
    if (wg == 1) bar_arrive(BAR_TURN, 2 * WG);

    int kv = 0;   // K/V tiles consumed before this item
    for (int it = 0, i; (i = item_index(it, n_items)) < n_items; ++it) {
      const Item w(i, n_q, BN, p);
      const int wq0 = w.q0 + wg * 64;
      const int x = it & 1;
      const uint32_t sq_addr = smem_u32(sq + x * QT::BYTES);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      // the first product overwrites S; zeroing it here ends the last
      // item's S, which the products' "+f" operands would keep alive
      // through the epilogue
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      auto stage = [&](int j) { return (kv + j) % STAGES; };
      auto wait_kv = [&](int j) {
        mbar_wait(&full[stage(j)], ((kv + j) / STAGES) & 1);
        __syncwarp();   // wgmma is .aligned: the warp leaves the wait together
      };
      // this consumer's turn on the tensor cores, and its end: the other
      // consumer's turn
      auto turn = [&]() { bar_sync(BAR_TURN + wg, 2 * WG); };
      auto turn_over = [&]() { bar_arrive(BAR_TURN + (wg ^ 1), 2 * WG); };
      // S = Q K^T of tile j into sc (committed, not waited for)
      auto issue_qk = [&](int j) {
        const uint32_t sk = smem_u32(skv + stage(j) * C::KV_BYTES);
        fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0, 0>(sc, QT::kmajor(sq_addr, wg * 64, kk),
                         KT::kmajor(sk, 0, kk), kk > 0);
        wgmma_commit();
      };
      // O += P V of tile j, P in registers as bf16, V MN-major (committed)
      auto issue_pv = [&](int j) {
        const uint32_t sv =
            smem_u32(skv + stage(j) * C::KV_BYTES) + KT::BYTES;
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<1>(o, pa[kk], KT::mnmajor(sv, kk), 1);
        wgmma_commit();
      };
      auto softmax = [&](int j) {
        fence_regs(sc);
        softmax_tile<BN>(sc, m, l, corr, j * BN, wq0, warp, lane, p);
      };
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
      };

      // The softmax of tile j runs on the CUDA cores while the tensor cores
      // run P V of tile j - 1 (and the other consumer's products): S of
      // tile j is issued with it and waited for alone (the groups end in
      // order).  P of tile j is packed into pa, and o rescaled, only once
      // P V of tile j - 1 has ended: wgmma reads its register operands
      // while it runs.
      mbar_wait(&q_full[x], (it >> 1) & 1);
      wait_kv(0);
      turn();
      wgmma_fence();
      issue_qk(0);
      turn_over();
      // the previous item's O store has long been read: its Q buffer goes
      // back to the producer
      if (leader && stored >= 0) {
        bulk_wait_read<0>();
        mbar_arrive(&q_empty[stored]);
      }
      __syncwarp();
      wgmma_wait<0>();
      softmax(0);
      pack();
      for (int j = 1; j < w.n_tiles; ++j) {
        wait_kv(j);
        turn();
        wgmma_fence();
        issue_qk(j);
        issue_pv(j - 1);
        turn_over();
        wgmma_wait<1>();
        softmax(j);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[stage(j - 1)]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
        pack();
      }
      // the item's last S has been computed: Q is not read again (the
      // leader's arrival waits for its O store, which writes this buffer)
      if (!leader) mbar_arrive(&q_empty[x]);
      wgmma_fence();
      issue_pv(w.n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[stage(w.n_tiles - 1)]);
      kv += w.n_tiles;

      // o / l in bf16, lse = m ln 2 + log l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + (lane >> 2) + 8 * r;   // in the 64
        const int t = wq0 + row;
        uint8_t* so = sq + x * QT::BYTES;
        uint32_t key = QT::swizzle_key(wg * 64 + row);
        // made anew each item: offsets hoisted out of the item loop would
        // hold D / 8 registers through the main loop
        asm volatile("" : "+r"(key));
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(
              so + QT::offset(wg * 64 + row, 8 * n + 2 * (lane & 3), key)) =
              pack_bf16(o[4 * n + 2 * r] * inv[r],
                        o[4 * n + 2 * r + 1] * inv[r]);
        if ((lane & 3) == 0 && t < p.seq)
          p.lse[(long long)w.bh * p.seq + t] = m[r] * LN2 + logf(l[r]);
      }
      fence_proxy_async();
      bar_sync(BAR_OTILE + wg, WG);   // the warpgroup's 64 rows written
      if (leader) {
        const uint8_t* so = sq + x * QT::BYTES + wg * 64 * QT::SWZ;
#pragma unroll
        for (int bx = 0; bx < QT::BOXES; ++bx)
          tma_store_4d(&tm_o, so + bx * QT::BOX_BYTES, bx * QT::BOX_COLS,
                       w.h, wq0, w.b);
        bulk_commit();
        stored = x;
      }
    }
    // the block's shared memory must outlive the last store's reads
    if (leader) bulk_wait<0>();
  }
}

// the card's SM count, read once
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int D, int BN>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int seq, int heads, Strides qs, Strides ks, Strides vs,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, BN>;
  auto kern = flash_fwd_sm90_kernel<D, BN>;
  // above 48 KB a block's dynamic shared memory needs this opt-in, once
  // per head dim and device; a launch refused for it would never run and
  // synchronize() would not say so
  constexpr int MAX_DEVICES = 64;
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  // o is contiguous: its map reads (batch, seq, heads) strides of its own,
  // with boxes of one consumer's 64 rows
  const Strides os{(long long)seq * heads * D, (long long)heads * D, D};
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  int rc = encode_bthd<D>(&tm_q, q, batch, seq, heads, qs, BM);
  if (rc == 0) rc = encode_bthd<D>(&tm_k, k, batch, seq, heads, ks, C::BN);
  if (rc == 0) rc = encode_bthd<D>(&tm_v, v, batch, seq, heads, vs, C::BN);
  if (rc == 0) rc = encode_bthd<D>(&tm_o, o, batch, seq, heads, os, 64);
  if (rc != 0) return rc;
  const Params p{static_cast<__nv_bfloat16*>(o), lse, seq, heads, causal,
                 LOG2E / sqrtf((float)D)};
  const int n_q = (seq + BM - 1) / BM;
  const int n_items = n_q * batch * heads;
  const int units = (n_items + 1) / 2;   // pairs of items (Item)
  const int grid = units < sm_count() ? units : sm_count();
  kern<<<grid, THREADS, C::SMEM, stream>>>(tm_q, tm_k, tm_v, tm_o, p, n_q,
                                           n_items);
  return (int)cudaGetLastError();
}

// One head dim's launch at key tile block_k: 0 is DefaultTile's, else one
// of the tiles Cfg lists; any other value is refused.
template <int D, int ALT>
int launch_tile(int block_k, const void* q, const void* k, const void* v,
                void* o, float* lse, int batch, int seq, int heads,
                Strides qs, Strides ks, Strides vs, int causal,
                cudaStream_t st) {
  constexpr int DEF = DefaultTile<D>::BN;
  if (block_k == 0 || block_k == DEF)
    return launch<D, DEF>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs,
                          causal, st);
  if (block_k == ALT)
    return launch<D, ALT>(q, k, v, o, lse, batch, seq, heads, qs, ks, vs,
                          causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16 only.  Strides are in elements, (batch, seq, heads) for each of q, k,
// v.  block_k: keys per K/V tile, 0 for the built-in choice (DefaultTile),
// else 64 or 128 at D = 32 and 64, 32 or 64 at D = 128.  Returns 0, a
// cudaError_t code, or an sm90 encode error (see mxtt_fwd_sm90_error_string).
int mxtt_flash_attention_fwd_sm90(const void* q, const void* k,
                                  const void* v, void* o, float* lse,
                                  int batch, int seq, int heads, int head_dim,
                                  long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh,
                                  long long v_sb, long long v_st,
                                  long long v_sh, int causal, int block_k,
                                  void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_tile<32, 64>(block_k, q, k, v, o, lse, batch, seq,
                                 heads, qs, ks, vs, causal, st);
    case 64:
      return launch_tile<64, 64>(block_k, q, k, v, o, lse, batch, seq,
                                 heads, qs, ks, vs, causal, st);
    case 128:
      return launch_tile<128, 32>(block_k, q, k, v, o, lse, batch, seq,
                                  heads, qs, ks, vs, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxtt_fwd_sm90_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
