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
// moving mean, the shift of the statistics; null reads as 0):
//   y  = x w^T                    (M, N), x's dtype
//   s1 = sum over rows (y - c)    (N,) f32
//   s2 = sum over rows (y - c)^2  (N,) f32
// where y inside the sums is the f32 accumulator, before y is rounded to
// x's dtype, as in the TPU kernel.
//
// K8, the prologue variant (mxtt_matmul_stats_prologue), replaces
// tools/pallas_matmul_stats_experiment.py, matmul_stats_prologue (its
// Pallas kernel _kernel_prologue): the same function of
//   xh = relu(x * scale + shift)   scale, shift (K,) f32
// computed in f32 (the product and the sum rounded apart, as the plain
// version computes them) and rounded to x's dtype before the product: the
// previous BatchNorm's transform folded into this GEMM.  K7
// (tools/pallas_matmul_stats_experiment.py, matmul_stats) is this file's
// K5 entry with c = 0.
//
// What bounds it on this card: at ResNet-50's shapes (K 64 to 2048, N 64 to
// 512) the product does 2K flops for every 2(K + N) bytes of x and y that
// one row moves in bf16, under the 295 flops a byte at which the H100's
// tensor cores overtake its memory: the 16 launches of a training step are
// bound by bytes (1.9 GB at 3.35 TB/s) more than by operations.  So x is
// read from device memory once, y written once, and the statistics never
// leave the chip until a block's last item.
//
// bf16, the design (one kernel template, matmul_stats_sm90_kernel<BN, PRO>):
// * Persistent: one block an SM, each a static list of 128-row items of one
//   n-tile of BN columns (64, 128 or 256: at most what N needs, 256-column
//   tiles at N = 512, narrower where that evens out the blocks' rounds of
//   items; bf16_tile).  The blocks of one
//   m-tile's n-tiles are neighbours, so they read its x tile at about the
//   same time: from device memory once, from L2 after.
// * A producer warpgroup (one thread issues every load) keeps x tiles
//   (128 rows x 64 depth, 128-byte rows, SWIZZLE_128B) and w tiles (BN rows
//   x 64) in flight by TMA (cp.async.bulk.tensor) through a ring of STAGES
//   shared-memory stages, each with a full and an empty mbarrier, running
//   ahead across items.  It gives its registers up (setmaxnreg.dec to 40)
//   and the two consumers take them (setmaxnreg.inc to 232).
// * Two consumer warpgroups of 64 rows each run wgmma.m64nBNk16 with A = x
//   and B = w both K-major in shared memory (one Tile type gives the TMA
//   box and the descriptors) and f32 accumulators, one k-block in flight.
// * The epilogue: y leaves as bf16 through a staging tile in shared memory
//   (one per consumer, swizzled as TMA lays it down) and a TMA store, whose
//   reads are waited for only before the next item's staging.  (acc - c)
//   and its square of each column are summed over the thread's two rows
//   (rows past M masked: TMA fills them with 0, and K8 makes them
//   relu(shift)), then reduce-scattered over the 8 lanes that share the
//   columns by shuffles, in place in the accumulator's registers, into
//   per-thread sums that live across the block's items (BN / 16 a thread,
//   in shared memory).
//   At its end the block adds its 8 warps' sums in a fixed order and writes
//   one row of a (grid / n-tiles, N) partial buffer; a second kernel sums
//   each column of it in a fixed order.  No atomics: the same result on
//   every run.
// * K8: between a landed x stage and its first wgmma, each consumer
//   rewrites its own 64 rows in shared memory (a thread an 8-byte half
//   chunk of eight rows, the same depth columns, found through the
//   swizzle), then
//   fence.proxy.async and a warpgroup barrier, so the tensor cores read the
//   generic-proxy writes.
// * TMA wants 16-byte strides and bases: K % 8 == 0, N % 8 == 0 and x, w
//   16-byte aligned.  The wrapper (ops/fused.py) pads other bf16 shapes
//   with zeros before it launches.
//
// f32, the design (matmul_stats_tf32_kernel<BN, PRO>): the tensor cores as
// split TF32 (tf32_common.cuh: x = hi + lo, three m16n8k8 TF32 products a
// product, about 21 of f32's 24 bits), on the bf16 route's frame.
// * Persistent as above: one block an SM, 128-row items of one n-tile of BN
//   columns (64 where N <= 64, else 128), the partial rows the same.
// * Thread 0 keeps x (128 rows x 32 depth) and w (BN x 32) in flight by
//   TMA, f32 rows of 128 bytes with SWIZZLE_128B (tf32::TileF32), through a
//   ring of STAGES stages with full and empty mbarriers.
// * Eight consumer warps (2 x 4 of 64 x 32 at BN = 128, 4 x 2 of 32 x 32 at
//   BN = 64) read their fragments by ldsm_x4 (an 8x8 b16 matrix is an 8 x 4
//   f32 block in the TF32 fragment layout), split them in registers and
//   run the warp-level m16n8k8 TF32 products, which read registers, not
//   shared memory.
// * Sums: the tensor cores' f32 accumulator truncates, so a K = 2048 sum
//   kept in it drifts past 1e-5 of max |y|.  Each stage's products (32
//   deep, 12 products) go into a zeroed accumulator that is then added into
//   the running sum on the CUDA cores, rounded to nearest.
// * K8: relu(x * scale + shift) is applied to the A fragments in registers
//   before the split, scale and shift read a k-step (__ldg, 0 past K).
// * y leaves through a swizzled f32 staging tile and TMA stores of 32-column
//   boxes; the statistics come from the f32 accumulator in registers (rows
//   past M masked), summed a thread's items in order, then over the 8 lanes
//   sharing a column by shuffles and over the warps along M in a fixed
//   order into the block's partial row.  No atomics.
// * TMA wants K % 4 == 0, N % 4 == 0 and 16-byte aligned x, w and y; the
//   wrapper pads other shapes.
//
// -Xptxas -v gives the registers (168 at the entry, ptxas's budget for 384
// threads, which bounded the consumers' code too: the 256-column
// accumulator with the running sums beside it in registers spilled, so the
// sums live in shared memory), spills and shared memory (PERF.md).
// mxnet_tpu_torch/tools/matmul_stats_experiment.py times text edits of
// this source and an older checkout's kernel against it.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmatmul_stats-<hash>.so this file
#include "sm90_common.cuh"
#include "tf32_common.cuh"

namespace {

using namespace sm90;

// ------------------------------------------------------------- bf16 path
constexpr int BM = 128;                        // rows of an item
constexpr int BK = 64;                         // depth of a stage: 128 bytes
constexpr int CONSUMERS = 2;                   // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * WG;  // + the producer
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 <= 65536
// named barriers: BAR_Y + c consumer c's y staging free, then written;
// BAR_PRO + c its rows of x transformed (K8); BAR_END both consumers past
// their last product
constexpr int BAR_Y = 1;
constexpr int BAR_PRO = 3;
constexpr int BAR_END = 5;
constexpr int SMEM_LIMIT = 232448;   // a block's shared memory on the H100
constexpr int SMEM_STATIC = 2048;    // barriers and c, rounded up

template <int BN>
struct Cfg {
  using XT = Tile<BK, BM>;   // an item's rows of x, one k-block
  using WT = Tile<BK, BN>;   // its n-tile's rows of w, one k-block
  using YT = Tile<BN, 64>;   // one consumer's rows of y
  static constexpr int STAGE_BYTES = XT::BYTES + WT::BYTES;
  static constexpr int Y_BYTES = CONSUMERS * YT::BYTES;
  // each consumer thread's running sums (Stats), BN / 16 floats
  static constexpr int SUM_BYTES = CONSUMERS * WG * (BN / 16) * 4;
  static constexpr int FIT =
      (SMEM_LIMIT - SMEM_STATIC - 1024 - Y_BYTES - SUM_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE_BYTES + Y_BYTES + SUM_BYTES;
  static_assert(STAGES >= 3, "the ring holds at least three stages");
  // the block's final sums, 2 x BN floats for each of its 8 warps, are
  // gathered in the ring once both consumers are done with it
  static_assert(CONSUMERS * 4 * 2 * BN * 4 <= STAGES * STAGE_BYTES,
                "the final sums fit in the ring");
};

struct Args {
  const float* c;       // (N,) f32, or null for 0
  const float* scale;   // (K,) f32, K8 only
  const float* shift;
  float* part1;         // (grid / n-tiles, N) f32: block b's sums in row
  float* part2;         // b / n-tiles, columns of its n-tile
  int M, N, K;
};

// K8's transform of consumer wg's 64 rows of a landed x tile, in place:
// bf16(relu(f32(x) * scale + shift)), depth columns from k0.  A thread
// takes the 8-byte half chunk ctid % 16 of rows ctid / 16 + 8 j: always the
// same 4 depth columns (one 16-byte load of scale and of shift, which are
// 16-byte aligned), and rows of one swizzle key.  Half chunks keep few
// registers beside a 256-column accumulator (whole 16-byte chunks, with 16
// scale and shift values held, made ptxas spill there).  Columns past K
// are 0 in x (TMA's fill) and get scale = shift = 0: they stay 0.
template <typename XT>
__device__ __forceinline__ void prologue_rows(uint8_t* xs, int wg, int ctid,
                                              int k0, const Args& a) {
  const int half = ctid & 15;
  const int k = k0 + 4 * half;   // K % 8 == 0: all four columns or none
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 sc =
      k < a.K ? __ldg(reinterpret_cast<const float4*>(a.scale + k)) : zero;
  const float4 sh =
      k < a.K ? __ldg(reinterpret_cast<const float4*>(a.shift + k)) : zero;
  const int r0 = wg * 64 + (ctid >> 4);
  const uint32_t key = XT::swizzle_key(r0);   // the same for r0 + 8 j
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint2* p = reinterpret_cast<uint2*>(
        xs + XT::offset(r0 + 8 * j, 4 * half, key));
    uint2 v = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    h[0] = __floats2bfloat162_rn(
        fmaxf(__fadd_rn(__fmul_rn(f0.x, sc.x), sh.x), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(f0.y, sc.y), sh.y), 0.f));
    h[1] = __floats2bfloat162_rn(
        fmaxf(__fadd_rn(__fmul_rn(f1.x, sc.z), sh.z), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(f1.y, sc.w), sh.w), 0.f));
    *p = v;
  }
}

// The statistics of one item, reduce-scattered in place in the
// accumulator's registers.  Lane (g, t) = (lane / 4, lane % 4) holds rows
// r and r + 8 of the columns 8 n + 2 t + j (acc[4 n + j] and
// acc[4 n + 2 + j]).  Logical value L < BN / 4 is the sum of column list
// index L = 2 n + j over the two rows; BN / 4 + L its sum of squares.
// Three halvings over lane bits 4, 3, 2 (the lanes sharing t) leave each
// lane the sums over the warp's 16 rows of BN / 16 of those values: stat
// (lane >> 4) & 1, column list indices from
// ((lane >> 3) & 1) BN / 8 + ((lane >> 2) & 1) BN / 16, added to the
// thread's running sums in shared memory, sum[q * 256 + thread] (held in
// registers beside a 256-column accumulator they made ptxas spill).
template <int BN>
struct Stats {
  static constexpr int H1 = BN / 4;
  __device__ static __forceinline__ float& at(float (&acc)[BN / 2], int L) {
    return L < H1 ? acc[4 * (L >> 1) + (L & 1)]
                  : acc[4 * ((L - H1) >> 1) + 2 + ((L - H1) & 1)];
  }
  template <int H, int OFF>
  __device__ static __forceinline__ void halve(float (&acc)[BN / 2],
                                               int lane) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const float lo_v = at(acc, q), hi_v = at(acc, H + q);
      const float send = hi ? lo_v : hi_v;
      const float keep = hi ? hi_v : lo_v;
      at(acc, q) = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
  }
  __device__ static __forceinline__ void item(float (&acc)[BN / 2],
                                              float* sum,
                                              const float* cs, bool ok0,
                                              bool ok1, int lane) {
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float cc = cs[8 * n + 2 * t + j];
        const float d0 = ok0 ? acc[4 * n + j] - cc : 0.f;
        const float d1 = ok1 ? acc[4 * n + 2 + j] - cc : 0.f;
        acc[4 * n + j] = d0 + d1;               // L = 2 n + j
        acc[4 * n + 2 + j] = d0 * d0 + d1 * d1;  // L = H1 + 2 n + j
      }
    halve<H1, 16>(acc, lane);
    halve<H1 / 2, 8>(acc, lane);
    halve<H1 / 4, 4>(acc, lane);
#pragma unroll
    for (int q = 0; q < BN / 16; ++q)
      sum[q * CONSUMERS * WG] += at(acc, q);
  }
  // the column (in the n-tile) of running sum q
  __device__ static __forceinline__ int column(int q, int lane) {
    const int li = ((lane >> 3) & 1) * (H1 / 2) + ((lane >> 2) & 1) * (H1 / 4)
                   + q;
    return 8 * (li >> 1) + 2 * (lane & 3) + (li & 1);
  }
};

// A persistent kernel: block b takes n-tile b % n_tiles and the m-tiles
// b / n_tiles + i gridDim.x / n_tiles (the grid is a multiple of n_tiles).
template <int BN, bool PRO>
__global__ void __launch_bounds__(THREADS, 1)
matmul_stats_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_y, Args a) {
  using C = Cfg<BN>;
  using XT = typename C::XT;
  using WT = typename C::WT;
  using YT = typename C::YT;
  constexpr int STAGES = C::STAGES;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ float cs[BN];   // c of the n-tile's columns, 0 past N
  uint8_t* ring = align1024(smem_raw);
  uint8_t* sy = ring + STAGES * C::STAGE_BYTES;
  float* sums = reinterpret_cast<float*>(sy + C::Y_BYTES);

  const int tid = threadIdx.x;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m_first = blockIdx.x / n_tiles;
  const int m_step = gridDim.x / n_tiles;
  const int m_tiles = (a.M + BM - 1) / BM;
  const int k_blocks = (a.K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * WG);
    }
    fence_barrier_init();
  }
  for (int j = tid; j < BN; j += THREADS)
    cs[j] = a.c != nullptr && n0 + j < a.N ? a.c[n0 + j] : 0.f;
  __syncthreads();

  // the warpgroup's role, warp-uniform to the compiler as to the card
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  if (wg == CONSUMERS) {
    // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * WG) {
      int it = 0;   // stages loaded so far, over all items
      for (int mt = m_first; mt < m_tiles; mt += m_step)
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          uint8_t* st = ring + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          tma_load_2d(st, &tm_x, &full[s], kb * BK, mt * BM);
          tma_load_2d(st + XT::BYTES, &tm_w, &full[s], kb * BK, n0);
        }
    }
  } else {
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each item
    setmaxnreg_inc<CONSUMER_REGS>();
    const int ctid = tid % WG;
    const int warp = ctid / 32;
    const int lane = tid % 32;
    const int row = warp * 16 + (lane >> 2);   // acc rows row, row + 8
    // this warpgroup's first thread issues its y stores
    const bool leader = ctid == 0;
    uint8_t* my_y = sy + wg * YT::BYTES;
    float acc[BN / 2];
    float* sum = sums + tid;   // this thread's running sums
#pragma unroll
    for (int q = 0; q < BN / 16; ++q) sum[q * CONSUMERS * WG] = 0.f;

    int it = 0;   // stages consumed so far, over all items
    for (int mt = m_first; mt < m_tiles; mt += m_step) {
      const int m0 = mt * BM;
      for (int kb = 0; kb < k_blocks; ++kb, ++it) {
        const int s = it % STAGES;
        uint8_t* st = ring + s * C::STAGE_BYTES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        __syncwarp();   // wgmma is .aligned: the warp leaves the wait together
        if (PRO) {
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
        wgmma_commit();
        if (kb > 0) {
          // the previous k-block's products have ended: its stage goes back
          wgmma_wait<1>();
          mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);

      // y in bf16 through the staging tile: free once the previous
      // item's store has read it
      if (leader) bulk_wait_read<0>();
      bar_sync(BAR_Y + wg, WG);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t key = YT::swizzle_key(row + 8 * r);
        // made anew each item: offsets hoisted out of the item loop would
        // hold BN / 8 registers through the main loop
        asm volatile("" : "+r"(key));
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          *reinterpret_cast<uint32_t*>(
              my_y + YT::offset(row + 8 * r, 8 * n + 2 * (lane & 3), key)) =
              pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      }
      fence_proxy_async();
      bar_sync(BAR_Y + wg, WG);
      if (leader) {
#pragma unroll
        for (int bx = 0; bx < YT::BOXES; ++bx)
          if (n0 + bx * YT::BOX_COLS < a.N)
            tma_store_2d(&tm_y, my_y + bx * YT::BOX_BYTES,
                         n0 + bx * YT::BOX_COLS, m0 + wg * 64);
        bulk_commit();
      }
      const int grow = m0 + wg * 64 + row;
      Stats<BN>::item(acc, sum, cs, grow < a.M, grow + 8 < a.M, lane);
    }

    // the block's sums: its 8 warps' in a fixed order, gathered in the
    // ring, which both consumers are done with
    bar_sync(BAR_END, CONSUMERS * WG);
    float* red = reinterpret_cast<float*>(ring);   // [8 warps][2][BN]
    const int wq = wg * 4 + warp;
    const int stat = (lane >> 4) & 1;
#pragma unroll
    for (int q = 0; q < BN / 16; ++q)
      red[(wq * 2 + stat) * BN + Stats<BN>::column(q, lane)] =
          sum[q * CONSUMERS * WG];
    bar_sync(BAR_END, CONSUMERS * WG);
    const size_t prow = (size_t)(blockIdx.x / n_tiles) * a.N;
    for (int e = tid; e < 2 * BN; e += CONSUMERS * WG) {
      const int st = e / BN, col = e % BN;
      float sum = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < CONSUMERS * 4; ++w8)
        sum += red[(w8 * 2 + st) * BN + col];
      if (n0 + col < a.N) (st ? a.part2 : a.part1)[prow + n0 + col] = sum;
    }
    // the block's shared memory must outlive the last store's reads
    if (leader) bulk_wait<0>();
  }
}

// -------------------------------------------------------------- f32 path
namespace f32 {

constexpr int BM = 128;                     // rows of an item
constexpr int BK = 32;                      // depth of a stage: 128 bytes
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;   // two warps a scheduler: 255 registers

template <int BN>
struct Cfg {
  using XT = tf32::TileF32<BK, BM>;   // an item's rows of x, one k-block
  using WT = tf32::TileF32<BK, BN>;   // its n-tile's rows of w
  using YT = tf32::TileF32<BN, BM>;   // the item's y, BN / 32 boxes
  static constexpr int WM = BN == 64 ? 4 : 2;   // warps along M
  static constexpr int WN = WARPS / WM;         // and along N
  static constexpr int MT = BM / WM / 16;       // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;        // n8 tiles a warp
  static constexpr int STAGE_BYTES = XT::BYTES + WT::BYTES;
  static constexpr int FIT =
      (SMEM_LIMIT - SMEM_STATIC - 1024 - YT::BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE_BYTES + YT::BYTES;
  static_assert(NT % 2 == 0, "B fragments come two n-tiles at a time");
  static_assert(STAGES >= 3, "the ring holds at least three stages");
  static_assert(WM * 2 * BN * 4 <= STAGES * STAGE_BYTES,
                "the final sums fit in the ring");
};

// relu(v * scale + shift), the product and the sum rounded apart, as the
// plain version computes them
__device__ __forceinline__ float prologue(float v, float sc, float sh) {
  return fmaxf(__fadd_rn(__fmul_rn(v, sc), sh), 0.f);
}

// A persistent kernel: block b takes n-tile b % n_tiles and the m-tiles
// b / n_tiles + i gridDim.x / n_tiles, as the bf16 kernel does.  Thread 0
// issues the loads: stage u of the block's list (item u / k_blocks, k-block
// u % k_blocks) goes into ring stage u % STAGES once all threads have
// released use u - STAGES.  (A producer warp beside the eight would make
// nine warps, three on one scheduler, and cap ptxas at 168 registers: the
// accumulators spilled.)
template <int BN, bool PRO>
__global__ void __launch_bounds__(THREADS, 1)
matmul_stats_tf32_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_y, Args a) {
  using C = Cfg<BN>;
  using XT = typename C::XT;
  using WT = typename C::WT;
  using YT = typename C::YT;
  constexpr int STAGES = C::STAGES;
  constexpr int MT = C::MT;
  constexpr int NT = C::NT;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ float cs[BN];   // c of the n-tile's columns, 0 past N
  uint8_t* ring = align1024(smem_raw);
  uint8_t* sy = ring + STAGES * C::STAGE_BYTES;

  const int tid = threadIdx.x;
  const int n_tiles = (a.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int m_first = blockIdx.x / n_tiles;
  const int m_step = gridDim.x / n_tiles;
  const int m_tiles = (a.M + BM - 1) / BM;
  const int k_blocks = (a.K + BK - 1) / BK;

  const int uses = (m_tiles - m_first + m_step - 1) / m_step * k_blocks;
  auto load = [&](int u) {   // thread 0: stage u of the block's list
    const int s = u % STAGES, kb = u % k_blocks;
    const int mt = m_first + u / k_blocks * m_step;
    uint8_t* st = ring + s * C::STAGE_BYTES;
    mbar_expect_tx(&full[s], C::STAGE_BYTES);
    tma_load_2d(st, &tm_x, &full[s], kb * BK, mt * BM);
    tma_load_2d(st + XT::BYTES, &tm_w, &full[s], kb * BK, n0);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    fence_barrier_init();
    for (int u = 0; u < STAGES && u < uses; ++u) load(u);
  }
  for (int j = tid; j < BN; j += THREADS)
    cs[j] = a.c != nullptr && n0 + j < a.N ? a.c[n0 + j] : 0.f;
  __syncthreads();

  // warp (wm, wn): rows [16 MT wm, 16 MT (wm + 1)) of each item, columns
  // [8 NT wn, 8 NT (wn + 1)) of the n-tile
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const tf32::Lane ln(lane);
  const int row0 = 16 * MT * wm, col0 = 8 * NT * wn;
  const bool leader = tid == 0;
  float acc[MT][NT][4];
  float sum1[NT][2], sum2[NT][2];   // this thread's columns, all its items
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) sum1[n][j] = sum2[n][j] = 0.f;

  int it = 0;   // stages consumed so far, over all items
  for (int mt = m_first; mt < m_tiles; mt += m_step) {
    const int m0 = mt * BM;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int s = it % STAGES;
      const uint8_t* xs = ring + s * C::STAGE_BYTES;
      const uint8_t* ws = xs + XT::BYTES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      __syncwarp();   // the fragment reads are .aligned
      // the stage's products in a zeroed accumulator
      float p[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[m][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int kc = kk * 2;   // the k-step's first 16-byte chunk
        // K8: the scale and shift of this thread's two depth columns of the
        // k-step, t and t + 4
        float sc[2], sh[2];
        if (PRO) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = kb * BK + 8 * kk + 4 * j + ln.t;
            sc[j] = k < a.K ? __ldg(a.scale + k) : 0.f;
            sh[j] = k < a.K ? __ldg(a.shift + k) : 0.f;
          }
        }
        tf32::FragA fa[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float x[4];
          tf32::ldsm_x4(x, xs + (row0 + 16 * m) * 128 + ln.a_row +
                               ((kc << 4) ^ ln.a_xor));
          if (PRO) {
            // x[0], x[1] sit in column t of the k-step, x[2], x[3] in t + 4
            x[0] = prologue(x[0], sc[0], sh[0]);
            x[1] = prologue(x[1], sc[0], sh[0]);
            x[2] = prologue(x[2], sc[1], sh[1]);
            x[3] = prologue(x[3], sc[1], sh[1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32::split(x[i], fa[m].hi[i], fa[m].lo[i]);
        }
        tf32::FragB fb[NT];
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          float w[4];
          tf32::ldsm_x4(w, ws + (col0 + 8 * n) * 128 + ln.b_row +
                               ((kc << 4) ^ ln.b_xor));
          fb[n].set(w[0], w[1]);
          fb[n + 1].set(w[2], w[3]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n) tf32::mma3(p[m][n], fa[m], fb[n]);
      }
      mbar_arrive(&empty[s]);   // this thread is done with the stage
      if (tid == 0 && it + STAGES < uses) {
        mbar_wait(&empty[s], (it / STAGES) & 1);
        load(it + STAGES);
      }
      // added into the running sums on the CUDA cores, rounded to nearest
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += p[m][n][e];
    }

    // y through the staging tile: free once the previous item's store has
    // read it
    if (leader) bulk_wait_read<0>();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * m + ln.g + 8 * h;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = col0 + 8 * n + 2 * ln.t;
          const int chunk = (col % 32) / 4;
          *reinterpret_cast<float2*>(
              sy + (col / 32) * YT::BOX_BYTES + r * 128 +
              ((chunk ^ (r & 7)) << 4) + (col % 4) * 4) =
              make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        }
      }
    fence_proxy_async();
    __syncthreads();
    if (leader) {
#pragma unroll
      for (int bx = 0; bx < YT::BOXES; ++bx)
        if (n0 + bx * YT::BOX_COLS < a.N)
          tma_store_2d(&tm_y, sy + bx * YT::BOX_BYTES,
                       n0 + bx * YT::BOX_COLS, m0);
      bulk_commit();
    }
    // the statistics of the item's rows below M, in a fixed order
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = m0 + row0 + 16 * m + ln.g;
      const bool ok0 = r < a.M, ok1 = r + 8 < a.M;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float cc = cs[col0 + 8 * n + 2 * ln.t + j];
          const float d0 = ok0 ? acc[m][n][j] - cc : 0.f;
          const float d1 = ok1 ? acc[m][n][2 + j] - cc : 0.f;
          sum1[n][j] += d0 + d1;
          sum2[n][j] += d0 * d0 + d1 * d1;
        }
    }
  }

  // over the 8 lanes that share a column (lane bits 2 to 4)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        sum1[n][j] += __shfl_xor_sync(0xffffffffu, sum1[n][j], off);
        sum2[n][j] += __shfl_xor_sync(0xffffffffu, sum2[n][j], off);
      }
  // over the warps along M in a fixed order, gathered in the ring, which
  // every thread is done with (and every load has landed)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // [WM][2][BN]
  if (ln.g == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + 8 * n + 2 * ln.t + j;
        red[(wm * 2) * BN + col] = sum1[n][j];
        red[(wm * 2 + 1) * BN + col] = sum2[n][j];
      }
  }
  __syncthreads();
  const size_t prow = (size_t)(blockIdx.x / n_tiles) * a.N;
  for (int e = tid; e < 2 * BN; e += THREADS) {
    const int st = e / BN, col = e % BN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < C::WM; ++w) v += red[(w * 2 + st) * BN + col];
    if (n0 + col < a.N) (st ? a.part2 : a.part1)[prow + n0 + col] = v;
  }
  // the block's shared memory must outlive the last store's reads
  if (leader) bulk_wait<0>();
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

}  // namespace f32

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

// The three tensor maps of a bf16 launch: x (M, K) and w (N, K) in boxes
// of 64 depth columns (BM and BN rows), y (M, N) in one consumer's boxes of
// 64 columns and 64 rows.
template <int BN>
int encode_maps(CUtensorMap* tm_x, CUtensorMap* tm_w, CUtensorMap* tm_y,
                const void* x, const void* w, const void* y, int M, int N,
                int K) {
  using C = Cfg<BN>;
  int rc = encode_matrix_map<typename C::XT>(tm_x, x, K, M, K, BM);
  if (rc == 0) rc = encode_matrix_map<typename C::WT>(tm_w, w, K, N, K, BN);
  if (rc == 0) rc = encode_matrix_map<typename C::YT>(tm_y, y, N, M, N, 64);
  return rc;
}

// Partial rows of a bf16 launch: the blocks of one n-tile, one an SM at
// most, no more than the m-tiles.
inline int bf16_rows(int M, int N, int BN) {
  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  int rows = sm_count() / n_tiles;
  if (rows > m_tiles) rows = m_tiles;
  return rows < 1 ? 1 : rows;
}

template <int BN, bool PRO>
int launch_sm90(const void* x, const void* w, const Args& args, void* y,
                float* s, int part_rows, int grid_rows, cudaStream_t st) {
  using C = Cfg<BN>;
  auto kern = matmul_stats_sm90_kernel<BN, PRO>;
  // above 48 KB a block's dynamic shared memory needs this opt-in, once
  // per instantiation and device; a launch refused for it would never run
  // and synchronize() would not say so
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
  CUtensorMap tm_x, tm_w, tm_y;
  const int rc = encode_maps<BN>(&tm_x, &tm_w, &tm_y, x, w, y, args.M,
                                 args.N, args.K);
  if (rc != 0) return rc;
  const int n_tiles = (args.N + BN - 1) / BN;
  const int rows = grid_rows ? grid_rows : bf16_rows(args.M, args.N, BN);
  if (rows > part_rows) return (int)cudaErrorInvalidValue;
  if (rows > (args.M + BM - 1) / BM) return (int)cudaErrorInvalidValue;
  kern<<<rows * n_tiles, THREADS, C::SMEM, st>>>(tm_x, tm_w, tm_y, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  f32::stats_reduce_kernel<<<(args.N + f32::RED_COLS - 1) / f32::RED_COLS,
                             f32::RED_COLS * f32::RED_ROWS, 0, st>>>(
      args.part1, args.part2, rows, args.N, s, s + args.N);
  return (int)cudaGetLastError();
}

// The tile width of a bf16 launch: at most what N needs (64, 128 or 256
// columns; 256-column tiles above), the width of least cost, a block's
// rounds of items times (width + ITEM_COST), the wider on a tie.
// ITEM_COST, a per-item cost in columns, weighs the uneven last round of a
// wide tile (25088 x 1024 x 256 runs 0.030 ms in 128-column tiles, 0.037
// in 256, NVIDIA H100 80GB HBM3, tools/matmul_stats_experiment.py) against
// the extra items and reads of x of a narrow one.  K8 keeps the widest:
// every n-tile's blocks transform x again.
constexpr int ITEM_COST = 64;

inline int widest_tile(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

inline int bf16_tile(int M, int N, bool pro) {
  const int widest = widest_tile(N);
  if (pro) return widest;
  const long long m_tiles = (M + BM - 1) / BM;
  int best = widest;
  long long best_cost = -1;
  for (int bn = widest; bn >= 64; bn /= 2) {
    const long long rows = bf16_rows(M, N, bn);
    const long long cost = (m_tiles + rows - 1) / rows * (bn + ITEM_COST);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <bool PRO>
int launch_bf16(const void* x, const void* w, const Args& args, void* y,
                float* s, int part_rows, int tile, int grid_rows,
                cudaStream_t st) {
  // TMA: 16-byte bases and row strides; K8's float4 loads of scale, shift
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (args.K % 8 != 0 || args.N % 8 != 0 || misaligned(x) ||
      misaligned(w) || misaligned(y) ||
      (PRO && (misaligned(args.scale) || misaligned(args.shift))))
    return (int)cudaErrorInvalidValue;
  // a tile of the caller's must be one the kernel is built for and no
  // wider than N needs
  if (tile != 0 && ((tile != 64 && tile != 128 && tile != 256) ||
                    tile > widest_tile(args.N)))
    return (int)cudaErrorInvalidValue;
  switch (tile ? tile : bf16_tile(args.M, args.N, PRO)) {
    case 64:
      return launch_sm90<64, PRO>(x, w, args, y, s, part_rows, grid_rows,
                                  st);
    case 128:
      return launch_sm90<128, PRO>(x, w, args, y, s, part_rows, grid_rows,
                                   st);
    default:
      return launch_sm90<256, PRO>(x, w, args, y, s, part_rows, grid_rows,
                                   st);
  }
}

// The three tensor maps of an f32 launch: x (M, K) and w (N, K) in boxes
// of 32 depth columns (BM and BN rows), y (M, N) in boxes of 32 columns and
// BM rows.
template <int BN>
int encode_maps_f32(CUtensorMap* tm_x, CUtensorMap* tm_w, CUtensorMap* tm_y,
                    const void* x, const void* w, const void* y, int M,
                    int N, int K) {
  using C = f32::Cfg<BN>;
  int rc = encode_matrix_map<typename C::XT>(tm_x, x, K, M, K, f32::BM);
  if (rc == 0) rc = encode_matrix_map<typename C::WT>(tm_w, w, K, N, K, BN);
  if (rc == 0)
    rc = encode_matrix_map<typename C::YT>(tm_y, y, N, M, N, f32::BM);
  return rc;
}

template <int BN, bool PRO>
int launch_tf32(const void* x, const void* w, const Args& args, void* y,
                float* s, int part_rows, int grid_rows, cudaStream_t st) {
  using C = f32::Cfg<BN>;
  auto kern = f32::matmul_stats_tf32_kernel<BN, PRO>;
  // the dynamic shared memory opt-in, once per instantiation and device
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
  CUtensorMap tm_x, tm_w, tm_y;
  const int rc = encode_maps_f32<BN>(&tm_x, &tm_w, &tm_y, x, w, y, args.M,
                                     args.N, args.K);
  if (rc != 0) return rc;
  const int n_tiles = (args.N + BN - 1) / BN;
  // the same grid rule as bf16's
  const int rows = grid_rows ? grid_rows : bf16_rows(args.M, args.N, BN);
  if (rows > part_rows) return (int)cudaErrorInvalidValue;
  if (rows > (args.M + f32::BM - 1) / f32::BM)
    return (int)cudaErrorInvalidValue;
  kern<<<rows * n_tiles, f32::THREADS, C::SMEM, st>>>(tm_x, tm_w, tm_y,
                                                       args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  f32::stats_reduce_kernel<<<(args.N + f32::RED_COLS - 1) / f32::RED_COLS,
                             f32::RED_COLS * f32::RED_ROWS, 0, st>>>(
      args.part1, args.part2, rows, args.N, s, s + args.N);
  return (int)cudaGetLastError();
}

template <bool PRO>
int launch_f32(const void* x, const void* w, const Args& args, void* y,
               float* s, int part_rows, int tile, int grid_rows,
               cudaStream_t st) {
  // TMA: 16-byte bases and row strides
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (args.K % 4 != 0 || args.N % 4 != 0 || misaligned(x) ||
      misaligned(w) || misaligned(y))
    return (int)cudaErrorInvalidValue;
  if (tile != 0 && ((tile != 64 && tile != 128) ||
                    (tile == 128 && args.N <= 64)))
    return (int)cudaErrorInvalidValue;
  if (tile == 64 || (tile == 0 && args.N <= 64))
    return launch_tf32<64, PRO>(x, w, args, y, s, part_rows, grid_rows, st);
  return launch_tf32<128, PRO>(x, w, args, y, s, part_rows, grid_rows, st);
}

// Both entries: PRO selects the prologue variant (scale and shift are then
// (K,) f32, else unused).
template <bool PRO>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, const float* c, void* y, float* part,
           float* s, int M, int N, int K, int part_rows, int tile,
           int grid_rows, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || part_rows < 1 || tile < 0 || grid_rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args args{c, scale, shift, part, part + (size_t)part_rows * N,
                  M, N, K};
  if (dtype == 1)
    return launch_bf16<PRO>(x, w, args, y, s, part_rows, tile, grid_rows, st);
  if (dtype == 0)
    return launch_f32<PRO>(x, w, args, y, s, part_rows, tile, grid_rows, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  c: (N,) f32 or null (0).  part: f32
// scratch of 2 x part_rows x N values, part_rows at least the card's SM
// count; s: 2 x N f32, s1 then s2.  bf16 needs K % 8 == 0, N % 8 == 0 and
// 16-byte aligned x, w and y (and, in K8, scale and shift); f32 K % 4 ==
// 0, N % 4 == 0 and 16-byte aligned x, w and y.  tile: columns of w a
// block's n-tile, 0 for the built-in choice (bf16_tile; the widest for K8,
// 64 or 128 by N in f32), else 64, 128 or 256 in bf16, 64 or 128 in f32, no
// wider than N needs (widest_tile).  rows: blocks an n-tile (the persistent
// grid's rows), 0 for the built-in bf16_rows, else at most part_rows and the
// m-tiles.  Returns 0, a cudaError_t code, or an sm90 encode error
// (mxtt_matmul_stats_error_string).
int mxtt_matmul_stats(const void* x, const void* w, const float* c, void* y,
                      float* part, float* s, int M, int N, int K,
                      int part_rows, int tile, int rows, int dtype,
                      void* stream) {
  return launch<false>(x, w, nullptr, nullptr, c, y, part, s, M, N, K,
                       part_rows, tile, rows, dtype, stream);
}

// K8: as mxtt_matmul_stats, of relu(x * scale + shift) rounded to x's dtype.
int mxtt_matmul_stats_prologue(const void* x, const void* w,
                               const float* scale, const float* shift,
                               const float* c, void* y, float* part,
                               float* s, int M, int N, int K, int part_rows,
                               int tile, int rows, int dtype, void* stream) {
  return launch<true>(x, w, scale, shift, c, y, part, s, M, N, K, part_rows,
                      tile, rows, dtype, stream);
}

// The three tensor-map encodes of a bf16 launch alone, for measuring the
// host's cost a call; returns 0 or an encode error.
int mxtt_matmul_stats_encode(const void* x, const void* w, const void* y,
                             int M, int N, int K) {
  CUtensorMap tm_x, tm_w, tm_y;
  switch (bf16_tile(M, N, false)) {
    case 64:
      return encode_maps<64>(&tm_x, &tm_w, &tm_y, x, w, y, M, N, K);
    case 128:
      return encode_maps<128>(&tm_x, &tm_w, &tm_y, x, w, y, M, N, K);
    default:
      return encode_maps<256>(&tm_x, &tm_w, &tm_y, x, w, y, M, N, K);
  }
}

const char* mxtt_matmul_stats_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
