// K9: one ResNet stage-1 bottleneck block in one kernel, for Hopper (sm_90a).
//
// Replaces: tools/pallas_block_experiment.py, pallas_block (its Pallas
// kernel _block_kernel), the repo's experiment on whether a whole
// bottleneck kept on chip beats three library convolutions with eager
// BatchNorm-ReLU between them.
//
// Computes, for x (N, 56, 56, CIN) bf16 NHWC, w1 (CIN, CMID), w2 (9, CMID,
// CMID) (tap dy*3+dx, input channel, output channel), w3 (CMID, COUT), all
// bf16, and scales, shifts (3, cmax) f32 (row i: the i-th folded BatchNorm):
//   a  = relu(x * s0 + b0)                  1x1 CIN -> CMID:  t1 = a @ w1
//   t1 = relu(t1 * s1 + b1), 0 outside the image (the conv's zero padding)
//   t2 = relu((3x3 conv of t1 with w2) * s2 + b2)
//   y  = t2 @ w3                            (N, 56, 56, COUT) bf16
// with f32 accumulation and a, t1, t2 rounded to bf16 before each product,
// where the library route rounds them between its convolutions.  CIN and
// COUT are multiples of 16 in [16, 256], CMID one of 16, 32, 48, 64: both
// stage-1 channel sets of a deep ResNet, (64, 64, 256) and (256, 64, 256).
// The TPU kernel's band height (`rows`) does not change y; this kernel
// picks its own (choose_band).
//
// What bounds it on this card: at (64, 64, 256) a block does 2 * 57344
// flops for each output pixel and moves 128 bytes of x and 512 of y, 179
// flops a byte, under the 295 at which the H100's tensor cores overtake its
// memory (the H100 SXM data sheet's 989 TFLOP/s bf16 and 3.35 TB/s, at its
// 700 W limit): bytes bound it, 0.077 ms at batch 128; at (256, 64, 256)
// 136 flops a byte, 0.123 ms.  So x is read once and y written once, and
// t1 and t2 never leave the SM.
//
// The design (each choice timed at batch 128 on an NVIDIA H100 80GB HBM3,
// 700 W, by variants of this file against it; PERF.md keeps the numbers):
// * Persistent: one block an SM walks (image, band) items, a band being R
//   image rows, an even divisor of 56 (choose_band: whole images at batch
//   128; 8-row bands took 1.02x at (64, 64, 256) and 1.13x at (256, 64,
//   256), 2-row bands 1.26x and 1.50x, from the halo's extra stage-1
//   rows).  Every tile is one image row: the 64 positions w = -1 ..
//   62 of a row and its one-cell halo, so an M tile of wgmma (64 rows) is a
//   row, a band of R output rows needs R + 2 rows of t1, and positions 57
//   .. 63 are computed and never stored.
// * A producer warp issues every TMA load.  The weights come once, in
//   strips of 8 output channels that land as MN-major interleaved operands
//   (interleaved_mnmajor), w1 first and w2 and w3 after the first two rows
//   of x, so that stage 1 starts while they land.  x comes in 4-d boxes of
//   (64 channels, 64 positions, 1 row, 1 image) starting at (c, -1, row,
//   img), SWIZZLE_128B.  TMA fills what lies outside the tensor with zeros
//   (the rows above and below the image, w = -1 and w >= 56), which
//   replaces the bounds checks of a load by threads; those cells become
//   relu(b0) after the first BN and the t1 they give is set to 0, as the
//   padding wants.  Each consumer's next row is fetched into L2 while its
//   ring has no room (1.01x to 1.02x at (256, 64, 256), whose rings hold
//   half a row; nothing at (64, 64, 256)).
// * Two consumer warpgroups take the rows of a band in turns: consumer c
//   computes t1 rows h = c, c + 2, ... (haloed row h is image row r0 - 1 +
//   h) and output rows j = c, c + 2, ..., each after the t1 row j + 2 it
//   owns.  Each has its own x ring of `stages` stages (one 64-channel chunk
//   of one row each, a full and an empty mbarrier each), so every barrier
//   is waited on by one warpgroup in order.  t1 rows live in one ring of
//   `slots` rows shared by both: a full barrier (the writer's 128 threads)
//   and an empty one (all 256 consumer threads, each once it has read the
//   row for the last time; a row a consumer never reads it waits for, then
//   releases, so both consumers see every phase of every slot in order).
//   With at least 4 slots neither consumer can fall a whole phase behind.
//   (One arrival a warp instead of one a thread measured the same.)
// * Stage 1, per t1 row: each landed x chunk is rewritten in place as
//   bf16(relu(x * s0 + b0)) by its consumer (a 16-byte unit a thread,
//   branch-free), fence.proxy.async and a warpgroup barrier, then wgmma
//   m64nCMIDk16 with A the chunk (K-major, SWIZZLE_128B) and B w1, each
//   chunk's products waited for before the next chunk.  The epilogue
//   applies the second BN-ReLU, writes 0 outside the image and stores t1 as
//   bf16 in the interleaved layout: planes of 8 channels, each a row's 64
//   positions of 16 bytes.
// * Stage 2, per output row j: the 3x3 as 9 taps x CMID / 16 products of
//   m64nCMIDk16, A the t1 row j + dy read from position dx on.  In the
//   interleaved layout a tile may start on any position (8 positions are
//   128 contiguous bytes), so the shifted tiles need no swizzle arithmetic;
//   a SWIZZLE_128B t1 read from a row that is not on the pattern's 8-row
//   period gives permuted numbers without a fault.  Positions past a row's
//   64 read the next plane: they feed only the 8 unstored outputs.
// * Stage 3 chained per row, as flash attention chains S into P V: the
//   stage-2 accumulator takes BN-ReLU in registers, is rounded to bf16 and
//   becomes the register A operand of wgmma m64n64k16 over 64-column chunks
//   of w3 (the last chunk 16, 32 or 48 wide): t2 never touches shared
//   memory.  Each chunk's y goes through a staging tile (SWIZZLE_128B) and
//   leaves by a TMA store of its 56 real rows (columns past COUT are not
//   written), waited for only before the staging tile is written again.
// * The second and third BatchNorms of a thread's accumulator columns stay
//   in registers for the block's life, and every BN-ReLU is an f32 FMA and
//   one cvt.rn.relu.bf16x2.  No atomics: two launches give the same
//   bits.
//
// Where trouble was likely, and what resolved it:
// * Shared memory at cin = 256 (make_plan): resident bf16 weights take
//   136 KB (w1 32, w2 72, w3 32).  One row of t1 is 8 KB, so a ring of 4 to
//   6 rows (not a haloed band) holds t1; y is staged 64 columns at a time
//   (8 KB a consumer); the x rings get the rest, 2 stages a consumer at
//   (256, 64, 256) and 4 at (64, 64, 256).
// * The 3x3's shifted A tiles: the interleaved layout above.
// * M tiles: a tile is a row of 64 positions, 56 of them real, so no tile
//   straddles two image rows, and a store of 56 rows writes nothing past the
//   band.
// * Registers: no setmaxnreg (two warpgroups and a warp: 224 registers a
//   thread by launch bounds); stage 3 runs 64 columns at a time.
//   chip_smoke's build phase fails on a spill.
// * ptxas serializes wgmmas (its warnings C7514 to C7520) on a branch on
//   one thread (the y store) while products are in flight (1.40x and
//   1.26x slower: so each chunk of stage 3 ends before its epilogue) and
//   on a guard around single products (C7519, 1.01x: so a chunk's k-steps
//   are a switch over whole groups, s1_products).  The first build, whose
//   consumers' trip counts differed (odd bands) and whose operand fences
//   followed wgmma.fence, warned C7518 and C7519 as well: R is even, so
//   both consumers run R / 2 rows, and fence_regs comes first.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbottleneck_block-<hash>.so this file
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int H = 56;
constexpr int W = 56;
constexpr int TP = 64;          // positions of a row tile: w = -1 .. 62
constexpr int CH = 64;          // channels of an x chunk: 128-byte rows
constexpr int CONSUMERS = 2;    // warpgroups
constexpr int THREADS = CONSUMERS * WG + 32;   // + the producer warp
constexpr int MAX_STAGES = 4;   // x chunks in a consumer's ring
constexpr int MIN_SLOTS = 4;    // t1 rows in the shared ring
constexpr int MAX_SLOTS = 6;
using XT = Tile<CH, TP>;        // an x chunk, or a y staging tile
constexpr int CHUNK = XT::BYTES;       // 8192
constexpr int PLANE = TP * 16;         // 8 channels of a t1 row
constexpr int GUARD = 128;      // read (never used) past the last t1 row
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory on the H100
constexpr int SMEM_STATIC = 256;       // the mbarriers, rounded up
constexpr int SMEM_MAX = SMEM_LIMIT - SMEM_STATIC;
// named barriers: BAR_X + c consumer c's x chunk rewritten; BAR_Y + c its
// y staging free, then written
constexpr int BAR_X = 2;
constexpr int BAR_Y = 4;

// A launch's shapes and shared-memory layout, made on the host (make_plan).
// Offsets are bytes from the 1024-aligned base: the x rings at 0
// (consumer c's stages at c * stages * CHUNK), then the y staging tiles,
// w1, w2, w3 (strips of 8 output channels), the t1 ring and its guard.
struct Plan {
  int cin, cout, cmax;
  int band, bands, items;   // band height, bands an image, n * bands
  int nch;                  // x chunks a row: ceil(cin / 64)
  int stages, slots;
  int ys, w1, w2, w3, t1, smem;
};

// bf16x2(relu(v * s + b)) of two neighbouring channels (lo, hi): an f32
// FMA, then relu and the rounding to bf16 in one instruction.
__device__ __forceinline__ uint32_t bn_relu2(float lo, float hi, float2 s,
                                             float2 b) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;"
      : "=r"(r)
      : "f"(fmaf(hi, s.y, b.y)), "f"(fmaf(lo, s.x, b.x)));
  return r;
}

// bf16(relu(x * s0 + b0)) in place over consumer c's landed x chunk k: a
// thread takes the 16-byte unit ctid % 8 (8 channels) of positions
// ctid / 8 + 16 m, through the swizzle.  Branch-free: positions 0 and
// 57 .. 63 are masked in t1 whatever they hold, and channels past cin
// (their scale and shift read at cin - 1) are never read.
__device__ __forceinline__ void rewrite_chunk(uint8_t* xs, int k, int ctid,
                                              int cin,
                                              const float* __restrict__ s0,
                                              const float* __restrict__ b0) {
  const int cc = ctid & 7;
  const int ch = k * CH + 8 * cc;
  float s[8], b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s[e] = __ldg(s0 + min(ch + e, cin - 1));
    b[e] = __ldg(b0 + min(ch + e, cin - 1));
  }
#pragma unroll
  for (int m = 0; m < TP / 16; ++m) {
    const int pos = (ctid >> 3) + 16 * m;
    uint4* ptr = reinterpret_cast<uint4*>(
        xs + pos * 128 + ((cc ^ XT::swizzle_key(pos)) << 4));
    uint4 v = *ptr;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
      w[e] = bn_relu2(f.x, f.y, make_float2(s[2 * e], s[2 * e + 1]),
                      make_float2(b[2 * e], b[2 * e + 1]));
    }
    *ptr = v;
  }
}

// Stage 1, the KS k-steps of x chunk k (landed at xa) times w1's rows,
// issued, committed and waited for: a whole group in each arm of a switch
// on the count.  A guard on each product (kk tested against the chunk's
// k-steps) makes ptxas warn C7519 and costs 1.01x; a group that spans the
// switch's branches warned C7520.
template <int KS, int CMID>
__device__ __forceinline__ void s1_products(float (&acc)[CMID / 2],
                                            uint32_t xa, uint32_t w1a,
                                            int cin, int k) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<0, 1>(acc, XT::kmajor(xa, 0, kk),
                   interleaved_mnmajor(w1a + (64 * k + 16 * kk) * 16,
                                       cin * 16),
                   k > 0 || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Stage 3 for NC columns of y from n0 of one output row: t2 (registers,
// the A operand) times w3's columns; once the products have ended, y goes
// through consumer c's staging tile and a TMA store of the row's 56
// positions.  The leader's store (a branch on one thread) runs with no
// product in flight: issuing the next chunk's products before this
// chunk's epilogue made ptxas serialize the wgmmas (C7514, C7517) and
// took 1.40x at (64, 64, 256), 1.26x at (256, 64, 256).
template <int NC, int CMID>
__device__ __forceinline__ void s3_chunk(const uint32_t (&a)[CMID / 16][4],
                                         uint32_t w3a, int cout, int n0,
                                         uint8_t* ys, const CUtensorMap* tm_y,
                                         int yrow, int c, int warp, int lane,
                                         bool leader) {
  float acc[NC / 2];
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < CMID / 16; ++kk)
    wgmma_rs<1>(acc, a[kk],
                interleaved_mnmajor(w3a + (n0 / 8 * CMID + 16 * kk) * 16,
                                    CMID * 16),
                kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  // the staging tile is free once the previous store has read it
  if (leader) bulk_wait_read<0>();
  bar_sync(BAR_Y + c, WG);
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int row = acc_row(warp, lane, i), col = acc_col(lane, i);
    *reinterpret_cast<uint32_t*>(
        ys + XT::offset(row, col, XT::swizzle_key(row))) =
        pack_bf16(acc[i], acc[i + 1]);
  }
  fence_proxy_async();
  bar_sync(BAR_Y + c, WG);
  if (leader) {
    tma_store_2d(tm_y, ys, n0, yrow);
    bulk_commit();
  }
}

// Stage 3 of one output row over all cout columns: 64-column chunks, then
// a last chunk of 16, 32 or 48 columns.
template <int CMID>
__device__ __forceinline__ void stage3(const uint32_t (&a)[CMID / 16][4],
                                       uint32_t w3a, int cout, uint8_t* ys,
                                       const CUtensorMap* tm_y, int yrow,
                                       int c, int warp, int lane,
                                       bool leader) {
  const int nfull = cout / 64;
  for (int n = 0; n < nfull; ++n)
    s3_chunk<64, CMID>(a, w3a, cout, n * 64, ys, tm_y, yrow, c, warp, lane,
                       leader);
  const int n0 = nfull * 64;
  switch (cout - n0) {
    case 48:
      s3_chunk<48, CMID>(a, w3a, cout, n0, ys, tm_y, yrow, c, warp, lane,
                         leader);
      break;
    case 32:
      s3_chunk<32, CMID>(a, w3a, cout, n0, ys, tm_y, yrow, c, warp, lane,
                         leader);
      break;
    case 16:
      s3_chunk<16, CMID>(a, w3a, cout, n0, ys, tm_y, yrow, c, warp, lane,
                         leader);
      break;
    default:
      break;
  }
}

template <int CMID>
__global__ void __launch_bounds__(THREADS, 1)
bottleneck_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_y,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w2,
                       const __grid_constant__ CUtensorMap tm_w3,
                       const float* __restrict__ scales,
                       const float* __restrict__ shifts, const Plan p) {
  constexpr int SLOT = CMID * TP * 2;   // one t1 row: CMID / 8 planes
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_x[CONSUMERS][MAX_STAGES];
  __shared__ uint64_t empty_x[CONSUMERS][MAX_STAGES];
  __shared__ uint64_t full_t1[MAX_SLOTS], empty_t1[MAX_SLOTS];
  __shared__ uint64_t wbar[2];   // w1 landed; w2 and w3 landed
  uint8_t* sm = align1024(smem_raw);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int c = 0; c < CONSUMERS; ++c)
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&full_x[c][s], 1);
        mbar_init(&empty_x[c][s], WG);
      }
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(&full_t1[s], WG);
      mbar_init(&empty_t1[s], CONSUMERS * WG);
    }
    mbar_init(&wbar[0], 1);
    mbar_init(&wbar[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform to the compiler as to the card
  const int role = __shfl_sync(0xffffffffu, tid / WG, 0);
  if (role == CONSUMERS) {
    // the producer warp: one thread issues every load.  Haloed row h of an
    // item goes to consumer h % 2's ring, in the order that consumer takes
    // them.
    if (tid == CONSUMERS * WG) {
      // the weights in strips of 8 output channels (one box each): w1
      // first, w2 and w3 after the first two rows of x, so that stage 1
      // starts while they land
      mbar_expect_tx(&wbar[0], p.cin * CMID * 2);
      for (int n = 0; n < CMID; n += 8)
        tma_load_2d(sm + p.w1 + n * p.cin * 2, &tm_w1, &wbar[0], n, 0);
      bool w23 = false;
      int q0 = 0, q1 = 0;   // chunks loaded into each ring so far
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int img = item / p.bands;
        const int r0 = (item % p.bands) * p.band;
        for (int h = 0; h < p.band + 2; ++h) {
          const int c = h & 1;
          // consumer c's next row, into L2 while this one waits for room
          if (h + 2 < p.band + 2)
            for (int k = 0; k < p.nch; ++k)
              tma_prefetch_4d(&tm_x, k * CH, -1, r0 + 1 + h, img);
          int q = c ? q1 : q0;
          for (int k = 0; k < p.nch; ++k, ++q) {
            const int s = q % p.stages;
            if (q >= p.stages)
              mbar_wait(&empty_x[c][s], (q / p.stages - 1) & 1);
            uint8_t* dst = sm + (c * p.stages + s) * CHUNK;
            mbar_expect_tx(&full_x[c][s], CHUNK);
            tma_load_4d(dst, &tm_x, &full_x[c][s], k * CH, -1, r0 - 1 + h,
                        img);
          }
          if (c) q1 = q; else q0 = q;
          if (!w23 && h == 1) {
            mbar_expect_tx(&wbar[1], (9 * CMID * CMID + CMID * p.cout) * 2);
            for (int tap = 0; tap < 9; ++tap)
              for (int n = 0; n < CMID; n += 8)
                tma_load_2d(sm + p.w2 + (tap * CMID + n) * CMID * 2, &tm_w2,
                            &wbar[1], n, tap * CMID);
            for (int n = 0; n < p.cout; n += 8)
              tma_load_2d(sm + p.w3 + n * CMID * 2, &tm_w3, &wbar[1], n, 0);
            w23 = true;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup c
  const int c = role;
  const int ctid = tid % WG;
  const int warp = ctid / 32;
  const int lane = tid % 32;
  const bool leader = ctid == 0;
  uint8_t* xring = sm + c * p.stages * CHUNK;
  uint8_t* ys = sm + p.ys + c * CHUNK;
  // the plan's fields the loops read, held in registers (the lambdas
  // below capture by reference)
  const int cin = p.cin, cout = p.cout, nch = p.nch, stages = p.stages;
  const int slots = p.slots, band = p.band, bands = p.bands;

  // the second and third BatchNorms of this thread's accumulator columns
  // 8 n + 2 (lane % 4) + {0, 1}, in registers for the block's life
  float2 s1[CMID / 8], b1[CMID / 8], s2[CMID / 8], b2[CMID / 8];
#pragma unroll
  for (int n = 0; n < CMID / 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
    s1[n] = make_float2(scales[p.cmax + col], scales[p.cmax + col + 1]);
    b1[n] = make_float2(shifts[p.cmax + col], shifts[p.cmax + col + 1]);
    s2[n] = make_float2(scales[2 * p.cmax + col],
                        scales[2 * p.cmax + col + 1]);
    b2[n] = make_float2(shifts[2 * p.cmax + col],
                        shifts[2 * p.cmax + col + 1]);
  }
  mbar_wait(&wbar[0], 0);   // w1; w2 and w3 before the first output row
  bool w23 = false;
  const uint32_t w1a = smem_u32(sm + p.w1);
  const uint32_t w2a = smem_u32(sm + p.w2);
  const uint32_t w3a = smem_u32(sm + p.w3);
  uint8_t* t1s = sm + p.t1;
  const uint32_t t1a = smem_u32(t1s);

  int qx = 0;   // x chunks this consumer has taken
  int li = 0;   // the block's items so far
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++li) {
    const int img = item / bands;
    const int r0 = (item % bands) * band;
    const int R = band;
    const int base = li * (R + 2);   // the block's t1 row count before it

    // ---- stage 1: t1 row h (image row r0 - 1 + h) into its slot
    auto t1_row = [&](int h) {
      const int G = base + h;
      float acc[CMID / 2];
      for (int k = 0; k < nch; ++k, ++qx) {
        const int s = qx % stages;
        uint8_t* xs = xring + s * CHUNK;
        mbar_wait(&full_x[c][s], (qx / stages) & 1);
        rewrite_chunk(xs, k, ctid, cin, scales, shifts);
        fence_proxy_async();
        bar_sync(BAR_X + c, WG);
        const uint32_t xa = smem_u32(xs);
        switch ((cin - k * CH) / 16) {   // the chunk's k-steps
          case 1:
            s1_products<1, CMID>(acc, xa, w1a, cin, k);
            break;
          case 2:
            s1_products<2, CMID>(acc, xa, w1a, cin, k);
            break;
          case 3:
            s1_products<3, CMID>(acc, xa, w1a, cin, k);
            break;
          default:
            s1_products<4, CMID>(acc, xa, w1a, cin, k);
            break;
        }
        mbar_arrive(&empty_x[c][s]);   // the chunk's stage goes back
      }

      const int slot = G % slots;
      if (G >= slots) mbar_wait(&empty_t1[slot], (G / slots - 1) & 1);
      uint8_t* dst = t1s + slot * SLOT;
      // the thread's two positions (accumulator rows), 0 outside the image
      const int ih = r0 - 1 + h;
      const int pos0 = acc_row(warp, lane, 0);
      const bool row_in = ih >= 0 && ih < H;
      const bool in0 = row_in && pos0 >= 1 && pos0 <= W;
      const bool in1 = row_in && pos0 + 8 >= 1 && pos0 + 8 <= W;
#pragma unroll
      for (int i = 0; i < CMID / 2; i += 2) {
        const int pos = acc_row(warp, lane, i), col = acc_col(lane, i);
        const uint32_t v = bn_relu2(acc[i], acc[i + 1], s1[i >> 2],
                                    b1[i >> 2]);
        *reinterpret_cast<uint32_t*>(dst + (col >> 3) * PLANE + pos * 16 +
                                     (col & 7) * 2) =
            ((i >> 1) & 1 ? in1 : in0) ? v : 0u;
      }
      fence_proxy_async();
      mbar_arrive(&full_t1[slot]);
    };

    // ---- stages 2 and 3: output row j from t1 rows j, j + 1, j + 2
    auto out_row = [&](int j) {
      if (!w23) {
        mbar_wait(&wbar[1], 0);
        w23 = true;
      }
      const int G0 = base + j;
      uint32_t rows[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int G = G0 + d;
        mbar_wait(&full_t1[G % slots], (G / slots) & 1);
        rows[d] = t1a + (G % slots) * SLOT;
      }
      __syncwarp();   // wgmma is .aligned: the warp leaves the waits together
      float acc[CMID / 2];
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int kk = 0; kk < CMID / 16; ++kk)
          wgmma_ss<0, 1>(
              acc,
              interleaved_kmajor(rows[tap / 3] + (tap % 3) * 16 +
                                     2 * kk * PLANE,
                                 PLANE),
              interleaved_mnmajor(w2a + tap * CMID * CMID * 2 + kk * 256,
                                  CMID * 16),
              tap > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // t2 = bf16(relu(acc * s2 + b2)) as the A operand of stage 3: k-step
      // kk's fragment is accumulator columns 16 kk .. 16 kk + 15 (acc_to_a)
      uint32_t a[CMID / 16][4];
#pragma unroll
      for (int kk = 0; kk < CMID / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          a[kk][r] = bn_relu2(acc[i], acc[i + 1], s2[i >> 2], b2[i >> 2]);
          asm volatile("" : "+r"(a[kk][r]));
        }
      stage3<CMID>(a, w3a, cout, ys, &tm_y, (img * H + r0 + j) * W, c, warp,
                   lane, leader);
    };

    // rows this consumer is done with, released in order; a row below
    // `read` (one it has not just read) is waited for first
    int released = 0;
    auto release_upto = [&](int last, int read) {
      for (; released <= last; ++released) {
        const int G = base + released;
        if (released < read)
          mbar_wait(&full_t1[G % slots], (G / slots) & 1);
        mbar_arrive(&empty_t1[G % slots]);
      }
    };

    // R is even, so both consumers take R / 2 output rows: the loops
    // around the products have the same trip count in every warp of the
    // block
    t1_row(c);
    for (int i = 0; i < R / CONSUMERS; ++i) {
      const int j = CONSUMERS * i + c;
      t1_row(j + 2);
      out_row(j);
      release_upto(j + 1, j);   // this consumer reads j + 2 on from here
    }
    release_upto(R + 1, R + 2);
  }
  // the block's shared memory must outlive the last store's reads
  if (leader) bulk_wait<0>();
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

// The band height of a launch: the even divisor of 56 of least cost (even,
// so that the two consumers take as many rows each), a block's
// rounds of items times an item's work (R output rows of stages 2 and 3,
// R + 2 rows of stage 1, each row a tile of 64 positions, plus ROW_COST a
// row for its waits and epilogues), the taller on a tie.  At batch 128 on
// 132 SMs: whole images.
constexpr long long ROW_COST = 4096;

inline int choose_band(int n, int cin, int cmid, int cout) {
  const long long s1 = (long long)cin * cmid + ROW_COST;
  const long long s23 = 9LL * cmid * cmid + (long long)cmid * cout + ROW_COST;
  const long long sms = sm_count();
  int best = 1;
  long long best_cost = -1;
  for (int r = 2; r <= H; r += 2) {
    if (H % r) continue;
    const long long items = (long long)n * (H / r);
    const long long cost = (items + sms - 1) / sms * (r * s23 + (r + 2) * s1);
    if (best_cost < 0 || cost <= best_cost) {
      best = r;
      best_cost = cost;
    }
  }
  return best;
}

// The shared-memory layout: the weights, two y staging tiles, then at
// least MIN_SLOTS t1 rows and one x stage a consumer; what is left goes to
// more x stages (up to MAX_STAGES a consumer), then to more t1 rows.
// Returns 0, or cudaErrorInvalidValue when even the least does not fit.
int make_plan(Plan* p, int n, int cin, int cmid, int cout, int cmax,
              int band) {
  p->cin = cin;
  p->cout = cout;
  p->cmax = cmax;
  p->nch = (cin + CH - 1) / CH;
  p->band = band > 0 ? band : choose_band(n, cin, cmid, cout);
  p->bands = H / p->band;
  p->items = n * p->bands;
  const int slot = cmid * TP * 2;
  const int w1b = cin * cmid * 2, w2b = 9 * cmid * cmid * 2;
  const int w3b = cmid * cout * 2;
  const int fixed = CONSUMERS * CHUNK + w1b + w2b + w3b + GUARD;
  const int avail = SMEM_MAX - 1024 - fixed;
  int stages = (avail - MIN_SLOTS * slot) / (CONSUMERS * CHUNK);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  int slots = (avail - stages * CONSUMERS * CHUNK) / slot;
  if (slots > MAX_SLOTS) slots = MAX_SLOTS;
  p->stages = stages;
  p->slots = slots;
  p->ys = CONSUMERS * stages * CHUNK;
  p->w1 = p->ys + CONSUMERS * CHUNK;
  p->w2 = p->w1 + w1b;
  p->w3 = p->w2 + w2b;
  p->t1 = p->w3 + w3b;
  p->smem = 1024 + p->t1 + slots * slot + GUARD;
  return 0;
}

// A row-major (rows, cols) bf16 weight as a 2-d map in boxes of 8 columns
// and box_rows rows, unswizzled: a box lands as a strip of the interleaved
// MN-major operand (interleaved_mnmajor).
int encode_strips(EncodeTiledFn fn, CUtensorMap* map, const void* w,
                  int cols, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {8, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(w), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// x (n, 56, 56, cin) as the 4-d map (cin, W, H, n) in boxes of (64, 64, 1,
// 1), SWIZZLE_128B, zeros outside; y (n * 56 * 56, cout) as a 2-d map in
// boxes of 64 columns and 56 rows; the weights in strips (encode_strips),
// w2 as (9 cmid, cmid) in boxes of one tap's rows.
int encode_maps(CUtensorMap* tm_x, CUtensorMap* tm_y, CUtensorMap* tm_w,
                const void* x, const void* y, const void* w1, const void* w2,
                const void* w3, int n, int cin, int cmid, int cout) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  int rc = encode_strips(fn, &tm_w[0], w1, cmid, cin, cin);
  if (rc == 0) rc = encode_strips(fn, &tm_w[1], w2, cmid, 9 * cmid, cmid);
  if (rc == 0) rc = encode_strips(fn, &tm_w[2], w3, cout, cmid, cmid);
  if (rc != 0) return rc;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, W, H, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2,
                                 (cuuint64_t)W * cin * 2,
                                 (cuuint64_t)H * W * cin * 2};
  const cuuint32_t box[4] = {CH, TP, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(x), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  return encode_matrix_map<XT>(tm_y, y, cout, (long long)n * H * W, cout, W);
}

template <int CMID>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           const float* scales, const float* shifts, void* y, int n,
           int cin, int cout, int cmax, int band, cudaStream_t st) {
  auto kern = bottleneck_sm90_kernel<CMID>;
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
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  Plan p;
  int rc = make_plan(&p, n, cin, CMID, cout, cmax, band);
  if (rc != 0) return rc;
  CUtensorMap tm_x, tm_y, tm_w[3];
  rc = encode_maps(&tm_x, &tm_y, tm_w, x, y, w1, w2, w3, n, cin, CMID,
                   cout);
  if (rc != 0) return rc;
  const int grid = p.items < sm_count() ? p.items : sm_count();
  kern<<<grid, THREADS, p.smem, st>>>(tm_x, tm_y, tm_w[0], tm_w[1],
                                      tm_w[2], scales, shifts, p);
  return (int)cudaGetLastError();
}

bool channels_ok(int c) { return c >= 16 && c <= 256 && c % 16 == 0; }

bool shape_ok(int n, int h, int w, int cin, int cmid, int cout, int cmax,
              int band) {
  return n >= 1 && h == H && w == W && channels_ok(cin) &&
         channels_ok(cout) && (cmid == 16 || cmid == 32 || cmid == 48 ||
                               cmid == 64) &&
         cmax >= cin && cmax >= cmid &&
         (band == 0 || (band >= 2 && band <= H && H % band == 0 &&
                        band % 2 == 0));
}

}  // namespace

extern "C" {

// x (n, h, w, cin), y (n, h, w, cout), w1, w2, w3 bf16 contiguous and
// 16-byte aligned (TMA); scales, shifts (3, cmax) f32 contiguous.  h =
// w = 56; cin and cout multiples of 16 in [16, 256]; cmid 16, 32, 48 or 64.
// band: the band height (an even divisor of 56), or 0 for the kernel's
// own choice; y does not depend on it.  Returns 0, a cudaError_t code, or an
// sm90 encode error (mxtt_bottleneck_block_error_string).
int mxtt_bottleneck_block(const void* x, const void* w1, const void* w2,
                          const void* w3, const float* scales,
                          const float* shifts, void* y, int n, int h, int w,
                          int cin, int cmid, int cout, int cmax, int band,
                          void* stream) {
  if (!shape_ok(n, h, w, cin, cmid, cout, cmax, band) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2) |
        reinterpret_cast<uintptr_t>(w3)) &
       15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cmid) {
    case 16:
      return launch<16>(x, w1, w2, w3, scales, shifts, y, n, cin, cout, cmax,
                        band, st);
    case 32:
      return launch<32>(x, w1, w2, w3, scales, shifts, y, n, cin, cout, cmax,
                        band, st);
    case 48:
      return launch<48>(x, w1, w2, w3, scales, shifts, y, n, cin, cout, cmax,
                        band, st);
    default:
      return launch<64>(x, w1, w2, w3, scales, shifts, y, n, cin, cout, cmax,
                        band, st);
  }
}

// The plan of a launch, for the record: out[0..5] = band, items, x stages
// a consumer, t1 slots, dynamic shared memory bytes, grid.  Returns 0 or
// cudaErrorInvalidValue.
int mxtt_bottleneck_block_plan(int n, int cin, int cmid, int cout, int band,
                               int* out) {
  const int cmax = cin > cmid ? cin : cmid;
  if (!shape_ok(n, H, W, cin, cmid, cout, cmax, band))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int rc = make_plan(&p, n, cin, cmid, cout, cmax, band);
  if (rc != 0) return rc;
  out[0] = p.band;
  out[1] = p.items;
  out[2] = p.stages;
  out[3] = p.slots;
  out[4] = p.smem;
  out[5] = p.items < sm_count() ? p.items : sm_count();
  return 0;
}

const char* mxtt_bottleneck_block_error_string(int code) {
  return sm90::error_string(code);
}

}  // extern "C"
