// Building blocks of the f32 flash-attention kernels, flash_attention_fwd.cu
// and flash_attention_bwd.cu: f32 products on Hopper's tensor cores as
// split TF32 (3xTF32), the swizzled f32 tiles TMA lays down, the fragment
// reads of mma.sync from them, and the ring of TMA stages both kernels
// stream their tiles through.  The barriers, TMA loads and map encoding
// come from sm90_common.cuh.
//
// Split TF32.  The tensor cores take f32 only as TF32 (10 explicit mantissa
// bits; an mma reads the top 19 bits of each 32-bit operand and ignores the
// rest).  Each operand x is split in registers as hi = tf32(x), rounded to
// nearest (cvt.rna.tf32.f32), and lo = x - hi, exact in f32, and
// a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b: three m16n8k8 TF32 products summed
// in f32, the two small terms first.  Dropped are lo_a lo_b (2^-22 of a b)
// and the bits of lo below TF32's (the mma truncates lo, |lo| <= 2^-11 |x|,
// so at most 2^-21 of x), so a product keeps about 21 of f32's 24 bits,
// where one TF32 product keeps 11.  This is the scheme of CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's f32 scaled_dot_product_attention
// runs (its mem_eff_attention gemm_kernel_utils.h, DefaultGemmType<float>).
//
// Why lo is not rounded as well: on sm_90a cvt.rna.tf32.f32 is no single
// instruction but three (a test, an add and a mask), so a split rounding
// both halves takes seven, where the mma it feeds is one.  On the H100
// rounding lo as well ran the forward 1.16x and the backward 1.25x slower,
// for errors within 2% (tools/flash_f32_experiment.py, variant round_lo).
// hi keeps the cvt, which lets NaN and Inf through as they are.
//
// Why mma.sync and not wgmma: wgmma's .tf32 form takes only K-major
// operands from shared memory, and half the attention products read an
// operand MN-major (V in P V; K in dS K; Q in dS^T Q; dO in P^T dO).  With
// wgmma those would need transposed hi and lo copies in shared memory,
// which at D=128 in f32 do not fit beside a two-stage ring.  mma.sync takes
// its fragments from registers: the split and any transpose happen in the
// register loads, and only the raw f32 tiles (as TMA brings them) live in
// shared memory.
//
// Tiles.  A (ROWS, D) f32 tile is D/32 boxes of (ROWS, 32): rows of 128
// bytes with SWIZZLE_128B, under which the 16-byte chunk c of row r lies at
// chunk c ^ (r & 7).  Every fragment read below follows that XOR, and then
// the 32 lanes of a warp hit 32 banks.
#pragma once

#include "sm90_common.cuh"

namespace tf32 {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::tma_load_4d;

template <int D, int ROWS>
struct TileF32 {
  static_assert(D == 32 || D == 64 || D == 128, "D must be 32, 64 or 128");
  static_assert(ROWS % 8 == 0 && ROWS <= 256, "rows: a multiple of 8");
  static constexpr int SWZ = 128;
  static constexpr int BOX_COLS = 32;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int BOX_BYTES = ROWS * SWZ;
  static constexpr int BYTES = BOXES * BOX_BYTES;
  // what sm90::encode_tile_map reads
  static constexpr int COLS = D;
  static constexpr int ELEM = 4;
  static constexpr CUtensorMapDataType DTYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

  // the TMA loads of rows [t0, t0 + ROWS) of head (b, h) into dst, in
  // boxes of BOX_ROWS rows (the map's box)
  template <int BOX_ROWS>
  __device__ static __forceinline__ void load(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int t0,
                                              int b) {
    static_assert(ROWS % BOX_ROWS == 0, "whole boxes");
#pragma unroll
    for (int x = 0; x < BOXES; ++x)
#pragma unroll
      for (int y = 0; y < ROWS / BOX_ROWS; ++y)
        tma_load_4d(dst + x * BOX_BYTES + y * BOX_ROWS * SWZ, map, bar,
                    x * BOX_COLS, h, t0 + y * BOX_ROWS, b);
  }
};

// --------------------------------------------------------------- products
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi a TF32 value rounded to nearest, lo = x - hi exact in f32,
// of which an mma reads the TF32 part
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product with an f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split A fragment and a split B fragment
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// d += a b in 3xTF32: the small terms first, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// A lane's place in the m16n8k8 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// and the byte offsets of its reads in a swizzled tile.  Row-major
// fragments (D the contraction) come by ldmatrix.x4, which reads four 8x8
// b16 matrices, that is four 8-row by 4-f32 blocks, and hands lane L
// element (L / 4, L % 4) of each: exactly the tf32 fragment layouts.  Lane L
// gives the address of row L % 8 of block L / 8:
//   a_row, a_xor: blocks (rows 0-7, chunk c), (8-15, c), (0-7, c + 1),
//     (8-15, c + 1): a0..a3 of one A fragment;
//   b_row, b_xor: blocks (rows 0-7, c), (0-7, c + 1), (8-15, c),
//     (8-15, c + 1): b0, b1 of two neighbouring n-tiles;
// with the row's part of the swizzle XOR folded into the *_xor terms.
// The permuted B reads of mma_pv (below) are LDS.32: perm is element
// (2t, g) of an 8-row group, ph = (g / 4) ^ 2t its chunk's XOR.
struct Lane {
  int g, t, a_row, a_xor, b_row, b_xor, perm, ph;
  __device__ __forceinline__ explicit Lane(int lane)
      : g(lane >> 2), t(lane & 3),
        a_row(((lane & 7) + 8 * ((lane >> 3) & 1)) * 128),
        a_xor((((lane >> 4) & 1) ^ (lane & 7)) << 4),
        b_row(((lane & 7) + 8 * ((lane >> 4) & 1)) * 128),
        b_xor((((lane >> 3) & 1) ^ (lane & 7)) << 4),
        perm((lane & 3) * 2 * 128 + ((lane >> 2) & 3) * 4),
        ph((lane >> 4) ^ ((lane & 3) * 2)) {}
};

__device__ __forceinline__ float lds(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// four 8x8 b16 matrices (four 8 x 4 f32 blocks) from shared memory
__device__ __forceinline__ void ldsm_x4(float (&r)[4], const uint8_t* p) {
  uint32_t x[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(sm90::smem_u32(p)));
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(x[i]);
}

// c[MT][N/8] += A B^T over the D columns of two tiles: A is rows
// [ra, ra + 16 MT) of tile TA (sa), B rows [0, N) of tile TB (sb), both read
// row-major (D is the contraction): S = Q K^T, dP = dO V^T and the like.
// ra is a multiple of 8, N a multiple of 16.
template <int D, int MT, int N, typename TA, typename TB>
__device__ __forceinline__ void mma_nt(float (&c)[MT][N / 8][4],
                                       const uint8_t* sa, int ra,
                                       const uint8_t* sb, const Lane& ln) {
  static_assert(N % 16 == 0, "B comes two n-tiles at a time");
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int box = kk / 4;
    const int kc = (kk % 4) * 2;   // the k-step's first 16-byte chunk
    FragA a[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float x[4];
      ldsm_x4(x, sa + box * TA::BOX_BYTES + (ra + 16 * mt) * 128 + ln.a_row +
                     ((kc << 4) ^ ln.a_xor));
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x[i], a[mt].hi[i], a[mt].lo[i]);
    }
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      float x[4];
      ldsm_x4(x, sb + box * TB::BOX_BYTES + 8 * j * 128 + ln.b_row +
                     ((kc << 4) ^ ln.b_xor));
      FragB b0, b1;
      b0.set(x[0], x[1]);
      b1.set(x[2], x[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma3(c[mt][j], a[mt], b0);
        mma3(c[mt][j + 1], a[mt], b1);
      }
    }
  }
}

// The A fragments of k-step j of P B, from P's accumulator (see mma_pv)
template <int MT, int NP>
__device__ __forceinline__ void p_frags(FragA (&a)[MT],
                                        const float (&p)[MT][NP][4], int j) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    split(p[mt][j][0], a[mt].hi[0], a[mt].lo[0]);
    split(p[mt][j][2], a[mt].hi[1], a[mt].lo[1]);
    split(p[mt][j][1], a[mt].hi[2], a[mt].lo[2]);
    split(p[mt][j][3], a[mt].hi[3], a[mt].lo[3]);
  }
}

// The B fragment of k-step j, n-tile n of P B: b0 = B[8j + 2t][8n + g],
// b1 = B[8j + 2t + 1][8n + g] of tile TB (sb)
template <typename TB>
__device__ __forceinline__ FragB perm_frag(const uint8_t* sb, int j, int n,
                                           const Lane& ln) {
  const int box = n / 4;
  const int nc = (n % 4) * 2;   // the n-tile's first 16-byte chunk
  const uint8_t* pb = sb + box * TB::BOX_BYTES + 8 * j * 128 + ln.perm;
  FragB bf;
  bf.set(lds(pb + ((nc ^ ln.ph) << 4)),
         lds(pb + 128 + ((nc ^ ln.ph ^ 1) << 4)));
  return bf;
}

// c[MT][D/8] += P B, P (16 MT x N) in registers as the accumulator of an
// mma_nt, B rows [0, N) of tile TB (sb), all D columns: O += P V.
//
// The accumulator layout is not the A layout (c0, c1 sit at columns 2t and
// 2t + 1; a0, a2 want columns t and t + 4), and P is not moved to fix
// that: the contraction index is permuted instead.  k-step j takes A
// column t as key 8j + 2t and column t + 4 as key 8j + 2t + 1, so a thread's
// own accumulator is its A fragment (a0 = c0, a1 = c2, a2 = c1, a3 = c3),
// and B reads the same keys: b0 = B[8j + 2t][n], b1 = B[8j + 2t + 1][n].
// No shuffle and no trip through shared memory.
template <int D, int MT, int N, typename TB>
__device__ __forceinline__ void mma_pv(float (&c)[MT][D / 8][4],
                                       const float (&p)[MT][N / 8][4],
                                       const uint8_t* sb, const Lane& ln) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    FragA a[MT];
    p_frags(a, p, j);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const FragB bf = perm_frag<TB>(sb, j, n, ln);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma3(c[mt][n], a[mt], bf);
    }
  }
}

// mma_pv for a long sum (dK, dV, dQ over every tile of the loop): the
// tensor cores add into their f32 accumulator with truncation (round
// toward zero), so a sum carried across thousands of products drifts by up
// to an ulp an add.  Here each call's product is summed in a zeroed
// accumulator of NCH n-tiles at a time and then added into c on the CUDA
// cores, rounded to nearest: the drift stays within one tile's products.
template <int D, int MT, int N, typename TB, int NCH>
__device__ __forceinline__ void mma_pv_add(float (&c)[MT][D / 8][4],
                                           const float (&p)[MT][N / 8][4],
                                           const uint8_t* sb,
                                           const Lane& ln) {
  static_assert((D / 8) % NCH == 0, "whole chunks of n-tiles");
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NCH) {
    float acc[MT][NCH][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NCH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      FragA a[MT];
      p_frags(a, p, j);
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const FragB bf = perm_frag<TB>(sb, j, n0 + n, ln);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][n], a[mt], bf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NCH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][n0 + n][e] += acc[mt][n][e];
  }
}

// ------------------------------------------------------------------- ring
// The ring of STAGES shared-memory stages a block streams its tiles
// through.  Thread 0 issues every load: the block's own tiles and the first
// STAGES streamed tiles before the loop, and tile u + STAGES into the stage
// of tile u once all THREADS threads have released it.
template <int STAGES, int THREADS>
struct Ring {
  uint64_t own, full[STAGES], empty[STAGES];

  __device__ __forceinline__ void init() {
    mbar_init(&own, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    sm90::fence_barrier_init();
  }
  // wait for tile u; the warp leaves the wait together (mma.sync is
  // .aligned)
  __device__ __forceinline__ void wait_full(int u) {
    mbar_wait(&full[u % STAGES], (u / STAGES) & 1);
    __syncwarp();
  }
  // every thread releases tile u; thread 0 then refills its stage with
  // tile u + STAGES by `load(tile, stage)`
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

}  // namespace tf32
