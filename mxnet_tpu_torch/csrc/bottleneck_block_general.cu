// K9, the general route: one ResNet bottleneck block (stride 1, 56 x 56) in
// one kernel for every input the JAX tool takes that bottleneck_block.cu
// does not: f32 x and weights, and bf16 channel sets outside its range.
//
// Replaces: tools/pallas_block_experiment.py, pallas_block (its Pallas
// kernel _block_kernel), beside bottleneck_block.cu, which takes bf16 with
// cin and cout multiples of 16 in [16, 256] and cmid 16, 32, 48 or 64
// (mxnet_tpu_torch/tools/block_experiment.py routes the calls).
//
// Computes, for x (N, 56, 56, CIN) NHWC, w1 (CIN, CMID), w2 (9, CMID, CMID)
// (tap dy*3+dx, input channel, output channel), w3 (CMID, COUT), all of one
// dtype T (f32 or bf16), and scales, shifts (3, cmax) f32:
//   a  = relu(x * s0 + b0)                  1x1 CIN -> CMID:  t1 = a @ w1
//   t1 = relu(t1 * s1 + b1), 0 outside the image (the conv's zero padding)
//   t2 = relu((3x3 conv of t1 with w2) * s2 + b2)
//   y  = t2 @ w3                            (N, 56, 56, COUT) in T
// Any CIN, CMID and COUT from 1 to 2048.  f32 runs every
// product as split TF32 (tf32_common.cuh: x = hi + lo, three m16n8k8 TF32
// products, about 21 of f32's 24 bits); bf16 rounds a, t1 and t2 to bf16
// before each product (as bottleneck_block.cu does) and runs m16n8k16.
// The BatchNorm-ReLUs multiply and add rounded apart, as the plain version
// does.
//
// What bounds it: the same work as bottleneck_block.cu's (flops over bytes
// 136 to 179 at the stage-1 sets in bf16, so bytes on paper); in f32 the
// product runs three TF32 products at 495 TFLOP/s, and operations bound it
// (chip_smoke's block_bound).  This route is the simple one: it lies on no
// training path, so it keeps every channel count in one code path and
// leaves speed to the wgmma kernel where that applies.
//
// The design:
// * An item is (image, band of R output rows, tile of TW output positions
//   of a row).  TW is the widest divisor of 56 (56, 28, 14, 8, 7, 4, 2, 1)
//   whose three haloed t1 rows, one row of t2 and the chunk buffers fit a
//   block's shared memory (make_plan): whole rows up to CMID 192 in f32,
//   14 positions at CMID 512 in f32, 4 at 2048.  A block walks items b, b +
//   grid, ...; R is the tallest divisor of 56 that still gives the card's
//   blocks an item each (the halo's t1 rows are computed once per band).
// * t1 of a band passes through a ring of three rows in shared memory: row
//   r - 1, r and r + 1 for output row r, each haloed to TW + 2 positions
//   (16 MT of them computed, from w = p0 - 1, MT = 4 for 56, 2 for 28 and 1
//   below; the ones past TW + 2 are dropped), channels padded to 64 and
//   zero past CMID, in T.  A row outside the image is all zeros, and t1 at
//   a position outside it is set to 0.  Output row r computes t1 row r + 2
//   into the slot row r - 1 leaves, then its 3x3, then its 1x1.
// * t2 of one output row lives in shared memory (TW positions x CMID
//   padded); y leaves from registers.  A tile's 16 MT rows of a product
//   read A rows clamped to the ones the buffer holds (chunk_mma's `rows`):
//   the rows past them feed only outputs past TW, which are never stored,
//   and every stored output reads the same values in the same order at
//   every TW, so y does not depend on the plan.
// * Every product is a block GEMM C (16 MT x 64) += A (16 MT x 32) B^T (64 x
//   32) over 32-deep chunks: A from shared memory (x after its BN-ReLU,
//   loaded by threads; a t1 row read from position dx on, which is the 3x3's
//   shift; or t2), B a chunk of the weights loaded by threads into shared
//   memory as [n][k].  Nothing is resident: the weights stream through one
//   64 x 32 buffer, so CIN, CMID and COUT are walked in chunks with masked
//   edges and any count, odd or not, loads the same way.  Eight warps, 2 x 4
//   of 32 x 16 (MT = 4), 1 x 8 of 32 x 8 (MT = 2) or 1 x 8 of 16 x 8 (MT =
//   1).
// * Sums: each chunk's products go into a zeroed accumulator, which is then
//   added into the running sum on the CUDA cores, rounded to nearest (the
//   tensor cores' f32 accumulator truncates: a long sum kept in it drifts).
// * No atomics: every output is computed by one warp in one order, so two
//   launches give the same bits.
//
// Shared memory: 3 (TW + 2) + TW rows of t1 and t2 of CMP + pad values,
// and the two chunk buffers (16 MT and 64 rows of 32 + pad).  At CMID 256
// in f32 whole rows would take 257632 bytes, half rows take 136544, under
// the 232448 a block may have; at CMID 2048 in f32 tiles of 4 positions
// take 192096.  Past CMID 2048 the wrapper refuses the shape.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbottleneck_block_general-<hash>.so this file
#include "tf32_common.cuh"

namespace {

constexpr int H = 56;
constexpr int W = 56;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;          // depth of a chunk
constexpr int NC = 64;          // columns of a chunk
constexpr int SLOTS = 3;        // t1 rows in the ring
constexpr int SMEM_LIMIT = 232448;   // a block's shared memory on the H100
constexpr int MAX_C = 2048;     // cin and cout
constexpr int MAX_CMID = 2048;
// the error a launch returns when its shared memory does not fit
constexpr int ERR_SMEM = 22000;

using bf16 = __nv_bfloat16;

// Row strides in elements, padded so that the fragment reads of a warp hit
// 32 banks: rows of 4 (mod 8) words in both types.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int PAD = 4;
  static constexpr int SKC = KC + PAD;   // a chunk row
  __device__ static __forceinline__ float from(float v) { return v; }
};
template <>
struct Elem<bf16> {
  static constexpr int PAD = 8;
  static constexpr int SKC = KC + PAD;
  __device__ static __forceinline__ bf16 from(float v) {
    return __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

struct Params {
  const void* x;
  const void* w1;
  const void* w2;
  const void* w3;
  const float* scales;   // (3, cmax)
  const float* shifts;
  void* y;
  int cin, cmid, cout, cmax;
  int band;              // output rows an item
  int tiles;             // position tiles a row: 56 / tw
  int tw;                // output positions a tile: a divisor of 56
  int items;
  int cmp;               // channels of a t1 or t2 row: cmid rounded to 64
  int kcmp;              // their contraction extent: cmid rounded to 32
};

// The warps' arrangement over a 16 MT x 64 block GEMM: WM x WN warps, each
// MW m16 tiles (2, or 1 at MT = 1) x NW n8 tiles
template <int MT>
struct Warps {
  static constexpr int WM = MT == 4 ? 2 : 1;
  static constexpr int WN = WARPS / WM;
  static constexpr int MW = MT == 1 ? 1 : 2;
  static constexpr int NW = NC / 8 / WN;
  static_assert(MT == 1 || MT == 2 || MT == 4,
                "16 MT positions: 16, 32 or 64");
};

// d += a b, one m16n8k16 bf16 product with an f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's two A rows of m16 tile m of a warp whose first row is rw, as
// offsets from the buffer's row 0, clamped to the `rows` it holds
template <int MW>
__device__ __forceinline__ void a_rows(int (&lo)[MW], int (&hi)[MW], int rw,
                                       int rows, int sa, int g) {
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    lo[m] = min(rw + 16 * m + g, rows - 1) * sa;
    hi[m] = min(rw + 16 * m + g + 8, rows - 1) * sa;
  }
}

// acc[MW][NW] += A B^T over one KC-deep chunk.  a: the A buffer's row 0
// (row-major, k contiguous, sa elements a row, `rows` rows; the warp's rows
// start at rw), b: the warp's first B row ([n][k], sb elements a row).  The
// chunk's products are summed in a zeroed accumulator and added into acc
// rounded to nearest.
template <int MW, int NW>
__device__ __forceinline__ void chunk_mma(float (&acc)[MW][NW][4],
                                          const float* a, int sa, int rw,
                                          int rows, const float* b, int sb,
                                          int g, int t) {
  float p[MW][NW][4] = {};
  int lo[MW], hi[MW];
  a_rows(lo, hi, rw, rows, sa, g);
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    tf32::FragA fa[MW];
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const float* ql = a + lo[m] + 8 * kk + t;
      const float* qh = a + hi[m] + 8 * kk + t;
      tf32::split(ql[0], fa[m].hi[0], fa[m].lo[0]);   // (g, t)
      tf32::split(qh[0], fa[m].hi[1], fa[m].lo[1]);   // (g + 8, t)
      tf32::split(ql[4], fa[m].hi[2], fa[m].lo[2]);   // (g, t + 4)
      tf32::split(qh[4], fa[m].hi[3], fa[m].lo[3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const float* q = b + (8 * n + g) * sb + 8 * kk + t;
      tf32::FragB fb;
      fb.set(q[0], q[4]);   // (k t, n g), (k t + 4, n g)
#pragma unroll
      for (int m = 0; m < MW; ++m) tf32::mma3(p[m][n], fa[m], fb);
    }
  }
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += p[m][n][e];
}

template <int MW, int NW>
__device__ __forceinline__ void chunk_mma(float (&acc)[MW][NW][4],
                                          const bf16* a, int sa, int rw,
                                          int rows, const bf16* b, int sb,
                                          int g, int t) {
  float p[MW][NW][4] = {};
  int lo[MW], hi[MW];
  a_rows(lo, hi, rw, rows, sa, g);
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t fa[MW][4];
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const bf16* ql = a + lo[m] + 16 * kk + 2 * t;
      const bf16* qh = a + hi[m] + 16 * kk + 2 * t;
      fa[m][0] = *reinterpret_cast<const uint32_t*>(ql);       // (g, 2t)
      fa[m][1] = *reinterpret_cast<const uint32_t*>(qh);       // (g + 8, 2t)
      fa[m][2] = *reinterpret_cast<const uint32_t*>(ql + 8);   // (g, 2t + 8)
      fa[m][3] = *reinterpret_cast<const uint32_t*>(qh + 8);   // (g + 8, 2t + 8)
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const bf16* q = b + (8 * n + g) * sb + 16 * kk + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 8);
#pragma unroll
      for (int m = 0; m < MW; ++m) mma_bf16(p[m][n], fa[m], b0, b1);
    }
  }
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += p[m][n][e];
}

// Chunk (k0, n0) of a row-major (K, N) weight matrix into bs as [n][k]
// (NC rows of Elem<T>::SKC values), zero past K or N.
template <typename T>
__device__ __forceinline__ void load_b(T* bs, const T* w, int K, int N,
                                       int k0, int n0) {
  for (int i = threadIdx.x; i < KC * NC; i += THREADS) {
    const int n = i % NC, k = i / NC;   // neighbours read neighbours
    const bool ok = k0 + k < K && n0 + n < N;
    bs[n * Elem<T>::SKC + k] =
        ok ? w[(size_t)(k0 + k) * N + n0 + n] : Elem<T>::from(0.f);
  }
}

__device__ __forceinline__ float bn_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
}

// The accumulator element e of tile (m, n) of the warp's block, for lane
// (g, t): row rw + 16 m + g + 8 (e / 2), column cw + 8 n + 2 t + e % 2.
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 2)
bottleneck_general_kernel(Params p) {
  using WP = Warps<MT>;
  constexpr int MP = 16 * MT;      // positions of a t1 or t2 tile
  constexpr int SKC = Elem<T>::SKC;
  const int S1 = p.cmp + Elem<T>::PAD;   // a t1 or t2 row
  const int TW = p.tw;                   // output positions of a tile
  const int SR = TW + 2;                 // t1 positions of a slot
  static_assert(MP >= 16, "a tile computes at least 16 positions");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* slots = reinterpret_cast<T*>(smem_raw);        // [3][SR][S1]
  T* t2 = slots + SLOTS * SR * S1;                  // [TW][S1]
  T* as = t2 + TW * S1;                             // [MP][SKC]
  T* bs = as + MP * SKC;                            // [NC][SKC]

  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* w3 = static_cast<const T*>(p.w3);
  T* y = static_cast<T*>(p.y);
  const float* s0 = p.scales;
  const float* b0 = p.shifts;
  const float* s1 = p.scales + p.cmax;
  const float* b1 = p.shifts + p.cmax;
  const float* s2 = p.scales + 2 * p.cmax;
  const float* b2 = p.shifts + 2 * p.cmax;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WP::WN, wn = warp % WP::WN;
  const int rw = 16 * WP::MW * wm;     // the warp's first row of a tile
  const int cw = 8 * WP::NW * wn;      // and its first column of a chunk
  float acc[WP::MW][WP::NW][4];

  auto zero_acc = [&]() {
#pragma unroll
    for (int m = 0; m < WP::MW; ++m)
#pragma unroll
      for (int n = 0; n < WP::NW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  };

  const int bands = H / p.band;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int tile = item % p.tiles;
    const int img = item / p.tiles / bands;
    const int r0 = (item / p.tiles) % bands * p.band;
    const int p0 = tile * TW;   // the tile's first output position
    const T* ximg = x + (size_t)img * H * W * p.cin;

    // t1 row r (image row, from r0 - 1) into its slot: positions w = p0 - 1
    // + q, q < SR
    auto stage1 = [&](int r) {
      T* slot = slots + ((r - r0 + 1) % SLOTS) * SR * S1;
      if (r < 0 || r >= H) {
        for (int i = tid; i < SR * S1; i += THREADS)
          slot[i] = Elem<T>::from(0.f);
        return;
      }
      const T* xrow = ximg + (size_t)r * W * p.cin;
      for (int n0 = 0; n0 < p.cmp; n0 += NC) {
        zero_acc();
        for (int k0 = 0; k0 < p.cin; k0 += KC) {
          // a = T(relu(x s0 + b0)) of the chunk; 0 outside the image
          for (int i = tid; i < MP * KC; i += THREADS) {
            const int k = i % KC, q = i / KC;
            const int wpos = p0 - 1 + q;
            float v = 0.f;
            if (wpos >= 0 && wpos < W && k0 + k < p.cin)
              v = bn_relu(to_f32(xrow[(size_t)wpos * p.cin + k0 + k]),
                          s0[k0 + k], b0[k0 + k]);
            as[q * SKC + k] = Elem<T>::from(v);
          }
          load_b(bs, w1, p.cin, p.cmid, k0, n0);
          __syncthreads();
          chunk_mma(acc, as, SKC, rw, MP, bs + cw * SKC, SKC, g, t);
          __syncthreads();
        }
        // t1 = T(relu(acc s1 + b1)); 0 past cmid and outside the image
#pragma unroll
        for (int m = 0; m < WP::MW; ++m)
#pragma unroll
          for (int n = 0; n < WP::NW; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = rw + 16 * m + g + 8 * (e >> 1);
              const int c = n0 + cw + 8 * n + 2 * t + (e & 1);
              const int wpos = p0 - 1 + q;
              float v = 0.f;
              if (c < p.cmid && wpos >= 0 && wpos < W)
                v = bn_relu(acc[m][n][e], s1[c], b1[c]);
              if (q < SR) slot[q * S1 + c] = Elem<T>::from(v);
            }
      }
    };

    stage1(r0 - 1);
    stage1(r0);
    for (int j = 0; j < p.band; ++j) {
      const int r = r0 + j;
      stage1(r + 1);   // the slot row r - 2 left; synced by the loads below
      // stage 2: the 3x3 over slots of rows r - 1, r, r + 1 into t2
      for (int n0 = 0; n0 < p.cmp; n0 += NC) {
        zero_acc();
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const T* slot = slots + ((r - 1 + dy - r0 + 1) % SLOTS) * SR * S1;
          for (int k0 = 0; k0 < p.kcmp; k0 += KC) {
            load_b(bs, w2 + (size_t)tap * p.cmid * p.cmid, p.cmid, p.cmid, k0,
                   n0);
            __syncthreads();
            chunk_mma(acc, slot + dx * S1 + k0, S1, rw, SR - dx,
                      bs + cw * SKC, SKC, g, t);
            __syncthreads();
          }
        }
#pragma unroll
        for (int m = 0; m < WP::MW; ++m)
#pragma unroll
          for (int n = 0; n < WP::NW; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = rw + 16 * m + g + 8 * (e >> 1);
              const int c = n0 + cw + 8 * n + 2 * t + (e & 1);
              const float v =
                  c < p.cmid ? bn_relu(acc[m][n][e], s2[c], b2[c]) : 0.f;
              if (q < TW) t2[q * S1 + c] = Elem<T>::from(v);
            }
      }
      // stage 3: y = t2 w3, 64 output channels at a time
      T* yrow = y + (((size_t)img * H + r) * W + p0) * p.cout;
      for (int n0 = 0; n0 < p.cout; n0 += NC) {
        zero_acc();
        for (int k0 = 0; k0 < p.kcmp; k0 += KC) {
          load_b(bs, w3, p.cmid, p.cout, k0, n0);
          __syncthreads();
          chunk_mma(acc, t2 + k0, S1, rw, TW, bs + cw * SKC, SKC, g, t);
          __syncthreads();
        }
#pragma unroll
        for (int m = 0; m < WP::MW; ++m)
#pragma unroll
          for (int n = 0; n < WP::NW; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = rw + 16 * m + g + 8 * (e >> 1);
              const int c = n0 + cw + 8 * n + 2 * t + (e & 1);
              if (q < TW && c < p.cout)
                yrow[(size_t)q * p.cout + c] = Elem<T>::from(acc[m][n][e]);
            }
      }
    }
  }
}

// ------------------------------------------------------------------- host
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

// The tile widths, widest first, and the 16 MT positions each computes
constexpr int TILE_WIDTHS[] = {56, 28, 14, 8, 7, 4, 2, 1};
inline int tile_mt(int tw) { return tw == 56 ? 4 : tw == 28 ? 2 : 1; }

// Dynamic shared memory of a launch with tiles of tw positions
inline size_t smem_bytes(int tw, int cmp, int elem) {
  const size_t mp = 16 * tile_mt(tw), s1 = cmp + (elem == 4 ? 4 : 8);
  const size_t skc = KC + (elem == 4 ? 4 : 8);
  return elem * (SLOTS * (tw + 2) * s1 + tw * s1 + mp * skc + NC * skc);
}

struct Plan {
  int mt, tw, tiles, band, items, smem, grid, per_sm;
};

template <typename T, int MT>
int occupancy(int smem, int* per_sm) {
  auto kern = bottleneck_general_kernel<T, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern,
                                                        THREADS, smem);
  return (int)err;
}

bool shape_ok(int n, int h, int w, int cin, int cmid, int cout, int cmax,
              int band) {
  return n >= 1 && h == H && w == W && cin >= 1 && cin <= MAX_C &&
         cout >= 1 && cout <= MAX_C && cmid >= 1 && cmid <= MAX_CMID &&
         cmax >= cin && cmax >= cmid && band >= 0 && band <= H &&
         (band == 0 || H % band == 0);
}

template <typename T>
int occupancy_of(int mt, int smem, int* per_sm) {
  return mt == 4   ? occupancy<T, 4>(smem, per_sm)
         : mt == 2 ? occupancy<T, 2>(smem, per_sm)
                   : occupancy<T, 1>(smem, per_sm);
}

// The plan of a launch: the widest tile whose rows fit; the
// band, the tallest divisor of 56 that gives every resident block an item,
// unless `band` asks for one.
int make_plan(Plan* pl, int n, int cmid, int band, int elem) {
  const int cmp = (cmid + 63) / 64 * 64;
  pl->tw = 0;
  for (int tw : TILE_WIDTHS)
    if (smem_bytes(tw, cmp, elem) <= (size_t)SMEM_LIMIT) {
      pl->tw = tw;
      break;
    }
  if (pl->tw == 0) return ERR_SMEM;
  pl->mt = tile_mt(pl->tw);
  pl->tiles = W / pl->tw;
  pl->smem = (int)smem_bytes(pl->tw, cmp, elem);
  int per_sm = 0;
  const int rc = elem == 4 ? occupancy_of<float>(pl->mt, pl->smem, &per_sm)
                           : occupancy_of<bf16>(pl->mt, pl->smem, &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1) return ERR_SMEM;
  pl->per_sm = per_sm;
  const long long slots = (long long)sm_count() * per_sm;
  pl->band = band;
  if (band == 0) {
    pl->band = 1;
    for (int b = H; b >= 1; --b)
      if (H % b == 0 && (long long)n * (H / b) * pl->tiles >= slots) {
        pl->band = b;
        break;
      }
  }
  const long long items = (long long)n * (H / pl->band) * pl->tiles;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pl->items = (int)items;
  pl->grid = (int)(items < slots ? items : slots);
  return 0;
}

template <typename T, int MT>
int launch(const Params& p, const Plan& pl, cudaStream_t st) {
  bottleneck_general_kernel<T, MT><<<pl.grid, THREADS, pl.smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_of(const Params& p, const Plan& pl, cudaStream_t st) {
  return pl.mt == 4   ? launch<T, 4>(p, pl, st)
         : pl.mt == 2 ? launch<T, 2>(p, pl, st)
                      : launch<T, 1>(p, pl, st);
}

}  // namespace

extern "C" {

// x (n, h, w, cin), y (n, h, w, cout), w1 (cin, cmid), w2 (9, cmid, cmid),
// w3 (cmid, cout) contiguous, all f32 (dtype 0) or bf16 (dtype 1); scales,
// shifts (3, cmax) f32 contiguous.  h = w = 56; cin, cmid and cout 1 to
// 2048, cmax >= max(cin, cmid).  band: the output rows of an item
// (a divisor of 56), or 0 for the kernel's own choice; y does not depend on
// it.  Returns 0, a cudaError_t code, or ERR_SMEM
// (mxtt_bottleneck_general_error_string).
int mxtt_bottleneck_general(const void* x, const void* w1, const void* w2,
                            const void* w3, const float* scales,
                            const float* shifts, void* y, int n, int h, int w,
                            int cin, int cmid, int cout, int cmax, int band,
                            int dtype, void* stream) {
  if (!shape_ok(n, h, w, cin, cmid, cout, cmax, band) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  Plan pl;
  const int rc = make_plan(&pl, n, cmid, band, elem);
  if (rc != 0) return rc;
  Params p{x, w1, w2, w3, scales, shifts, y, cin, cmid, cout, cmax,
           pl.band, pl.tiles, pl.tw, pl.items, (cmid + 63) / 64 * 64,
           (cmid + KC - 1) / KC * KC};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_of<float>(p, pl, st) : launch_of<bf16>(p, pl, st);
}

// The plan of a launch, for the record: out[0..6] = band, items, positions
// a tile (a divisor of 56), dynamic shared memory bytes, grid, blocks an SM,
// 16 MT.
// Returns 0, a cudaError_t code or ERR_SMEM.
int mxtt_bottleneck_general_plan(int n, int cin, int cmid, int cout, int band,
                                 int dtype, int* out) {
  const int cmax = cin > cmid ? cin : cmid;
  if (!shape_ok(n, H, W, cin, cmid, cout, cmax, band) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Plan pl;
  const int rc = make_plan(&pl, n, cmid, band, dtype == 0 ? 4 : 2);
  if (rc != 0) return rc;
  out[0] = pl.band;
  out[1] = pl.items;
  out[2] = pl.tw;
  out[3] = pl.smem;
  out[4] = pl.grid;
  out[5] = pl.per_sm;
  out[6] = 16 * pl.mt;
  return 0;
}

const char* mxtt_bottleneck_general_error_string(int code) {
  if (code == ERR_SMEM)
    return "the general bottleneck kernel's t1 rows, t2 and chunk buffers "
           "do not fit in the 227 KB of shared memory a block may have";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
