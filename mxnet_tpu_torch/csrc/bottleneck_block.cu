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
// where the library route rounds them between its convolutions.
//
// What bounds it on this card: at the defaults (64, 64, 256) a block does
// 2 * 57344 flops for each output pixel and moves 128 bytes of x and 512
// of y, 179 flops a byte, under the 295 at which the H100's tensor cores
// overtake its memory (the H100 SXM data sheet's 989 TFLOP/s bf16 and
// 3.35 TB/s, at its 700 W limit): bytes bound it, 0.077 ms at batch 128.
// So x is read once and y written once, and t1 and t2 never leave shared
// memory.
//
// What the design does:
// * One block of 8 warps per SM (the weights and two activations fill its
//   shared memory), looping over bands of R image rows of one image.  The
//   weights are staged once per block by cp.async; the TPU kernel's grid
//   ran in order on one core, here each block owns whole bands and nothing
//   carries over between blocks.
// * Stage 1: the 1x1 on the band and its one-row, one-column halo,
//   (R + 2) x 58 positions, A fragments read straight from x with the
//   bounds checks the TPU version had from a padded copy in device memory
//   (there is none here); the first BatchNorm-ReLU is applied to them in
//   registers.  The epilogue applies the second and writes 0 for positions
//   outside the image: after BatchNorm-ReLU those would hold relu(b1), not
//   the 0 the 3x3's padding needs.  Halo rows inside the image are real
//   neighbours and keep their values.
// * Stage 2: the 3x3 as 9 shifted products over t1 in shared memory; each
//   lane hands ldmatrix the t1 row of its own output position and tap.
// * Stage 3: the expanding 1x1 from t2 in shared memory, straight to y.
// * mma.sync m16n8k16 bf16 with f32 accumulators; a warp owns 16 output
//   rows and up to 64 columns.  Weights stay [in][out] as given and feed
//   the B operand through ldmatrix.trans; activation rows are padded by 8
//   values so that ldmatrix's 8 rows fall in 32 different banks.
//
// Built by mxnet_tpu_torch/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbottleneck_block-<hash>.so this file
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 56;
constexpr int W = 56;
constexpr int WP = W + 2;  // a haloed row
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of a 16 x 16 tile: lane l names row (l & 15), columns
// (l >> 4) * 8 .. + 7 of it.
__device__ __forceinline__ void ldmatrix_a(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The B fragments of two n8 tiles from a row-major [k][n] tile: lane l
// names row k = (l & 15), columns (l >> 4) * 8 .. + 7; r[0], r[1] are the
// first tile's, r[2], r[3] the second's.
__device__ __forceinline__ void ldmatrix_b(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ float bn_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.0f);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(relu(x * s + b)) of columns c, c + 1 of one x row (0 for no row)
__device__ __forceinline__ uint32_t act_pair(const bf16* row, int c,
                                             const float* s, const float* b) {
  if (row == nullptr) return 0u;
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
  return pack(bn_relu(v.x, s[c], b[c]), bn_relu(v.y, s[c + 1], b[c + 1]));
}

template <int CIN, int CMID, int COUT, int R>
struct Cfg {
  static constexpr int P1 = (R + 2) * WP;     // haloed band positions
  static constexpr int P1T = (P1 + 15) / 16;  // their m16 tiles
  static constexpr int P2 = R * W;            // output positions
  static constexpr int P2T = P2 / 16;
  static constexpr int LW1 = CMID + 8;        // padded row lengths
  static constexpr int LW3 = COUT + 8;
  static constexpr int LT = CMID + 8;         // w2, t1 and t2 rows
  // offsets in bf16 values into dynamic shared memory
  static constexpr int W1 = 0;
  static constexpr int W2 = W1 + CIN * LW1;
  static constexpr int W3 = W2 + 9 * CMID * LT;
  static constexpr int T1 = W3 + CMID * LW3;
  static constexpr int T2 = T1 + P1T * 16 * LT;
  static constexpr int END = T2 + P2 * LT;
  static constexpr int F32 = 2 * CIN + 4 * CMID;  // s0 b0 s1 b1 s2 b2
  static constexpr size_t SMEM = END * sizeof(bf16) + F32 * sizeof(float);
  static constexpr int NCH = COUT < 64 ? COUT : 64;  // stage-3 warp columns
  static_assert(CIN % 16 == 0 && CMID % 16 == 0 && COUT % 16 == 0, "");
  static_assert(CMID <= 64 && COUT % NCH == 0, "");
  static_assert(R % 2 == 0 && H % R == 0, "R * W must be a multiple of 16");
};

template <int CIN, int CMID, int COUT, int R>
__global__ void __launch_bounds__(THREADS)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                  const float* __restrict__ scales,
                  const float* __restrict__ shifts, int cmax,
                  bf16* __restrict__ y, int n_images) {
  using C = Cfg<CIN, CMID, COUT, R>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  bf16* w1s = sm + C::W1;
  bf16* w2s = sm + C::W2;
  bf16* w3s = sm + C::W3;
  bf16* t1s = sm + C::T1;
  bf16* t2s = sm + C::T2;
  float* s0 = reinterpret_cast<float*>(sm + C::END);
  float* b0 = s0 + CIN;
  float* s1 = b0 + CIN;
  float* b1 = s1 + CMID;
  float* s2 = b1 + CMID;
  float* b2 = s2 + CMID;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: row of A and C, column of B
  const int t = lane & 3;   // thread in group
  const int lrow = lane & 15;         // ldmatrix: the row this lane names
  const int lcol = (lane >> 4) * 8;   // and its 8 columns

  // the weights, once per block: rows of 8-value (16-byte) chunks
  for (int i = tid; i < CIN * CMID / 8; i += THREADS) {
    const int r = i / (CMID / 8), c = (i % (CMID / 8)) * 8;
    cp_async16(w1s + r * C::LW1 + c, w1 + r * CMID + c);
  }
  for (int i = tid; i < 9 * CMID * CMID / 8; i += THREADS) {
    const int r = i / (CMID / 8), c = (i % (CMID / 8)) * 8;
    cp_async16(w2s + r * C::LT + c, w2 + r * CMID + c);
  }
  for (int i = tid; i < CMID * COUT / 8; i += THREADS) {
    const int r = i / (COUT / 8), c = (i % (COUT / 8)) * 8;
    cp_async16(w3s + r * C::LW3 + c, w3 + r * COUT + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < CIN; i += THREADS) {
    s0[i] = scales[i];
    b0[i] = shifts[i];
  }
  for (int i = tid; i < CMID; i += THREADS) {
    s1[i] = scales[cmax + i];
    b1[i] = shifts[cmax + i];
    s2[i] = scales[2 * cmax + i];
    b2[i] = shifts[2 * cmax + i];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int bands = n_images * (H / R);
  for (int band = blockIdx.x; band < bands; band += gridDim.x) {
    const int img = band / (H / R);
    const int r0 = (band % (H / R)) * R;  // first image row of the band
    const bf16* xi = x + (size_t)img * H * W * CIN;

    // ---- stage 1: t1 over the haloed band, position p = pr * WP + pc is
    // image row r0 - 1 + pr, column pc - 1
    for (int mt = warp; mt < C::P1T; mt += WARPS) {
      const bf16* rows[2];
      bool inside[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        const int ih = r0 - 1 + p / WP, iw = p % WP - 1;
        inside[h] = p < C::P1 && ih >= 0 && ih < H && iw >= 0 && iw < W;
        rows[h] = inside[h] ? xi + ((size_t)ih * W + iw) * CIN : nullptr;
      }
      float acc[CMID / 8][4];
#pragma unroll
      for (int ni = 0; ni < CMID / 8; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ni][j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < CIN; kk += 16) {
        uint32_t a[4];
        a[0] = act_pair(rows[0], kk + 2 * t, s0, b0);
        a[1] = act_pair(rows[1], kk + 2 * t, s0, b0);
        a[2] = act_pair(rows[0], kk + 2 * t + 8, s0, b0);
        a[3] = act_pair(rows[1], kk + 2 * t + 8, s0, b0);
#pragma unroll
        for (int nb = 0; nb < CMID; nb += 16) {
          uint32_t b[4];
          ldmatrix_b(b, w1s + (kk + lrow) * C::LW1 + nb + lcol);
          mma_bf16(acc[nb / 8], a, b);
          mma_bf16(acc[nb / 8 + 1], a, b + 2);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* dst = t1s + (mt * 16 + g + 8 * h) * C::LT;
#pragma unroll
        for (int ni = 0; ni < CMID / 8; ++ni) {
          const int c = ni * 8 + 2 * t;
          const float v0 = bn_relu(acc[ni][2 * h], s1[c], b1[c]);
          const float v1 = bn_relu(acc[ni][2 * h + 1], s1[c + 1], b1[c + 1]);
          *reinterpret_cast<uint32_t*>(dst + c) =
              inside[h] ? pack(v0, v1) : 0u;
        }
      }
    }
    __syncthreads();

    // ---- stage 2: t2 = the 3x3 over t1, output position q = qr * W + qc
    for (int mt = warp; mt < C::P2T; mt += WARPS) {
      const int q = mt * 16 + lrow;
      const bf16* base = t1s + ((q / W) * WP + q % W) * C::LT + lcol;
      float acc[CMID / 8][4];
#pragma unroll
      for (int ni = 0; ni < CMID / 8; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ni][j] = 0.0f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const bf16* arow = base + ((tap / 3) * WP + tap % 3) * C::LT;
        const bf16* wt = w2s + tap * CMID * C::LT;
#pragma unroll
        for (int kk = 0; kk < CMID; kk += 16) {
          uint32_t a[4];
          ldmatrix_a(a, arow + kk);
#pragma unroll
          for (int nb = 0; nb < CMID; nb += 16) {
            uint32_t b[4];
            ldmatrix_b(b, wt + (kk + lrow) * C::LT + nb + lcol);
            mma_bf16(acc[nb / 8], a, b);
            mma_bf16(acc[nb / 8 + 1], a, b + 2);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* dst = t2s + (mt * 16 + g + 8 * h) * C::LT;
#pragma unroll
        for (int ni = 0; ni < CMID / 8; ++ni) {
          const int c = ni * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + c) =
              pack(bn_relu(acc[ni][2 * h], s2[c], b2[c]),
                   bn_relu(acc[ni][2 * h + 1], s2[c + 1], b2[c + 1]));
        }
      }
    }
    __syncthreads();

    // ---- stage 3: y = t2 @ w3, a warp item is 16 rows x NCH columns.  No
    // barrier after it: the next band's stage 1 writes only t1, and the
    // barrier that follows that stage orders this stage's reads of t2
    // before the next writes.
    constexpr int CHUNKS = COUT / C::NCH;
    for (int item = warp; item < C::P2T * CHUNKS; item += WARPS) {
      const int mt = item / CHUNKS;
      const int n0 = (item % CHUNKS) * C::NCH;
      const bf16* arow = t2s + (mt * 16 + lrow) * C::LT + lcol;
      float acc[C::NCH / 8][4];
#pragma unroll
      for (int ni = 0; ni < C::NCH / 8; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ni][j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < CMID; kk += 16) {
        uint32_t a[4];
        ldmatrix_a(a, arow + kk);
#pragma unroll
        for (int nb = 0; nb < C::NCH; nb += 16) {
          uint32_t b[4];
          ldmatrix_b(b, w3s + (kk + lrow) * C::LW3 + n0 + nb + lcol);
          mma_bf16(acc[nb / 8], a, b);
          mma_bf16(acc[nb / 8 + 1], a, b + 2);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 16 + g + 8 * h;
        bf16* dst = y + (((size_t)img * H + r0 + q / W) * W + q % W) * COUT;
#pragma unroll
        for (int ni = 0; ni < C::NCH / 8; ++ni) {
          const int c = n0 + ni * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(dst + c) =
              pack(acc[ni][2 * h], acc[ni][2 * h + 1]);
        }
      }
    }
  }
}

template <int CIN, int CMID, int COUT, int R>
int launch(const void* x, const void* w1, const void* w2, const void* w3,
           const float* scales, const float* shifts, int cmax, void* y,
           int n, cudaStream_t st) {
  using C = Cfg<CIN, CMID, COUT, R>;
  auto kernel = bottleneck_kernel<CIN, CMID, COUT, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long bands = (long long)n * (H / R);
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(bands < resident ? bands : resident);
  kernel<<<grid, THREADS, C::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3), scales,
      shifts, cmax, static_cast<bf16*>(y), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, h, w, cin), y (n, h, w, cout) bf16 contiguous; w1, w2, w3 bf16
// contiguous and 16-byte aligned; scales, shifts (3, cmax) f32.  The
// (cin, cmid, cout, rows) this file instantiates: (64, 64, 256) and
// (16, 16, 32), each with rows 2 or 4.  Returns 0 or a cudaError_t code.
int mxtt_bottleneck_block(const void* x, const void* w1, const void* w2,
                          const void* w3, const float* scales,
                          const float* shifts, void* y, int n, int h, int w,
                          int cin, int cmid, int cout, int cmax, int rows,
                          void* stream) {
  if (n < 1 || h != H || w != W || cmax < cin || cmax < cmid)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2) |
       reinterpret_cast<uintptr_t>(w3)) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXTT_BLOCK(CI, CM, CO, R)                                         \
  if (cin == CI && cmid == CM && cout == CO && rows == R)                 \
    return launch<CI, CM, CO, R>(x, w1, w2, w3, scales, shifts, cmax, y, n, \
                                 st);
  MXTT_BLOCK(64, 64, 256, 4)
  MXTT_BLOCK(64, 64, 256, 2)
  MXTT_BLOCK(16, 16, 32, 4)
  MXTT_BLOCK(16, 16, 32, 2)
#undef MXTT_BLOCK
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_bottleneck_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
