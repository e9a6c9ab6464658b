// Hopper (sm_90a) building blocks shared by the tensor-core flash-attention
// kernels, flash_attention_fwd_sm90.cu and flash_attention_bwd_sm90.cu:
// inline PTX for mbarriers, TMA loads (cp.async.bulk.tensor), wgmma and its
// shared-memory descriptors, the swizzled tile geometry both TMA and wgmma
// read, and the host-side encoding of TMA tensor maps.
//
// Tiles.  A (rows, D) bf16 tile of a (B, T, H, D) tensor is brought into
// shared memory by TMA with a swizzle, in boxes of BOX_COLS columns: D=64
// is one box of 128-byte rows (SWIZZLE_128B), D=128 two such boxes side by
// side, D=32 one box of 64-byte rows (SWIZZLE_64B).  The same bytes are
// read by wgmma either K-major (D is the contraction: Q K^T and the like)
// or MN-major through the transpose bit (the tile's rows are the
// contraction: P V and the like); Tile::kmajor and Tile::mnmajor build the
// two descriptors.  A descriptor's layout type must match the TMA swizzle,
// or the product reads permuted numbers without any fault.  The f32
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu) reuse the
// barriers, the TMA loads and the map encoding with tiles of their own
// (tf32_common.cuh); encode_tile_map takes the element type from the tile.
// matmul_stats.cu reads and writes 2-d matrices through the same tiles
// (tma_load_2d, tma_store_2d, encode_matrix_map) and runs 256-column
// products on wgmma_ss's m64n256k16 form.  bottleneck_block.cu adds the
// narrow forms (N = 16, 32, 48) and operands in the interleaved layout
// (interleaved_kmajor), whose tiles may start on any row.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; cuTensorMapEncodeTiled is
#include <cuda_bf16.h>  // looked up at run time (encode_fn): no -lcuda
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int WG = 128;   // threads of a warpgroup

// ------------------------------------------------------------ shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes: a swizzled tile must
// start on its pattern's period (1024 bytes for 128-byte rows)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ----------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity: the n-th
// completion (from 0) has parity n & 1.  A wait that has not ended after
// 2^30 polls (each suspends the thread for a while) is a fault in the
// kernel: it traps, which fails the launch, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) break;
    if (polls == (1u << 30)) __trap();
  }
}

// ---------------------------------------------------------------------- TMA
// one box of a 4-d map (D, H, T, B) at (c, h, t, b) into shared memory; the
// barrier's transaction count falls by the box's bytes when it has landed
// (rows past T arrive as zeros and count all the same)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int h, int t,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// the same box of a 4-d map fetched into L2 only: a later tma_load_4d of
// it reads L2 instead of device memory
__device__ __forceinline__ void tma_prefetch_4d(const CUtensorMap* map, int c,
                                                int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global.tile [%0, {%1, %2, %3, %4}];"
      "\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// one box of a 2-d map (columns, rows) at (c, r) into shared memory, as
// tma_load_4d
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x)
      : "memory");
}

// one box of shared memory to a 4-d map at (c, h, t, b), in this thread's
// bulk group; rows past T are not written.  The shared memory must not be
// written again before bulk_wait_read says the box has been read, and
// generic-proxy writes to it must be made visible first
// (fence_proxy_async).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c, int h,
                                             int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(h), "r"(t), "r"(b)
      : "memory");
}
// one box of shared memory to a 2-d map at (c, r), as tma_store_4d;
// columns and rows past the map's are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(r)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups are still reading shared
// memory (bulk_wait_read) or still writing device memory (bulk_wait)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes, visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------- warp specialisation
// named barriers (0 is __syncthreads): bar_sync waits until `count`
// threads, its own included, have reached barrier `id`; bar_arrive counts
// this warp in and goes on
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// a warpgroup's registers a thread, moved to or from the SM's pool; every
// warp of the warpgroup runs it, and ptxas honours it only where the role
// branches never reconverge (else warning C7508)
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running (they end in
// the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie an accumulator's registers to this point: wgmma writes them
// asynchronously, so no read or write of them may move across the fence
// before the product or the wait after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (1 = 128B swizzle, 2 = 64B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// A K-major operand in the interleaved (unswizzled) layout: core matrices of
// 8 rows x 16 bytes (8 values of the contraction) stored whole, a row 16
// bytes after the one before, the next 8 rows 128 bytes on (SBO), the next 8
// contraction values `kstep` bytes on (LBO).  A tile may start on any row.
__device__ __forceinline__ uint64_t interleaved_kmajor(uint32_t addr,
                                                       uint32_t kstep) {
  return gmma_desc(addr, kstep, 128, 0);
}

// An MN-major operand in the interleaved layout: core matrices of 8
// contraction rows x 16 bytes (8 values along M or N) stored whole, the
// next 8 contraction rows 128 bytes on (LBO), the next 8 values along M or
// N `mnstep` bytes on (SBO).  TMA lays it down from a row-major (K, N)
// matrix in boxes of 8 columns and K rows with no swizzle: each box is a
// strip of core matrices, mnstep = 16 K bytes apart.
__device__ __forceinline__ uint64_t interleaved_mnmajor(uint32_t addr,
                                                        uint32_t mnstep) {
  return gmma_desc(addr, 128, mnstep, 0);
}

// A (ROWS, D) bf16 tile as TMA lays it down: BOXES boxes of (ROWS,
// BOX_COLS), each row SWZ bytes, 8-row groups of 8 * SWZ bytes.
template <int D, int ROWS>
struct Tile {
  static_assert(D == 32 || D % 64 == 0, "D must be 32 or a multiple of 64");
  // 64 rows for an A operand (wgmma's M); a B operand of N = 32 keys or
  // queries (the tuned flash tiles) is 32
  static_assert(ROWS % 32 == 0, "a tile is a multiple of 32 rows");
  static constexpr int SWZ = D >= 64 ? 128 : 64;
  static constexpr int BOX_COLS = SWZ / 2;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int BOX_BYTES = ROWS * SWZ;
  static constexpr int BYTES = BOXES * BOX_BYTES;
  static constexpr uint32_t LAYOUT = SWZ == 128 ? 1 : 2;
  // what encode_tile_map reads: columns, element bytes and type
  static constexpr int COLS = D;
  static constexpr int ELEM = 2;
  static constexpr CUtensorMapDataType DTYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  // K-major operand: rows [row0, row0 + M or N) of the tile, columns
  // [16 kk, 16 kk + 16) as the contraction
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int row0,
                                                    int kk) {
    const int col = kk * 16;
    return gmma_desc(base + (col / BOX_COLS) * BOX_BYTES + row0 * SWZ +
                         (col % BOX_COLS) * 2,
                     16, 8 * SWZ, LAYOUT);
  }
  // MN-major operand: rows [16 kk, 16 kk + 16) as the contraction, all D
  // columns as N; the next box of columns lies BOX_BYTES on
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return gmma_desc(base + kk * 16 * SWZ, BOX_BYTES, 8 * SWZ, LAYOUT);
  }
  // TMA's swizzle XORs the index of a row's 16-byte chunk with the row's
  // place in the pattern: row % 8 for 128-byte rows, row / 2 % 4 for
  // 64-byte rows
  __device__ static __forceinline__ uint32_t swizzle_key(int row) {
    return (uint32_t)(row * SWZ >> 7) & (SWZ / 16 - 1);
  }
  // the byte offset of element (row, col) as TMA lays the tile down, key
  // the row's swizzle_key
  __device__ static __forceinline__ uint32_t offset(int row, int col,
                                                    uint32_t key) {
    return (col / BOX_COLS) * BOX_BYTES + row * SWZ +
           ((((col % BOX_COLS) >> 3) ^ key) << 4) + (col % 8) * 2;
  }
  // the TMA loads of rows [t0, t0 + ROWS) of head (b, h) into dst
  __device__ static __forceinline__ void load(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int t0,
                                              int b) {
#pragma unroll
    for (int x = 0; x < BOXES; ++x)
      tma_load_4d(dst + x * BOX_BYTES, map, bar, x * BOX_COLS, h, t0, b);
  }
};

// 2^x by the SFU's approximation, flushing a denormal result to 0 (the
// softmax's exponents are at most 0, and a p below 2^-126 is 0 for bf16)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The f32 accumulator of an m64nNk16 product as the bf16 A operand of the
// next one: k-step kk covers accumulator columns [16 kk, 16 kk + 16)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// Accumulator element i of an m64nNk16 product, for lane `lane` of warp
// `warp` of the warpgroup: row warp * 16 + lane / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int lane, int i) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// m64nNk16 bf16 products with an f32 accumulator d (N / 2 registers a
// thread).  wgmma_ss (N = 64, 128, 256): A and B from shared memory, TA / TB the
// transpose (MN-major) bits; wgmma_rs (N = 32, 64, 128): A from registers,
// B from shared memory.  scale_d = 0 overwrites d, 1 adds to it.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// The narrow forms bottleneck_block.cu needs: its middle width (16 to 64
// channels) as N, and the tail of its output channels.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[24],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// Error codes of the launchers beyond cudaError_t's: cuTensorMapEncodeTiled
// could not be looked up, or refused a map (its CUresult is added to
// ERR_ENCODE).
constexpr int ERR_NO_ENCODE = 20000;
constexpr int ERR_ENCODE = 21000;

// cuTensorMapEncodeTiled lives in libcuda, not the runtime: looked up once
// through the runtime's entry-point query, so the library links no -lcuda
static EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

struct Strides {
  long long b, t, h;   // in elements; the d stride is 1
};

// A (B, T, H, D) tensor as the 4-d map (D, H, T, B), boxes of (BOX_COLS,
// 1, rows, 1) with the swizzle, element type and size of the tile type TL
// (Tile here, TileF32 in tf32_common.cuh).  Returns 0 or an error.
template <typename TL>
int encode_tile_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                    int heads, Strides s, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)TL::COLS, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * TL::ELEM,
                                 (cuuint64_t)s.t * TL::ELEM,
                                 (cuuint64_t)s.b * TL::ELEM};
  const cuuint32_t box[4] = {(cuuint32_t)TL::BOX_COLS, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, TL::DTYPE, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  TL::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A row-major (rows, cols) matrix, rows `stride` elements apart, as the
// 2-d map (cols, rows) with boxes of (BOX_COLS, box_rows) and the swizzle
// and element type of the tile type TL.  Columns and rows past the matrix
// arrive as zeros and are not stored.  Returns 0 or an error.
template <typename TL>
int encode_matrix_map(CUtensorMap* map, const void* ptr, long long cols,
                      long long rows, long long stride, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * TL::ELEM};
  const cuuint32_t box[2] = {(cuuint32_t)TL::BOX_COLS, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, TL::DTYPE, 2, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  TL::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A (B, T, H, D) bf16 tensor, as the bf16 kernels' Tile lays it down
template <int D>
int encode_bthd(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads, Strides s, int rows) {
  return encode_tile_map<Tile<D, 64>>(map, ptr, batch, seq, heads, s, rows);
}

// n f32 values as a 1-d map with boxes of `box` values
inline int encode_f32_1d(CUtensorMap* map, const float* ptr, long long n,
                         int box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};   // not read for a 1-d map
  const cuuint32_t boxd[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                  const_cast<float*>(ptr), dims, strides, boxd, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

inline const char* error_string(int code) {
  if (code == ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled could not be looked up at run time";
  if (code >= ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 21000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace sm90
