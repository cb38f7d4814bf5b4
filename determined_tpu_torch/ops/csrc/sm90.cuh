// Hopper pieces shared by the bf16 paths of flash_fwd.cu,
// flash_bwd_blocked.cu, flash_fwd_mono.cu and flash_bwd_mono.cu: TMA
// tensor maps (loads and stores), mbarrier helpers, warpgroup matrix
// multiplies (wgmma) and the persistent kernels' schedule.
//
// Route: inline PTX (no CUTLASS/CuTe headers), so each library still
// builds with the plain nvcc line of _build.py.
//
// - Tensor maps. `make_tile_map` encodes a 4-D map (D, H, S, B) over a
//   strided [B, S, H, D] bf16 view with a box of (min(D, 64), 1, rows, 1)
//   and the widest swizzle a box row allows (32, 64 or 128 bytes). A head
//   dim of 128 is loaded as two 64-column boxes into two column blocks, so
//   every tile in shared memory is [column block][rows][row bytes] in the
//   canonical swizzled layout wgmma reads. TMA zero-fills rows past S (and
//   before 0), so ragged tiles need no other load path. The encoder lives
//   in libcuda; the library takes it through cudaGetDriverEntryPoint at
//   first use and needs no -lcuda. TMA wants a 16-byte-aligned base and
//   strides that are multiples of 16 bytes: the Python wrappers check both
//   (flash_attention.py `_tma_ready`) before they launch.
// - mbarriers: init, arrive, arrive with an expected byte count, and a
//   parity wait.
// - wgmma m64nNk16 with bf16 inputs and fp32 accumulators in registers,
//   N in {16, 32, 64, 128}: `ss` reads A and B from shared memory through
//   descriptors, `rs` takes A from registers. K-major operands advance by
//   32 bytes per k step inside a swizzled row, MN-major ones by 16 rows.
// - Warp specialisation: a kernel runs one producer warpgroup (one warp of
//   it issues the loads; it gives up registers with setmaxnreg) and two
//   consumer warpgroups (232 registers each).
// - Persistent kernels (the mono pair): a grid of one CTA a SM walks work
//   items sorted heaviest first in snake order (`snake_item`), so that
//   the prologue is paid once a SM and one item's epilogue overlaps the
//   next item's loads. A tile leaves shared memory by a TMA store
//   (`tma_store_tile`, bulk async-groups), written there in the same
//   swizzled layout as a loaded tile (`swizzle_offset`).
//
// Fragment layout of an m64nN fp32 accumulator in a warpgroup (thread t,
// warp w = t / 32, lane l): d[4j + 2h + e] holds row 16w + l/4 + 8h and
// column 8j + 2(l%4) + e. Converted pairwise to bf16, the registers
// d[8kk .. 8kk + 7] are exactly the A-register fragment of the k step kk
// of a following wgmma whose k runs over those columns.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace dtpu {
namespace sm90 {

// -- shared memory addresses, fences, barriers -------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Generic-proxy writes to shared memory become visible to wgmma / TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Threads of a warp-specialised kernel (two consumer warpgroups, then the
// producer warpgroup) and their register budgets: 40·128 + 232·256 =
// 64512, what 168 registers a thread for 384 threads take at launch.
constexpr int kSpecThreads = 3 * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Hand registers from the producer warpgroup to the consumer ones: every
// warp of a warpgroup executes the same call.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x, flushing denormals (the softmax exponent).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier `id` (1..15) over `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- TMA ---------------------------------------------------------------------
// One box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 4-D map from shared memory to global memory, in the
// current bulk async-group; TMA drops the rows that fall outside the map.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Swizzle span (bytes) of a tile whose rows hold `d` bf16 values (up to
// 64 per column block).
__host__ __device__ constexpr int swizzle_bytes(int d) {
  return d >= 64 ? 128 : d * 2;
}

// Bytes of one column block of `rows` rows.
__host__ __device__ constexpr int block_bytes(int rows, int d) {
  return rows * swizzle_bytes(d);
}

// Bytes of a [rows, d] tile (all its column blocks), a multiple of 1024.
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return ((d > 64 ? d / 64 : 1) * block_bytes(rows, d) + 1023) / 1024 * 1024;
}

// Load rows [row0, row0 + rows) of head h, batch b of a map made by
// make_tile_map into a tile at `dst` (all column blocks).
template <int D>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int h,
                                              int row0, int b) {
#pragma unroll
  for (int c = 0; c < (D > 64 ? D / 64 : 1); ++c) {
    tma_load_4d(static_cast<char*>(dst) + c * block_bytes(rows, D), map, bar,
                c * 64, h, row0, b);
  }
}

// Store a [rows, D] tile at `src` (all column blocks) to rows [row0, row0
// + rows) of head h, batch b of a map made by make_tile_map.
template <int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               const void* src, int rows,
                                               int h, int row0, int b) {
#pragma unroll
  for (int c = 0; c < (D > 64 ? D / 64 : 1); ++c) {
    tma_store_4d(map, static_cast<const char*>(src) + c * block_bytes(rows, D),
                 c * 64, h, row0, b);
  }
}

// Byte offset of element (row, col) of a [rows, D] bf16 tile in the
// swizzled layout TMA and wgmma use (column blocks of 64, `swizzle_bytes`
// a row; the 16-byte chunks of a row XORed with the row's place in its
// 8-row group).
template <int D>
__device__ __forceinline__ uint32_t swizzle_offset(int rows, int row,
                                                   int col) {
  constexpr int kSw = swizzle_bytes(D);
  constexpr int kCols = kSw / 2;
  const uint32_t off = row * kSw + (col % kCols) * 2;
  return (col / kCols) * block_bytes(rows, D) +
         (off ^ (((off >> 7) & (kSw / 16 - 1)) << 4));
}

// Encode a map over a strided [B, S, H, D] bf16 tensor (strides in
// elements, the head dim contiguous) with a box of `rows` rows. Returns 0
// or kTmaEncodeError.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline int make_tile_map(CUtensorMap* map, const void* base, int B, int S,
                         int H, int D, long long sb, long long ss,
                         long long sh, int rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return kTmaEncodeError;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const int e = 2;  // bf16
  // Size-1 dims: any legal stride (their coordinate is always 0).
  if (H == 1) sh = D;
  if (S == 1) ss = (long long)H * D;
  if (B == 1) sb = (long long)S * ss;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * e), (cuuint64_t)(ss * e),
                                 (cuuint64_t)(sb * e)};
  const cuuint32_t box[4] = {(cuuint32_t)(D > 64 ? 64 : D), 1u,
                             (cuuint32_t)rows, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const int sw = swizzle_bytes(D);
  const CUtensorMapSwizzle swizzle =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kTmaEncodeError;
}

// -- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle mode from the span (128 → 1, 64 → 2, 32 → 3).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// Descriptor of a K-major operand tile: rows of the M (or N) dimension,
// the k dimension contiguous in a row of `swizzle` bytes; k step kk starts
// 32 bytes further, or in the next column block.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int rows,
                                                int kk) {
  constexpr int kSw = swizzle_bytes(D);
  const char* p = static_cast<const char*>(tile) +
                  (kk * 32) / kSw * block_bytes(rows, D) + (kk * 32) % kSw;
  return make_desc(p, 16, 8 * kSw, kSw);
}

// Descriptor of an MN-major operand tile: rows of the k dimension, the N
// (or M) dimension contiguous in a row (column blocks of 64 apart by one
// block); k step kk starts 16 rows further.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile, int rows,
                                                 int kk) {
  constexpr int kSw = swizzle_bytes(D);
  const char* p = static_cast<const char*>(tile) + kk * 16 * kSw;
  return make_desc(p, block_bytes(rows, D), 8 * kSw, kSw);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Two floats → one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Make `x` opaque to the compiler's scheduling around wgmma: the
// accumulator registers are touched only between fence and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// m64nNk16, bf16 x bf16 → fp32; d += A·B (scale_d = 0: d = A·B). kTA /
// kTB: 1 = the operand is MN-major in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static constexpr int kRegs = 8;
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
  template <int kTB>
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(kTB));
  }
};

template <>
struct Wgmma<32> {
  static constexpr int kRegs = 16;
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
  template <int kTB>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(kTB));
  }
};

template <>
struct Wgmma<64> {
  static constexpr int kRegs = 32;
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
  template <int kTB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(kTB));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int kRegs = 64;
  template <int kTA, int kTB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
  template <int kTB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d), "n"(kTB));
  }
};

// -- persistent schedule -----------------------------------------------------
// Item of CTA `cta` in pass `pass` of a grid of `grid` CTAs: pass r
// covers items r·grid .. r·grid + grid − 1, in CTA order on even passes
// and reversed on odd ones. With items sorted heaviest first this deals
// them out close to the longest-processing-time-first schedule (at B8
// S1024 causal: 27 tile pairs on the busiest SM against 26.2 on average).
__device__ __forceinline__ int snake_item(int pass, int cta, int grid) {
  return pass * grid + ((pass & 1) ? grid - 1 - cta : cta);
}

// The current device's SM count (the persistent grid's size), or 0 when
// the runtime cannot tell.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace sm90
}  // namespace dtpu
