// Shared pieces of the monolithic-path kernels (flash_fwd_mono.cu,
// flash_bwd_mono.cu): tile staging and one block-wide tile product.
//
// Layout of the work: a block of kMonoThreads threads stages tiles of
// q/k/v/do rows in shared memory in the input dtype, and every matrix
// product of the kernels is one call of `block_gemm`: an fp32 tile C in
// shared memory (+)= A · B, with A and B tiles in shared memory, either of
// them read transposed. For bf16 the product runs on the tensor cores
// (nvcuda::wmma 16x16x16 fragments, fp32 accumulation), one 16x16 output
// tile per warp at a time; for fp32 it runs as fp32 FMAs from shared
// memory (a tensor-core product would round to TF32), each thread owning
// a strided (M/16) x (N/16) patch of C in registers. The elementwise work
// between products (masking, softmax, the ds formula) reads and writes the
// same fp32 tiles.
#pragma once

#include <mma.h>

#include <type_traits>

#include "attn_common.cuh"

namespace dtpu {

constexpr int kMonoWarps = 8;
constexpr int kMonoThreads = kMonoWarps * 32;

// Row padding of a shared-memory tile, in elements: 16 bytes, so that a
// row start stays 16-byte aligned (wmma's ldm rule) and consecutive rows
// start on different banks.
template <typename T>
constexpr int pad_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// Row stride (elements) of a tile of `n` columns of T in shared memory.
template <typename T>
constexpr int ld_of(int n) {
  return n + pad_of<T>();
}

// Bytes of a tile of `rows` x ld_of<T>(cols), rounded up to 128 so that
// every tile that follows starts 128-byte aligned (wmma wants 32).
template <typename T>
constexpr int tile_bytes(int rows, int cols) {
  return (rows * ld_of<T>(cols) * static_cast<int>(sizeof(T)) + 127) / 128 *
         128;
}

// Copy `n_rows` rows of D elements of T (row r at src + r * row_stride)
// into shared memory with row stride `ld`; rows at or past `n_valid` are
// zero-filled. Neighbouring threads read neighbouring elements of a row.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long row_stride, int n_rows,
                                           int n_valid) {
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kMonoThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * ld + d] =
        r < n_valid ? src[(long long)r * row_stride + d] : from_float<T>(0.f);
  }
}

// C[M][N] (fp32, row stride ldc) = (kAcc ? C : 0) + A · B, where A is
// M x K and B is K x N. A(m, k) is A[m * lda + k], or A[k * lda + m] when
// kAT (A stored transposed); B(k, n) is B[k * ldb + n], or B[n * ldb + k]
// when kBT. Block-wide: every thread of the block calls it; the caller
// synchronises before reading C.
template <int M, int N, int K, bool kAT, bool kBT, bool kAcc>
__device__ __forceinline__ void block_gemm(float* C, int ldc,
                                           const __nv_bfloat16* A, int lda,
                                           const __nv_bfloat16* B, int ldb) {
  using namespace nvcuda;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "16x16x16 tiles");
  using LayoutA =
      typename std::conditional<kAT, wmma::col_major, wmma::row_major>::type;
  using LayoutB =
      typename std::conditional<kBT, wmma::col_major, wmma::row_major>::type;
  constexpr int TN = N / 16;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < (M / 16) * TN; t += kMonoWarps) {
    const int tm = t / TN;
    const int tn = t - tm * TN;
    float* c = C + tm * 16 * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (kAcc) {
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
#pragma unroll
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> b;
      wmma::load_matrix_sync(
          a, kAT ? A + k * lda + tm * 16 : A + tm * 16 * lda + k, lda);
      wmma::load_matrix_sync(
          b, kBT ? B + tn * 16 * ldb + k : B + k * ldb + tn * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

template <int M, int N, int K, bool kAT, bool kBT, bool kAcc>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const float* A,
                                           int lda, const float* B, int ldb) {
  // 16 x 16 threads; thread (tm, tn) owns rows tm + 16 i and columns
  // tn + 16 j of C, so a warp reads 16 consecutive columns of B and two
  // (broadcast) elements of A per k.
  static_assert(kMonoThreads == 256, "16 x 16 thread grid");
  static_assert(M % 16 == 0 && N % 16 == 0, "16 x 16 thread grid");
  constexpr int RM = M / 16;
  constexpr int RN = N / 16;
  const int tn = threadIdx.x & 15;
  const int tm = threadIdx.x >> 4;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      acc[i][j] = kAcc ? C[(tm + 16 * i) * ldc + tn + 16 * j] : 0.f;
    }
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM];
    float b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = tm + 16 * i;
      a[i] = kAT ? A[k * lda + m] : A[m * lda + k];
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = tn + 16 * j;
      b[j] = kBT ? B[n * ldb + k] : B[k * ldb + n];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) C[(tm + 16 * i) * ldc + tn + 16 * j] = acc[i][j];
  }
}

}  // namespace dtpu
