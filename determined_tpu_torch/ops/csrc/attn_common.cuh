// Shared pieces of the port's attention kernels (flash_fwd.cu,
// paged_attention.cu): type conversion, warp reductions, tile loading and
// the one online-softmax step both kernels run per (query row, K/V tile).
//
// Layout of the work: a block of kThreads threads stages one K/V tile of
// BK keys in shared memory as fp32; each warp owns whole query rows. For a
// row, lane j scores keys j, j+32, ... of the tile (a full head-dim dot
// against the broadcast query row), the warp reduces max and sum with
// shuffles, and then accumulates P·V with lane j owning head-dim columns
// j, j+32, .... All softmax state (m, l, acc) stays in fp32 registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtpu {

// Finite mask value, as ops/flash_attention.py NEG_INF: a true -inf would
// turn the m-subtraction of a fully masked row into NaN.
constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
// Returned by an entry point whose TMA tensor map could not be encoded.
constexpr int kTmaEncodeError = 999;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy `n_rows` rows of D elements (row r at src + r * row_stride) into
// shared memory as fp32 with a row stride of `dst_stride`; rows at or past
// `n_valid` are zero-filled. Neighbouring threads read neighbouring
// elements of a row.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* src, long long row_stride,
                                          int n_rows, int n_valid) {
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * dst_stride + d] =
        r < n_valid ? to_float(src[(long long)r * row_stride + d]) : 0.f;
  }
}

// Online-softmax state of one query row, held by the warp that owns it:
// lane i keeps head-dim columns i, i + 32, ....
template <int D>
struct RowState {
  static constexpr int kPerLane = (D + 31) / 32;
  float m;
  float l;
  float acc[kPerLane];

  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;
  }
};

// One K/V tile against one query row, warp-wide. `q_row` is the row in
// shared memory [D]; `k_s` is [BK][D + 1] (the +1 keeps lanes that read
// different key rows on different banks), `v_s` is [BK][D]. Keys at or
// past `n_valid` are tile padding. When `masked`, `visible(j)` says
// whether key j of the tile is attended; masked probabilities are zeroed
// explicitly, never left to exp underflow (a fully masked row must end
// with l = 0, o = 0 and lse = NEG_INF).
template <int D, int BK, typename Visible>
__device__ __forceinline__ void attend_tile(RowState<D>& st,
                                            const float* q_row,
                                            const float* k_s,
                                            const float* v_s, int n_valid,
                                            float scale, bool masked,
                                            Visible visible) {
  constexpr int kKeysPerLane = BK / 32;
  const int lane = threadIdx.x & 31;
  float s[kKeysPerLane];
  bool live[kKeysPerLane];
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    float dot = 0.f;
    if (j < n_valid) {
      const float* kr = k_s + j * (D + 1);
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(q_row[d], kr[d], dot);
    }
    live[t] = j < n_valid && (!masked || visible(j));
    s[t] = live[t] ? dot * scale : kNegInf;
  }
  float tile_max = s[0];
#pragma unroll
  for (int t = 1; t < kKeysPerLane; ++t) tile_max = fmaxf(tile_max, s[t]);
  tile_max = warp_max(tile_max);
  const float m_new = fmaxf(st.m, tile_max);
  float p[kKeysPerLane];
  float p_sum = 0.f;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    p[t] = live[t] ? expf(s[t] - m_new) : 0.f;
    p_sum += p[t];
  }
  p_sum = warp_sum(p_sum);
  const float corr = expf(st.m - m_new);
  st.l = st.l * corr + p_sum;
#pragma unroll
  for (int i = 0; i < RowState<D>::kPerLane; ++i) st.acc[i] *= corr;
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    for (int src = 0; src < 32; ++src) {
      const int j = 32 * t + src;
      if (j >= n_valid) break;  // uniform across the warp
      const float pj = __shfl_sync(0xffffffffu, p[t], src);
#pragma unroll
      for (int i = 0; i < RowState<D>::kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) st.acc[i] = fmaf(pj, v_s[j * D + d], st.acc[i]);
      }
    }
  }
  st.m = m_new;
}

// Epilogue of one row: o = acc / l (l = 0 → 1, so a fully masked row
// writes zeros) and, when `lse` is given, lse = m + log(l).
template <typename T, int D>
__device__ __forceinline__ void write_row(const RowState<D>& st, T* o_row,
                                          float* lse) {
  const int lane = threadIdx.x & 31;
  const float l_safe = st.l == 0.f ? 1.f : st.l;
#pragma unroll
  for (int i = 0; i < RowState<D>::kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o_row[d] = from_float<T>(st.acc[i] / l_safe);
  }
  if (lse != nullptr && lane == 0) *lse = st.m + logf(l_safe);
}

}  // namespace dtpu

// Error text for a code returned by an entry point of this library.
extern "C" const char* dtpu_error_string(int code) {
  if (code == dtpu::kTmaEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (base or strides "
           "not 16-byte aligned?)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
