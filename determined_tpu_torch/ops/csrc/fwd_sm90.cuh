// One key tile of the bf16 flash-attention forward on Hopper, as a
// consumer warpgroup of flash_fwd.cu (blocked) and flash_fwd_mono.cu
// (persistent, mono) runs it: S = Q·Kᵀ by wgmma, the online-softmax
// update in registers, then O += P·V with P taken from registers. The
// kernels differ in how they load tiles, walk them and mask them; these
// steps are the same. The two-pass backward's dq pass (flash_bwd_dq.cu)
// is the same walk with S = Q·Kᵀ and dP = do·Vᵀ issued together
// (qk_issue) and dq += dS·K as pv_product with the K tile for V.
//
// Register layout (sm90.cuh): the warpgroup owns 64 query rows, this
// thread rows r and r + 8 of them; sc[4j + 2h + e] is the score of row
// r + 8h and key 8j + 2(l%4) + e of the tile, o[4j + 2h + e] the
// accumulator of the same row and head-dim column 8j + 2(l%4) + e.
#pragma once

#include "sm90.cuh"

namespace dtpu {
namespace sm90 {

// Issue S = Q·Kᵀ for the warpgroup's 64 rows (no fence, commit or wait):
// `q_s` points at its rows inside a Q tile of `BQ` rows, `k_s` at a K
// tile of BK keys (both K-major).
template <int BQ, int BK, int D>
__device__ __forceinline__ void qk_issue(float (&sc)[BK / 2],
                                         const unsigned char* q_s,
                                         const unsigned char* k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    Wgmma<BK>::template ss<0, 0>(sc, kmajor_desc<D>(q_s, BQ, kk),
                                 kmajor_desc<D>(k_s, BK, kk), kk > 0);
  }
}

// S = Q·Kᵀ (qk_issue), waited for.
template <int BQ, int BK, int D>
__device__ __forceinline__ void qk_product(float (&sc)[BK / 2],
                                           const unsigned char* q_s,
                                           const unsigned char* k_s) {
  wgmma_fence();
  qk_issue<BQ, BK, D>(sc, q_s, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sc);
}

// The online-softmax step on masked raw scores `sc` (a masked score is
// kNegInf): new row max m, l and o rescaled, p = 2^(s·c − m·c) with c =
// scale·log2(e) (a masked s gives exactly 0), l += the fp32 p, and P
// rounded to bf16 as the A fragments of O += P·V (the TPU kernel's
// p.astype(v.dtype)). Row max and sum reduce over the thread's quad.
template <int BK, int D>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[D / 2],
                                             float scale_log2,
                                             uint32_t (&pf)[BK / 16][4]) {
  float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      tmax[hh] = fmaxf(tmax[hh],
                       fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
  }
  float corr[2], mb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
    const float m_new = fmaxf(m[hh], tmax[hh]);
    corr[hh] = ex2((m[hh] - m_new) * scale_log2);
    m[hh] = m_new;
    l[hh] *= corr[hh];
    // A row with no live key yet keeps p = 2^(−1e30·c) = 0 below.
    mb[hh] = m_new <= kNegInf ? 0.f : m_new * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        const float pv = ex2(fmaf(sc[i], scale_log2, -mb[hh]));
        l[hh] += pv;
        sc[i] = pv;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      o[4 * j + 2 * hh] *= corr[hh];
      o[4 * j + 2 * hh + 1] *= corr[hh];
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
}

// O += P·V: A = P from registers, B = the V tile of BK keys MN-major.
template <int BK, int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pf)[BK / 16][4],
                                           const unsigned char* v_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    Wgmma<D>::template rs<1>(o, pf[kk], mnmajor_desc<D>(v_s, BK, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);
}

// The row sum of this thread's two rows over the quad, and its safe
// divisor (l = 0, a row that saw no key, → 1).
__device__ __forceinline__ void row_sums(const float (&l)[2],
                                         float (&l_safe)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    l_safe[hh] = lt == 0.f ? 1.f : lt;
  }
}

// lse = m·scale + log(l) in natural units; a row that saw no key gets
// NEG_INF.
__device__ __forceinline__ float row_lse(float m, float l_safe, float scale) {
  return m <= kNegInf ? kNegInf : m * scale + logf(l_safe);
}

}  // namespace sm90
}  // namespace dtpu
