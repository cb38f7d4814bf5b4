// One (query tile, key tile) pair of the bf16 flash-attention backward on
// Hopper, as a consumer warpgroup of flash_bwd_blocked.cu (fused blocked)
// and flash_bwd_mono.cu (persistent, mono) runs it. The CTA owns BK keys,
// 64 a warpgroup; a query tile holds BQ = 64 rows:
//   Sᵀ = K·Qᵀ, dPᵀ = V·doᵀ               (keys on M)
//   Pᵀ = exp(Sᵀ·scale − lse), zero where masked
//   dSᵀ = Pᵀ∘(dPᵀ − delta + dlse)·scale
//   dv += bf16(Pᵀ)·do, dk += bf16(dSᵀ)·q (A from registers)
//   dq_tile = dS·K                        (dSᵀ through shared memory)
// The kernels differ in how they load tiles, walk them and mask them, and
// in what they do with dq; these steps are the same.
//
// Register layout (sm90.cuh): this thread holds keys r_in and r_in + 8 of
// its warpgroup's 64 (rows of the Sᵀ accumulator); st[4j + 2h + e] is the
// pair of key r_in + 8h and query row 8j + 2(l%4) + e of the tile.
#pragma once

#include "sm90.cuh"

namespace dtpu {
namespace sm90 {

constexpr int kBwdBQ = 64;  // query rows of a tile

// Sᵀ = K·Qᵀ and dPᵀ = V·doᵀ: `k_a` / `v_a` point at the warpgroup's 64
// keys inside K / V tiles of BK keys, `q_s` / `do_s` at tiles of BQ rows.
template <int BK, int D>
__device__ __forceinline__ void st_dpt_products(
    float (&st)[kBwdBQ / 2], float (&dpt)[kBwdBQ / 2],
    const unsigned char* k_a, const unsigned char* v_a,
    const unsigned char* q_s, const unsigned char* do_s) {
  constexpr int BQ = kBwdBQ;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    Wgmma<BQ>::template ss<0, 0>(st, kmajor_desc<D>(k_a, BK, kk),
                                 kmajor_desc<D>(q_s, BQ, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    Wgmma<BQ>::template ss<0, 0>(dpt, kmajor_desc<D>(v_a, BK, kk),
                                 kmajor_desc<D>(do_s, BQ, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(st);
  reg_fence(dpt);
}

// Pᵀ into `st` and dSᵀ into `dpt`. `rows` holds the tile's lse, delta and
// dlse ([3][BQ] fp32). When `masked`, `live(r, hh)` says whether the pair
// (query row r of the tile, key r_in + 8·hh) is attended; a masked p is
// exactly 0 (a row with no live key carries lse ≈ NEG_INF).
template <typename Live>
__device__ __forceinline__ void p_ds(float (&st)[kBwdBQ / 2],
                                     float (&dpt)[kBwdBQ / 2],
                                     const float* rows, float scale_log2,
                                     float scale, bool masked, int col0,
                                     Live live) {
  constexpr int BQ = kBwdBQ;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + col0 + e;
      const float lse_l2 = rows[r] * 1.4426950408889634f;
      const float dterm = rows[2 * BQ + r] - rows[BQ + r];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh + e;
        const bool ok = !masked || live(r, hh);
        const float pv = ok ? ex2(fmaf(st[i], scale_log2, -lse_l2)) : 0.f;
        st[i] = pv;
        dpt[i] = pv * (dpt[i] + dterm) * scale;
      }
    }
  }
}

// Pᵀ and dSᵀ rounded to bf16 as the A fragments of dv and dk; dSᵀ also
// into the shared tile `ds_s` ([BK keys][BQ rows], 128-byte swizzle) at
// the warpgroup's keys (key_row = 64g + r_in) for the dq product.
__device__ __forceinline__ void pack_p_ds(const float (&st)[kBwdBQ / 2],
                                          const float (&dpt)[kBwdBQ / 2],
                                          uint32_t (&pf)[kBwdBQ / 16][4],
                                          uint32_t (&dsf)[kBwdBQ / 16][4],
                                          unsigned char* ds_s, int key_row,
                                          int col0) {
  constexpr int BQ = kBwdBQ;
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pf[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
      dsf[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t off = (key_row + 8 * hh) * (BQ * 2) + (8 * j + col0) * 2;
      *reinterpret_cast<uint32_t*>(ds_s + (off ^ (((off >> 7) & 7) << 4))) =
          dsf[j >> 1][2 * (j & 1) + hh];
    }
  }
  fence_proxy_async();
}

// dv += Pᵀ·do, dk += dSᵀ·q (B MN-major: query rows on k). Committed, not
// waited for.
template <int D>
__device__ __forceinline__ void dkdv_products(
    float (&dv)[D / 2], float (&dk)[D / 2],
    const uint32_t (&pf)[kBwdBQ / 16][4],
    const uint32_t (&dsf)[kBwdBQ / 16][4], const unsigned char* do_s,
    const unsigned char* q_s) {
  constexpr int BQ = kBwdBQ;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    Wgmma<D>::template rs<1>(dv, pf[kk], mnmajor_desc<D>(do_s, BQ, kk), 1);
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    Wgmma<D>::template rs<1>(dk, dsf[kk], mnmajor_desc<D>(q_s, BQ, kk), 1);
  wgmma_commit();
}

// dq_tile = dS·K over the CTA's BK keys (A = dSᵀ stored MN-major, B = K
// MN-major), 64 columns at a time, added into the fp32 rows of one head
// (`dq_head` = row 0, rows `row_stride` apart) with one vector reduction
// per element pair; rows at or past `s_q` are tile padding.
template <int BK, int D>
__device__ __forceinline__ void dq_reduce(const unsigned char* ds_s,
                                          const unsigned char* k_tile,
                                          float* dq_head,
                                          long long row_stride, int q0,
                                          int s_q, int r_in, int col0) {
  constexpr int DC = D < 64 ? D : 64;  // columns of one product
#pragma unroll
  for (int nc = 0; nc < D / DC; ++nc) {
    float dq[DC / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Wgmma<DC>::template ss<1, 1>(
          dq, mnmajor_desc<64>(ds_s, BK, kk),
          mnmajor_desc<D>(k_tile + nc * block_bytes(BK, D), BK, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r_in + 8 * hh;
      if (row >= s_q) continue;
      float* out = dq_head + row * row_stride + nc * DC;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        atomicAdd(reinterpret_cast<float2*>(out + 8 * j + col0),
                  make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]));
      }
    }
  }
}

// The epilogue of the warpgroup's keys key[0], key[1]: dk and dv in bf16
// into contiguous [B, Sk, H, D] outputs at element offsets at[hh] (keys
// at or past Sk are skipped: key_ok[hh] false).
template <int D>
__device__ __forceinline__ void store_dkdv(const float (&dk)[D / 2],
                                           const float (&dv)[D / 2],
                                           void* dk_out, void* dv_out,
                                           const long long (&at)[2],
                                           const bool (&key_ok)[2],
                                           int col0) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!key_ok[hh]) continue;
    __nv_bfloat16* dk_row = static_cast<__nv_bfloat16*>(dk_out) + at[hh];
    __nv_bfloat16* dv_row = static_cast<__nv_bfloat16*>(dv_out) + at[hh];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * j + col0) =
          __floats2bfloat162_rn(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * j + col0) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

}  // namespace sm90
}  // namespace dtpu
