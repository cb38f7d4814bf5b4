// Fused blocked flash-attention backward for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_bwd_fused_blocked_kernel
// (launched by _flash_bwd_pallas when _mono_ok declines and the dq
// partials fit under _FUSED_BWD_PARTIALS_CAP): one pass over the live
// (query tile, key tile) pairs that recomputes s = q kᵀ · scale and
// p = exp(s − lse) ONCE per pair and feeds all three gradients from it:
//   dv += pᵀ·do            (p rounded to the input dtype first)
//   dp  = do·vᵀ
//   ds  = p ∘ (dp − delta + dlse) · scale   (rounded to the input dtype)
//   dk += dsᵀ·q,  dq += ds·k
// under the full mask model — causal, sliding window, kv_offset, packed
// segment ids (blocked_bwd.cuh).
//
// What bounds it on the H100: five products of 2·D FLOPs per live (query,
// key) pair, 10·D in all. At the long-context training shape (B=1,
// S=16384, H=12, D=64, causal) that is 1.0e12 FLOPs over ~45 MB of
// q/k/v/do/lse/delta and dq/dk/dv: far above the bf16 ridge, so the
// roofline bound is the operations (1.04 ms at 989 TFLOP/s).
//
// What the design does about it (bf16, flash_bwd_sm90). The TPU kernel
// walks a k-major grid, sums dk/dv in VMEM over the inner query axis, and
// writes one fp32 dq partial per (key tile, query tile) that XLA sums
// after the call. Here:
// - One CTA per (batch·head, 128 keys): two consumer warpgroups of 64 keys
//   and a producer warpgroup that hands them its registers (setmaxnreg);
//   one warp of it issues the loads. K and V come once by TMA; the
//   producer streams q and do tiles of 64 rows through a 2-stage ring of
//   swizzled stages under full/empty mbarriers, with their lse / delta /
//   dlse rows and segment ids, walking only the rows that see the block's
//   keys (rows_seeing: the causal start, the window end). Blocks start with
//   key tile 0, the longest walk under causal masking.
// - All five products are wgmma (sm90.cuh) with fp32 accumulators in
//   registers. Sᵀ = K·Qᵀ and dPᵀ = V·doᵀ put the keys on M, so Pᵀ and dSᵀ,
//   formed in registers and rounded to bf16, are directly the A fragments
//   of dv += Pᵀ·do and dk += dSᵀ·q. dk and dv stay in registers for the
//   whole query loop.
// - dSᵀ of both warpgroups goes to a double-buffered shared tile; one
//   warpgroup (alternating by tile) runs dq_tile = dS·K over all 128 keys
//   and adds it into an fp32 [B, Sq, H, D] workspace with one vector
//   reduction (red.global.add.v2.f32) per element pair: the 2.0e5 tile
//   pairs at 16k add 3.2 GB, against 6.4 GB of partials (and a second
//   pass to sum them) in the TPU kernel's layout at these tiles. The sums
//   land in no fixed order, so dq is not bitwise deterministic (about
//   1e-6 relative at fp32), as in flash_bwd_mono.cu. The wrapper casts
//   the workspace.
// The fp32 path keeps the FMA tiles of mono_tiles.cuh (a tensor-core fp32
// product would round to TF32).
#include "blocked_bwd.cuh"
#include "sm90.cuh"

namespace dtpu {

// fp32: the block-wide FMA tiles of mono_tiles.cuh, dq by scalar atomics.
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kMonoThreads)
    flash_bwd_blocked_kernel(const BlockedBwdParams p) {
  using L = BlockedLayout<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const T* k_s = reinterpret_cast<const T*>(smem + L::kK);
  const T* q_s = reinterpret_cast<const T*>(smem + L::kQ);
  const T* do_s = reinterpret_cast<const T*>(smem + L::kDo);
  float* dq_s = reinterpret_cast<float*>(smem + L::kS);  // after ds
  const T* p_s = reinterpret_cast<const T*>(smem + L::kP);
  const T* ds_s = reinterpret_cast<const T*>(smem + L::kDs);
  float* dk_s = reinterpret_cast<float*>(smem + L::kAcc0);
  float* dv_s = reinterpret_cast<float*>(smem + L::kAcc1);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BK;
  const int nk = min(BK, p.Sk - k0);

  stage_key_tile<T, D, BQ, BK>(p, smem, b, h, k0, nk);
  zero_acc<D>(dk_s, L::kLdF, BK);
  zero_acc<D>(dv_s, L::kLdF, BK);

  int lo, hi;
  rows_seeing(p, k0, nk, &lo, &hi);
  for (int q0 = (lo / BQ) * BQ; lo <= hi && q0 <= hi; q0 += BQ) {
    const int nq = min(BQ, p.Sq - q0);
    __syncthreads();  // the previous tile's dq atomics read dq_s no more
    stage_query_tile<T, D, BQ, BK>(p, smem, b, h, q0, nq);
    __syncthreads();
    form_p_ds<T, D, BQ, BK>(p, smem, q0, nq, k0, nk);
    block_gemm<BK, D, BQ, true, false, true>(dv_s, L::kLdF, p_s, L::kLdP,
                                             do_s, L::kLdD);
    block_gemm<BK, D, BQ, true, false, true>(dk_s, L::kLdF, ds_s, L::kLdP,
                                             q_s, L::kLdD);
    block_gemm<BQ, D, BK, false, false, false>(dq_s, L::kLdF, ds_s, L::kLdP,
                                               k_s, L::kLdD);
    __syncthreads();
    float* dq = static_cast<float*>(p.dq) +
                (((long long)b * p.Sq + q0) * p.H + h) * D;
    for (int idx = threadIdx.x; idx < nq * D; idx += kMonoThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      atomicAdd(dq + (long long)r * p.H * D + d, dq_s[r * L::kLdF + d]);
    }
  }
  __syncthreads();
  write_acc<T, D>(p.dk, dk_s, L::kLdF, b, h, p.Sk, p.H, k0, nk);
  write_acc<T, D>(p.dv, dv_s, L::kLdF, b, h, p.Sk, p.H, k0, nk);
}

template <typename T, int D, int BQ, int BK>
struct FusedLaunch {
  static int run(const BlockedBwdParams& p, cudaStream_t stream) {
    return launch_blocked(flash_bwd_blocked_kernel<T, D, BQ, BK>,
                          BlockedLayout<T, D, BQ, BK>::kBytes,
                          (p.Sk + BK - 1) / BK, p, stream);
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the note at the top)
// ---------------------------------------------------------------------------
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
struct BwdTile {
  static constexpr int BK = 128;  // two consumer warpgroups of 64 keys
  static constexpr int BQ = 64;
  static constexpr int kStages = 2;
  static constexpr int kThreads = sm90::kSpecThreads;
  static constexpr int kTileK = sm90::tile_bytes(BK, D);
  static constexpr int kTileQ = sm90::tile_bytes(BQ, D);
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileK;
  static constexpr int kQ = kV + kTileK;                 // [kStages]
  static constexpr int kDo = kQ + kStages * kTileQ;      // [kStages]
  static constexpr int kDs = kDo + kStages * kTileQ;     // [2][BK][BQ] bf16
  static constexpr int kRows = kDs + 2 * BK * BQ * 2;    // [kStages][4][BQ]
  static constexpr int kBar = kRows + kStages * 4 * BQ * 4;
  // kv_full, full[kStages], empty[kStages]; + slack to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(BwdTile<D>::kThreads, 1)
    flash_bwd_sm90(const __grid_constant__ BwdMaps maps,
                   const BlockedBwdParams p) {
  using L = BwdTile<D>;
  constexpr int BK = L::BK;
  constexpr int BQ = L::BQ;
  constexpr int kStages = L::kStages;
  constexpr int kSw = sm90::swizzle_bytes(D);
  constexpr int DC = D < 64 ? D : 64;  // columns of one dq product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BK;
  const int nk = min(BK, p.Sk - k0);
  int lo, hi;
  rows_seeing(p, k0, nk, &lo, &hi);
  const int t_first = lo / BQ;
  const int n_tiles = lo <= hi ? hi / BQ - t_first + 1 : 0;
  const bool segs = p.qseg != nullptr;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer warp's lanes
      sm90::mbar_init(&empty[s], 8);  // the consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {
    // Producer warpgroup; its first warp loads K and V once, then the
    // query tiles that see them (q, do by TMA; lse, delta, dlse and
    // segment ids staged by the lanes).
    sm90::regs_dec<sm90::kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      sm90::mbar_arrive_tx(kv_full, 2 * BK * D * 2);
      sm90::tma_load_tile<D>(smem + L::kK, &maps.k, kv_full, BK, h, k0, b);
      sm90::tma_load_tile<D>(smem + L::kV, &maps.v, kv_full, BK, h, k0, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = (t_first + it) * BQ;
      if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
      float* rows = reinterpret_cast<float*>(smem + L::kRows) + s * 4 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const int row = q0 + r;
        const bool ok = row < p.Sq;
        const long long at = ((long long)b * p.Sq + row) * p.H + h;
        rows[r] = ok ? p.lse[at] : 0.f;
        rows[BQ + r] = ok ? p.delta[at] : 0.f;
        rows[2 * BQ + r] = ok && p.dlse != nullptr ? p.dlse[at] : 0.f;
        if (segs)
          reinterpret_cast<int*>(rows)[3 * BQ + r] =
              ok ? p.qseg[(long long)b * p.Sq + row] : 0;
      }
      if (lane == 0) {
        sm90::mbar_arrive_tx(&full[s], 2 * BQ * D * 2);
        sm90::tma_load_tile<D>(smem + L::kQ + s * L::kTileQ, &maps.q,
                               &full[s], BQ, h, q0, b);
        sm90::tma_load_tile<D>(smem + L::kDo + s * L::kTileQ, &maps.dout,
                               &full[s], BQ, h, q0, b);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup g owns keys k0 + 64g .. + 63; this thread holds
  // keys r and r + 8 of them (rows of the Sᵀ accumulator) and, in the dq
  // product, query rows r and r + 8 of the tile.
  sm90::regs_inc<sm90::kConsumerRegs>();
  const int g = warp >> 2;
  const int r_in = 16 * (warp & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int kg0 = k0 + 64 * g;
  int key[2], kid[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = kg0 + r_in + 8 * hh;
    if (segs && key[hh] < p.Sk)
      kid[hh] = p.kseg[(long long)b * p.Sk + key[hh]];
  }
  const float scale_log2 = p.scale * 1.4426950408889634f;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const unsigned char* k_a = smem + L::kK + g * 64 * kSw;  // A: this WG's keys
  const unsigned char* v_a = smem + L::kV + g * 64 * kSw;
  float* dq_ws = static_cast<float*>(p.dq);

  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int q0 = (t_first + it) * BQ;
    const unsigned char* q_s = smem + L::kQ + s * L::kTileQ;
    const unsigned char* do_s = smem + L::kDo + s * L::kTileQ;
    unsigned char* ds_s = smem + L::kDs + (it & 1) * BK * BQ * 2;
    const float* rows = reinterpret_cast<const float*>(smem + L::kRows) +
                        s * 4 * BQ;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);

    // Sᵀ = K·Qᵀ and dPᵀ = V·doᵀ (keys on M, query rows on N).
    float st[BQ / 2], dpt[BQ / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::Wgmma<BQ>::template ss<0, 0>(
          st, sm90::kmajor_desc<D>(k_a, BK, kk),
          sm90::kmajor_desc<D>(q_s, BQ, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::Wgmma<BQ>::template ss<0, 0>(
          dpt, sm90::kmajor_desc<D>(v_a, BK, kk),
          sm90::kmajor_desc<D>(do_s, BQ, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(st);
    sm90::reg_fence(dpt);

    // Pᵀ = exp(Sᵀ·scale − lse), zero where masked; dSᵀ = Pᵀ∘(dPᵀ − delta
    // + dlse)·scale.
    const bool inside = tile_inside(p, q0, BQ, kg0, 64) &&
                        q0 + BQ <= p.Sq && kg0 + 64 <= p.Sk;
    const bool masked = !inside || segs;
    const int* qid = reinterpret_cast<const int*>(rows) + 3 * BQ;
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
          bool ok = true;
          if (masked) {
            const int row = q0 + r;
            const int grow = row + p.kv_offset;
            ok = row < p.Sq && key[hh] < p.Sk;
            if (p.causal) ok = ok && grow >= key[hh];
            if (p.window > 0) ok = ok && grow - key[hh] < p.window;
            if (segs) ok = ok && qid[r] == kid[hh];
          }
          const float pv =
              ok ? sm90::ex2(fmaf(st[i], scale_log2, -lse_l2)) : 0.f;
          st[i] = pv;
          dpt[i] = pv * (dpt[i] + dterm) * p.scale;
        }
      }
    }
    // bf16 A fragments of Pᵀ and dSᵀ; dSᵀ also to shared memory
    // ([BK keys][BQ rows], 128-byte swizzle) for the dq product.
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = sm90::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        dsf[kk][r] =
            sm90::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t off = (64 * g + r_in + 8 * hh) * (BQ * 2) +
                             (8 * j + col0) * 2;
        *reinterpret_cast<uint32_t*>(ds_s + (off ^ (((off >> 7) & 7) << 4))) =
            dsf[j >> 1][2 * (j & 1) + hh];
      }
    }
    sm90::fence_proxy_async();

    // dv += Pᵀ·do, dk += dSᵀ·q (B MN-major: query rows on k).
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::Wgmma<D>::template rs<1>(dv, pf[kk],
                                     sm90::mnmajor_desc<D>(do_s, BQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::Wgmma<D>::template rs<1>(dk, dsf[kk],
                                     sm90::mnmajor_desc<D>(q_s, BQ, kk), 1);
    sm90::wgmma_commit();
    sm90::named_barrier(1, 256);  // both warpgroups' dSᵀ are in place

    if ((it & 1) == g) {
      // dq_tile = dS·K over the block's BK keys (A = dSᵀ stored MN-major,
      // B = K MN-major), DC columns at a time, added into the fp32
      // workspace with one vector reduction per element pair.
      sm90::wgmma_wait<0>();
      sm90::reg_fence(dv);
      sm90::reg_fence(dk);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
      for (int nc = 0; nc < D / DC; ++nc) {
        float dq[DC / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          sm90::Wgmma<DC>::template ss<1, 1>(
              dq, sm90::mnmajor_desc<64>(ds_s, BK, kk),
              sm90::mnmajor_desc<D>(
                  smem + L::kK + nc * sm90::block_bytes(BK, D), BK, kk),
              kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::reg_fence(dq);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = q0 + r_in + 8 * hh;
          if (row >= p.Sq) continue;
          float* out =
              dq_ws + (((long long)b * p.Sq + row) * p.H + h) * D + nc * DC;
#pragma unroll
          for (int j = 0; j < DC / 8; ++j) {
            atomicAdd(reinterpret_cast<float2*>(out + 8 * j + col0),
                      make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]));
          }
        }
      }
    } else {
      sm90::wgmma_wait<0>();
      sm90::reg_fence(dv);
      sm90::reg_fence(dk);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
  }

  // Epilogue: dk, dv of this warpgroup's keys in the input dtype.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] >= p.Sk) continue;
    const long long at = (((long long)b * p.Sk + key[hh]) * p.H + h) * D;
    __nv_bfloat16* dk_row = static_cast<__nv_bfloat16*>(p.dk) + at;
    __nv_bfloat16* dv_row = static_cast<__nv_bfloat16*>(p.dv) + at;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * j + col0) =
          __floats2bfloat162_rn(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * j + col0) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D>
int launch_sm90(const BlockedBwdParams& p, cudaStream_t stream) {
  using L = BwdTile<D>;
  BwdMaps maps;
  int rc = sm90::make_tile_map(&maps.q, p.q, p.B, p.Sq, p.H, D, p.q_sb,
                               p.q_ss, p.q_sh, L::BQ);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.dout, p.dout, p.B, p.Sq, p.H, D, p.do_sb,
                             p.do_ss, p.do_sh, L::BQ);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.k, p.k, p.B, p.Sk, p.H, D, p.k_sb, p.k_ss,
                             p.k_sh, L::BK);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.v, p.v, p.B, p.Sk, p.H, D, p.v_sb, p.v_ss,
                             p.v_sh, L::BK);
  if (rc != 0) return rc;
  auto kernel = flash_bwd_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sk + L::BK - 1) / L::BK, p.B * p.H);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

inline int dispatch_sm90(int d, const BlockedBwdParams& p,
                         cudaStream_t stream) {
  switch (d) {
    case 16: return launch_sm90<16>(p, stream);
    case 32: return launch_sm90<32>(p, stream);
    case 64: return launch_sm90<64>(p, stream);
    case 128: return launch_sm90<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtpu

// dq: a zeroed contiguous fp32 [B, Sq, H, D] workspace (the wrapper casts
// it); dk, dv: contiguous [B, Sk, H, D] in the input dtype.
extern "C" int dtpu_flash_bwd_blocked(DTPU_BLOCKED_BWD_ARGS) {
  const dtpu::BlockedBwdParams p = dtpu::make_blocked_params(
      q, k, v, dout, lse, delta, dlse, qseg, kseg, dq, dk, dv, B, H, Sq, Sk,
      strides, causal, window, kv_offset, scale);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dtpu::dispatch_sm90(head_dim, p, s)
             : dtpu::dispatch_blocked<dtpu::FusedLaunch, float>(head_dim, p, s);
}
