// Two-pass flash-attention backward, dq pass, for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (launched by _flash_bwd_pallas past _FUSED_BWD_PARTIALS_CAP, beside the
// dk/dv pass of flash_bwd_dkv.cu): per live (query row, key) pair it
// recomputes s = q kᵀ · scale and p = exp(s − lse), exactly 0 where masked,
// and sums
//   dq += ds·k,  ds = p ∘ (do·vᵀ − delta + dlse) · scale  (rounded to the
//                                                          input dtype)
// over the keys the row sees, under the full mask model (blocked_bwd.cuh).
//
// What bounds it on the H100: three products of 2·D FLOPs per live pair,
// 6·D in all. At the 32k training shape (B=1, S=32768, H=12, D=64,
// causal) that is 2.47e12 FLOPs over ~255 MB of q, k, v, do and dq: the
// operations bound it (2.50 ms at 989 TFLOP/s bf16).
//
// What the design does about it (bf16, flash_bwd_dq_sm90): the q-major
// mirror of the dk/dv pass, on the blocked forward's skeleton.
// - One CTA per (batch·head, 128 query rows): two consumer warpgroups of
//   64 rows each and a producer warpgroup that hands them its registers
//   (setmaxnreg); one warp of it issues the loads. Q and do come once by
//   TMA under one mbarrier; each consumer thread holds two rows and keeps
//   their lse, delta − dlse and segment ids in registers for the whole
//   walk. K and V tiles of BK keys stream through a 4-stage ring of
//   swizzled stages under full/empty mbarriers, with the tile's key
//   segment ids beside them. BK is 128 up to D = 64 and 64 at D = 128, so
//   that S and dP (BK/2 fp32 each), dq (D/2 fp32) and the bf16 dS
//   fragments (BK/4) fit the consumer's registers without spills: 192 of
//   them at D = 64, 144 at D = 128 (BK = 128 there would need 224). At
//   the 32k shape BK = 128 runs 7.60 ms against 8.78 for BK = 64 (H100
//   80GB HBM3, 700 W).
// - The CTA walks only the key tiles its rows can see (keys_seen), the
//   heaviest query tiles first under causal masking; a warpgroup skips
//   the products of a tile none of its own rows sees (it still releases
//   the stage), and a tile inside its band (tile_inside) with no segment
//   ids skips the element mask.
// - S = Q·Kᵀ and dP = do·Vᵀ by wgmma with the queries on M, committed
//   together (fwd_sm90.cuh qk_issue); P and dS are formed in registers,
//   dS rounded to bf16 pairwise into A fragments, and dq += dS·K takes B
//   = the K tile MN-major (fwd_sm90.cuh pv_product, K where the forward
//   has V).
// - dq stays in the consumer's registers for the whole walk and is
//   written once in bf16: no workspace, no zeroing, no atomics, a fixed
//   summation order (bitwise deterministic). Rows past Sq (TMA's zero
//   fill) are not written; a row that sees no key writes dq = 0.
// fp32 keeps the block-wide FMA kernel (flash_bwd_dq_kernel below, tiles
// of mono_tiles.cuh with the dq accumulator in shared memory): a
// tensor-core fp32 product would round to TF32.
#include "blocked_bwd.cuh"
#include "fwd_sm90.cuh"

namespace dtpu {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kMonoThreads)
    flash_bwd_dq_kernel(const BlockedBwdParams p) {
  using L = BlockedLayout<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const T* k_s = reinterpret_cast<const T*>(smem + L::kK);
  const T* ds_s = reinterpret_cast<const T*>(smem + L::kDs);
  float* dq_s = reinterpret_cast<float*>(smem + L::kAcc0);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, p.Sq - q0);

  stage_query_tile<T, D, BQ, BK>(p, smem, b, h, q0, nq);
  zero_acc<D>(dq_s, L::kLdF, BQ);

  int lo, hi;
  keys_seen(p, q0, nq, &lo, &hi);
  for (int k0 = (lo / BK) * BK; lo <= hi && k0 <= hi; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile's products read k, v no more
    stage_key_tile<T, D, BQ, BK>(p, smem, b, h, k0, nk);
    __syncthreads();
    form_p_ds<T, D, BQ, BK>(p, smem, q0, nq, k0, nk);
    block_gemm<BQ, D, BK, false, false, true>(dq_s, L::kLdF, ds_s, L::kLdP,
                                              k_s, L::kLdD);
  }
  __syncthreads();
  write_acc<T, D>(p.dq, dq_s, L::kLdF, b, h, p.Sq, p.H, q0, nq);
}

template <typename T, int D, int BQ, int BK>
struct DqLaunch {
  static int run(const BlockedBwdParams& p, cudaStream_t stream) {
    return launch_blocked(flash_bwd_dq_kernel<T, D, BQ, BK>,
                          BlockedLayout<T, D, BQ, BK>::kBytes,
                          (p.Sq + BQ - 1) / BQ, p, stream);
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the note at the top)
// ---------------------------------------------------------------------------
struct DqMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
struct DqTile {
  static constexpr int BQ = 128;  // two consumer warpgroups of 64 rows
  static constexpr int BK = D <= 64 ? 128 : 64;  // see the note at the top
  static constexpr int kStages = 4;
  static constexpr int kThreads = sm90::kSpecThreads;
  static constexpr int kTileQ = sm90::tile_bytes(BQ, D);
  static constexpr int kTileK = sm90::tile_bytes(BK, D);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTileQ;
  static constexpr int kK = kDo + kTileQ;             // [kStages]
  static constexpr int kV = kK + kStages * kTileK;    // [kStages]
  static constexpr int kSeg = kV + kStages * kTileK;  // [kStages][BK] ids
  static constexpr int kBar = kSeg + kStages * BK * 4;
  // qdo_full, full[kStages], empty[kStages]; + slack to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(DqTile<D>::kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ DqMaps maps,
                      const BlockedBwdParams p) {
  using L = DqTile<D>;
  constexpr int BQ = L::BQ;
  constexpr int BK = L::BK;
  constexpr int kStages = L::kStages;
  constexpr int kSw = sm90::swizzle_bytes(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kSeg);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const bool segs = p.qseg != nullptr;
  int lo, hi;
  keys_seen(p, q0, nq, &lo, &hi);
  const int t_first = lo / BK;
  const int n_tiles = lo <= hi ? hi / BK - t_first + 1 : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
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
    // Producer warpgroup; its first warp loads Q and do once, then the
    // live K/V tiles through the ring: lane 0 issues the TMA copies,
    // every lane stages key segment ids.
    sm90::regs_dec<sm90::kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      sm90::mbar_arrive_tx(qdo_full, 2 * BQ * D * 2);
      sm90::tma_load_tile<D>(smem + L::kQ, &maps.q, qdo_full, BQ, h, q0, b);
      sm90::tma_load_tile<D>(smem + L::kDo, &maps.dout, qdo_full, BQ, h, q0,
                             b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int t0 = (t_first + it) * BK;
      if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
      if (segs) {
        for (int j = lane; j < BK; j += 32)
          kseg_s[s * BK + j] =
              t0 + j < p.Sk ? p.kseg[(long long)b * p.Sk + t0 + j] : 0;
      }
      if (lane == 0) {
        sm90::mbar_arrive_tx(&full[s], 2 * BK * D * 2);
        sm90::tma_load_tile<D>(smem + L::kK + s * L::kTileK, &maps.k,
                               &full[s], BK, h, t0, b);
        sm90::tma_load_tile<D>(smem + L::kV + s * L::kTileK, &maps.v,
                               &full[s], BK, h, t0, b);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup g owns rows wq0 .. wq0 + 63; this thread holds rows
  // r and r + 8 of them (the accumulator layout, sm90.cuh), with their
  // row terms in registers.
  sm90::regs_inc<sm90::kConsumerRegs>();
  const int g = warp >> 2;
  const int wq0 = q0 + 64 * g;
  const int wn = min(64, p.Sq - wq0);  // the warpgroup's rows (<= 0: none)
  const int r_in = 16 * (warp & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float scale_log2 = p.scale * 1.4426950408889634f;
  float lse_l2[2] = {0.f, 0.f};  // lse · log2(e)
  float dterm[2] = {0.f, 0.f};   // dlse − delta
  int qid[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = wq0 + r_in + 8 * hh;
    if (row >= p.Sq) continue;
    const long long at = ((long long)b * p.Sq + row) * p.H + h;
    lse_l2[hh] = p.lse[at] * 1.4426950408889634f;
    dterm[hh] = (p.dlse != nullptr ? p.dlse[at] : 0.f) - p.delta[at];
    if (segs) qid[hh] = p.qseg[(long long)b * p.Sq + row];
  }
  int wlo = 0, whi = -1;  // the keys the warpgroup's rows see
  if (wn > 0) keys_seen(p, wq0, wn, &wlo, &whi);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const unsigned char* q_s = smem + L::kQ + g * 64 * kSw;
  const unsigned char* do_s = smem + L::kDo + g * 64 * kSw;

  sm90::mbar_wait(qdo_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int t0 = (t_first + it) * BK;
    const unsigned char* k_s = smem + L::kK + s * L::kTileK;
    const unsigned char* v_s = smem + L::kV + s * L::kTileK;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    if (wlo <= whi && t0 <= whi && t0 + BK > wlo) {
      // S = Q·Kᵀ and dP = do·Vᵀ (queries on M, keys on N), one wait.
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
      sm90::qk_issue<BQ, BK, D>(sc, q_s, k_s);
      sm90::qk_issue<BQ, BK, D>(dp, do_s, v_s);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(sc);
      sm90::reg_fence(dp);

      // p = 2^(s·c − lse·c), zero where masked (edge tiles and segment
      // ids only); ds = p (dp − delta + dlse) · scale into `sc`.
      const bool masked = segs || !(t0 + BK <= p.Sk &&
                                    tile_inside(p, wq0, wn, t0, BK));
      const int* kseg_t = kseg_s + s * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            const int c = 8 * j + col0 + e;
            bool ok = true;
            if (masked) {
              const int col = t0 + c;
              const int grow = wq0 + r_in + 8 * hh + p.kv_offset;
              ok = col < p.Sk;
              if (p.causal) ok = ok && grow >= col;
              if (p.window > 0) ok = ok && grow - col < p.window;
              if (segs) ok = ok && qid[hh] == kseg_t[c];
            }
            const float pv =
                ok ? sm90::ex2(fmaf(sc[i], scale_log2, -lse_l2[hh])) : 0.f;
            sc[i] = pv * (dp[i] + dterm[hh]) * p.scale;
          }
        }
      }
      // dq += dS·K: dS rounded to bf16 as A fragments, B = K MN-major.
      uint32_t dsf[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dsf[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r],
                                       sc[8 * kk + 2 * r + 1]);
      }
      sm90::pv_product<BK, D>(dq, dsf, k_s);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // Epilogue: dq of this thread's rows in bf16, straight from registers.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = wq0 + r_in + 8 * hh;
    if (row >= p.Sq) continue;
    __nv_bfloat16* dq_row = static_cast<__nv_bfloat16*>(p.dq) +
                            (((long long)b * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j + col0) =
          __floats2bfloat162_rn(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D>
int launch_dq_sm90(const BlockedBwdParams& p, cudaStream_t stream) {
  using L = DqTile<D>;
  DqMaps maps;
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
  auto kernel = flash_bwd_dq_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.B * p.H);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

inline int dispatch_dq_sm90(int d, const BlockedBwdParams& p,
                            cudaStream_t stream) {
  switch (d) {
    case 16: return launch_dq_sm90<16>(p, stream);
    case 32: return launch_dq_sm90<32>(p, stream);
    case 64: return launch_dq_sm90<64>(p, stream);
    case 128: return launch_dq_sm90<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtpu

// dq: contiguous [B, Sq, H, D] in the input dtype; dk, dv: unused (null).
// bf16 loads q, k, v and do by TMA (16-byte-aligned bases and strides:
// the wrapper copies a view that breaks the rule).
extern "C" int dtpu_flash_bwd_dq(DTPU_BLOCKED_BWD_ARGS) {
  const dtpu::BlockedBwdParams p = dtpu::make_blocked_params(
      q, k, v, dout, lse, delta, dlse, qseg, kseg, dq, dk, dv, B, H, Sq, Sk,
      strides, causal, window, kv_offset, scale);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dtpu::dispatch_dq_sm90(head_dim, p, s)
                    : dtpu::dispatch_blocked_fp32<dtpu::DqLaunch>(
                          head_dim, p, s);
}
