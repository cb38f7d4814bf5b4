// Blocked flash-attention forward for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd_pallas): online-softmax attention with the band mask (causal,
// sliding `window`, `kv_offset`) and packed-sequence segment ids, giving o
// (input dtype) and lse (fp32).
//
// What bounds it on the H100: the two score-matrix products, 4·D FLOPs per
// live (query, key) pair. At the long-context training shape (B=1,
// S=16384, H=12, D=64, causal) that is 4.1e11 FLOPs over ~13 MB of
// q/k/v/o: far above the bf16 ridge, so the bound is the operations
// (0.417 ms at 989 TFLOP/s). At the serving prefill shape (B=4, S=512,
// packed documents) it is the bytes (~0.004 ms): there launch and the
// first tile's latency dominate.
//
// What the design does about it (bf16, flash_fwd_sm90):
// - Both products run on the tensor cores as wgmma (sm90.cuh) with fp32
//   accumulators in registers: S = Q·Kᵀ with A = Q and B = K from shared
//   memory, then O += P·V with A = P from registers (the S accumulator,
//   rounded to bf16 pairwise, is the A fragment) and B = V MN-major.
// - One CTA per (batch·head, 128 query rows): two consumer warpgroups of
//   64 rows each and a producer warpgroup that hands them its registers
//   (setmaxnreg); one warp of it issues the loads. It loads the Q tile
//   once by TMA and streams K/V tiles of BK keys (128 up to D = 64, 64 at
//   D = 128, so the accumulators fit the registers) through a 2-stage
//   ring of swizzled shared-memory stages under full/empty mbarriers,
//   with the tile's key segment ids beside them. It walks only the live key tiles
//   (causal: up to the last row; window: from the first row's band start),
//   the counterpart of _remap_k_index.
// - Softmax and mask state stay in registers: each thread holds two rows
//   and reduces max and sum over the four threads of its quad; p is
//   2^(s·c − m·c) with c = scale·log2(e), one FMA and one ex2 a score. A
//   tile fully inside a warpgroup's band skips the band test (the interior
//   regime of _mask_dispatch); segment ids are tested per element when
//   given. A masked p is exactly 0; p is rounded to bf16 before P·V (the
//   TPU kernel's p.astype(v.dtype)) while l sums the fp32 p, as there.
// - Under causal masking the heaviest query tiles start first.
// - A single decode row (s_q = 1) still takes a whole 128-row tile; the
//   rows past s_q are zeros from TMA and are not written.
// The fp32 path keeps the FMA kernel (flash_fwd_kernel below): a
// tensor-core fp32 product would round to TF32.
#include "attn_common.cuh"
#include "fwd_sm90.cuh"

namespace dtpu {

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;  // [B, Sq] or null
  const int* kseg;  // [B, Sk] or null
  void* o;
  float* lse;  // [B, Sq, H]
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;  // <= 0: no window
  int kv_offset;
  float scale;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int kRowsPerWarp = BQ / kWarps;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][D]
  float* k_s = q_s + BQ * D;          // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D]
  int* qseg_s = reinterpret_cast<int*>(v_s + BK * D);  // [BQ]
  int* kseg_s = qseg_s + BQ;                           // [BK]

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const bool segs = p.qseg != nullptr;
  const int warp = threadIdx.x >> 5;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
               (long long)q0 * p.q_ss;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_rows<T, D>(q_s, D, q, p.q_ss, BQ, nq);
  if (segs) {
    for (int i = threadIdx.x; i < BQ; i += kThreads)
      qseg_s[i] = i < nq ? p.qseg[(long long)b * p.Sq + q0 + i] : 0;
  }

  // Key columns any row of this block can see: the live tile range.
  const int first_q = q0 + p.kv_offset;
  const int last_q = q0 + nq - 1 + p.kv_offset;
  int k_lo = 0;
  int k_hi = p.Sk - 1;
  if (p.causal) k_hi = min(k_hi, last_q);
  if (p.window > 0) k_lo = max(k_lo, first_q - (p.window - 1));

  RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  for (int t0 = (k_lo / BK) * BK; k_lo <= k_hi && t0 <= k_hi; t0 += BK) {
    const int nk = min(BK, p.Sk - t0);
    __syncthreads();  // the previous tile is no longer read
    load_rows<T, D>(k_s, D + 1, k + (long long)t0 * p.k_ss, p.k_ss, BK, nk);
    load_rows<T, D>(v_s, D, v + (long long)t0 * p.v_ss, p.v_ss, BK, nk);
    if (segs) {
      for (int j = threadIdx.x; j < BK; j += kThreads)
        kseg_s[j] = j < nk ? p.kseg[(long long)b * p.Sk + t0 + j] : 0;
    }
    __syncthreads();
    // Interior tile: every (row, key) pair of the block is inside the
    // band, so only segment ids (if any) mask elements.
    bool inside = true;
    if (p.causal) inside = inside && t0 + nk - 1 <= first_q;
    if (p.window > 0) inside = inside && t0 >= last_q - (p.window - 1);
    const bool masked = !inside || segs;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r >= nq) break;  // uniform across the warp
      const int row = q0 + r + p.kv_offset;
      const int q_id = segs ? qseg_s[r] : 0;
      auto visible = [&](int j) {
        const int col = t0 + j;
        bool ok = true;
        if (!inside) {
          if (p.causal) ok = row >= col;
          if (p.window > 0) ok = ok && row - col < p.window;
        }
        if (segs) ok = ok && q_id == kseg_s[j];
        return ok;
      };
      attend_tile<D, BK>(st[i], q_s + r * D, k_s, v_s, nk, p.scale, masked,
                         visible);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= nq) break;
    T* o_row = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
               (long long)(q0 + r) * p.o_ss;
    write_row<T, D>(st[i], o_row,
                    p.lse + ((long long)b * p.Sq + q0 + r) * p.H + h);
  }
}

template <typename T, int D>
int launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int BQ = 32;
  constexpr int BK = D <= 64 ? 64 : 32;
  const size_t smem =
      (BQ * D + BK * (D + 1) + BK * D) * sizeof(float) + (BQ + BK) * sizeof(int);
  auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int d, const FlashParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the note at the top)
// ---------------------------------------------------------------------------
struct FwdMaps {
  CUtensorMap q, k, v;
};

template <int D>
struct FwdTile {
  static constexpr int BQ = 128;  // two consumer warpgroups of 64 rows
  static constexpr int BK = D <= 64 ? 128 : 64;
  static constexpr int kStages = 2;
  static constexpr int kThreads = sm90::kSpecThreads;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + sm90::tile_bytes(BQ, D);
  static constexpr int kV = kK + kStages * sm90::tile_bytes(BK, D);
  static constexpr int kSeg = kV + kStages * sm90::tile_bytes(BK, D);
  static constexpr int kBar = kSeg + kStages * BK * 4;
  // q_full, full[kStages], empty[kStages]; + slack to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(FwdTile<D>::kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ FwdMaps maps, const FlashParams p) {
  using L = FwdTile<D>;
  constexpr int BQ = L::BQ;
  constexpr int BK = L::BK;
  constexpr int kStages = L::kStages;
  constexpr int kSw = sm90::swizzle_bytes(D);
  constexpr int kTileK = sm90::tile_bytes(BK, D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* kseg_s = reinterpret_cast<int*>(smem + L::kSeg);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const bool segs = p.qseg != nullptr;

  // Key columns any row of this block can see: the live tile range.
  const int first_q = q0 + p.kv_offset;
  const int last_q = q0 + nq - 1 + p.kv_offset;
  int k_lo = 0;
  int k_hi = p.Sk - 1;
  if (p.causal) k_hi = min(k_hi, last_q);
  if (p.window > 0) k_lo = max(k_lo, first_q - (p.window - 1));
  const int t_first = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? k_hi / BK - t_first + 1 : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
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
    // Producer warpgroup; its first warp loads Q once, then the live K/V
    // tiles through the ring: lane 0 issues the TMA copies, every lane
    // stages key segment ids.
    sm90::regs_dec<sm90::kProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      sm90::mbar_arrive_tx(q_full, BQ * D * 2);
      sm90::tma_load_tile<D>(smem + L::kQ, &maps.q, q_full, BQ, h, q0, b);
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
        sm90::tma_load_tile<D>(smem + L::kK + s * kTileK, &maps.k, &full[s],
                               BK, h, t0, b);
        sm90::tma_load_tile<D>(smem + L::kV + s * kTileK, &maps.v, &full[s],
                               BK, h, t0, b);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup g owns rows q0 + 64g .. + 63; this thread holds
  // rows r and r + 8 of them (the accumulator layout, sm90.cuh).
  sm90::regs_inc<sm90::kConsumerRegs>();
  const int g = warp >> 2;
  const int row0 = q0 + 64 * g + 16 * (warp & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  int qid[2] = {0, 0};
  if (segs) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      qid[hh] = row < p.Sq ? p.qseg[(long long)b * p.Sq + row] : 0;
    }
  }
  const int wg_first = q0 + 64 * g + p.kv_offset;
  const int wg_last = min(q0 + 64 * g + 63, p.Sq - 1) + p.kv_offset;
  const float scale_log2 = p.scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf};  // row max of the raw scores
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const unsigned char* q_s = smem + L::kQ + g * 64 * kSw;

  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int t0 = (t_first + it) * BK;
    const unsigned char* k_s = smem + L::kK + s * kTileK;
    const unsigned char* v_s = smem + L::kV + s * kTileK;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);

    float sc[BK / 2];
    sm90::qk_product<BQ, BK, D>(sc, q_s, k_s);

    // Mask (edge tiles and segment ids only), then the row max of the raw
    // scores (scale > 0 keeps the order).
    bool inside = t0 + BK <= p.Sk;
    if (p.causal) inside = inside && t0 + BK - 1 <= wg_first;
    if (p.window > 0) inside = inside && t0 >= wg_last - (p.window - 1);
    if (!inside || segs) {
      const int* kseg_t = kseg_s + s * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + col0 + e;
            const int col = t0 + c;
            const int grow = row0 + 8 * hh + p.kv_offset;
            bool ok = col < p.Sk;
            if (p.causal) ok = ok && grow >= col;
            if (p.window > 0) ok = ok && grow - col < p.window;
            if (segs) ok = ok && qid[hh] == kseg_t[c];
            if (!ok) sc[4 * j + 2 * hh + e] = kNegInf;
          }
        }
      }
    }
    // Softmax, then O += P·V with P in bf16 (fwd_sm90.cuh).
    uint32_t pf[BK / 16][4];
    sm90::softmax_step<BK, D>(sc, m, l, o, scale_log2, pf);
    sm90::pv_product<BK, D>(o, pf, v_s);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // Epilogue: o = acc / l (l = 0 → 1), lse = m + log(l) in natural units;
  // a row that saw no key writes o = 0 and lse = NEG_INF.
  float l_safe[2];
  sm90::row_sums(l, l_safe);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= p.Sq) continue;
    __nv_bfloat16* o_row = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                           h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / l_safe[hh],
                                o[4 * j + 2 * hh + 1] / l_safe[hh]);
    }
    if ((lane & 3) == 0) {
      p.lse[((long long)b * p.Sq + row) * p.H + h] =
          sm90::row_lse(m[hh], l_safe[hh], p.scale);
    }
  }
}

template <int D>
int launch_sm90(const FlashParams& p, cudaStream_t stream) {
  using L = FwdTile<D>;
  FwdMaps maps;
  int rc = sm90::make_tile_map(&maps.q, p.q, p.B, p.Sq, p.H, D, p.q_sb,
                               p.q_ss, p.q_sh, L::BQ);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.k, p.k, p.B, p.Sk, p.H, D, p.k_sb, p.k_ss,
                             p.k_sh, L::BK);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.v, p.v, p.B, p.Sk, p.H, D, p.v_sb, p.v_ss,
                             p.v_sh, L::BK);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.B * p.H);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

inline int dispatch_sm90(int d, const FlashParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_sm90<16>(p, stream);
    case 32: return launch_sm90<32>(p, stream);
    case 64: return launch_sm90<64>(p, stream);
    case 128: return launch_sm90<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtpu

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dtpu_flash_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const int* qseg, const int* kseg, void* o, float* lse, int B, int H,
    int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, int causal, int window, int kv_offset, float scale,
    void* stream) {
  dtpu::FlashParams p;
  p.q = q; p.k = k; p.v = v; p.qseg = qseg; p.kseg = kseg;
  p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.kv_offset = kv_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B * H <= 0) return 0;
  return dtype == 1 ? dtpu::dispatch_sm90(head_dim, p, s)
                    : dtpu::dispatch_head_dim<float>(head_dim, p, s);
}
