// Flash-attention forward for the monolithic path, for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_fwd_kernel_mono
// (launched by _mono_fwd_call when _mono_ok holds: one block spans the
// whole sequence, s_q * s_k <= 2^21, no window, no segment ids, no
// kv_offset). It computes o = softmax(q kᵀ · scale) v with an optional
// causal mask, o in the input dtype and lse = m + log(l) in fp32, with p
// rounded to the input dtype before the p·v product as the TPU kernel
// does.
//
// What bounds it on the H100: 4·D FLOPs per live (query, key) pair. At the
// GPT-2 training shape (B=8, S=1024, H=12, D=64, causal) that is 1.3e10
// FLOPs against 50 MB of q/k/v/o read or written once — ~260 FLOPs per
// byte, just under the 295 FLOP/byte bf16 ridge, so the roofline bound is
// the bytes (~15 us), with the operations close behind.
//
// What the design does about it (bf16, flash_fwd_mono_sm90). The TPU
// kernel holds the whole [S, S] fp32 score matrix in VMEM (4 MB at S =
// 1024); a Hopper CTA has 227 KB, so here "mono" is the specialisation
// _mono_ok guarantees, not one tile: no segment ids, window or kv_offset to
// load or test, and only a tile that crosses the causal diagonal (or the
// ragged end of the keys) masks per element. At S <= 1448 a CTA walks at
// most 12 key tiles, too few to amortise a CTA's prologue, pipeline fill
// and epilogue; so the kernel is persistent:
// - a grid of one CTA a SM walks the work items (batch·head, 128 query
//   rows), the heaviest causal ones first, dealt out in snake order
//   (sm90.cuh `snake_item`);
// - each CTA runs flash_fwd.cu's warp-specialised design: two consumer
//   warpgroups of 64 rows and a producer warp that loads Q by TMA into one
//   of two buffers and streams K/V tiles (128 keys, 64 at D = 128) through a
//   3-stage ring under full/empty mbarriers. The ring and the Q buffers
//   run across item boundaries, so the next item's Q and first K/V tiles
//   arrive while the current item is finishing;
// - both products are wgmma with fp32 accumulators in registers; the S
//   accumulator, rounded to bf16 pairwise, is the A fragment of O += P·V
//   (fwd_sm90.cuh, shared with flash_fwd.cu); p is rounded to bf16 before
//   P·V while l sums the fp32 p, as the TPU kernel does;
// - the epilogue writes o into a swizzled staging tile per warpgroup and
//   one thread stores it by TMA (full 128-byte lines, clipped at S), which
//   overlaps the next item's first products.
// The fp32 path keeps the FMA kernel below (flash_fwd_mono_kernel,
// mono_tiles.cuh): a tensor-core fp32 product would round to TF32.
#include "fwd_sm90.cuh"
#include "mono_tiles.cuh"

namespace dtpu {

struct MonoFwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Sq, H]
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale;
};

template <typename T, int D, int BQ, int BK>
struct FwdLayout {
  static constexpr int kLdD = ld_of<T>(D);       // q, k, v tiles
  static constexpr int kLdP = ld_of<T>(BK);      // p tile
  static constexpr int kLdS = ld_of<float>(BK);  // fp32 scores
  static constexpr int kLdO = ld_of<float>(D);   // fp32 accumulator
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + tile_bytes<T>(BQ, D);
  static constexpr int kV = kK + tile_bytes<T>(BK, D);
  static constexpr int kS = kV + tile_bytes<T>(BK, D);
  static constexpr int kP = kS + tile_bytes<float>(BQ, BK);
  static constexpr int kO = kP + tile_bytes<T>(BQ, BK);
  static constexpr int kBytes = kO + tile_bytes<float>(BQ, D);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kMonoThreads)
    flash_fwd_mono_kernel(const MonoFwdParams p) {
  using L = FwdLayout<T, D, BQ, BK>;
  constexpr int kRows = BQ / kMonoWarps;  // query rows per warp
  constexpr int kCols = BK / 32;          // key columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  T* k_s = reinterpret_cast<T*>(smem + L::kK);
  T* v_s = reinterpret_cast<T*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  T* p_s = reinterpret_cast<T*>(smem + L::kP);
  float* o_s = reinterpret_cast<float*>(smem + L::kO);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // Last query tile first: under the causal mask it has the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
               (long long)q0 * p.q_ss;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  stage_rows<T, D>(q_s, L::kLdD, q, p.q_ss, BQ, nq);
  for (int idx = threadIdx.x; idx < BQ * D; idx += kMonoThreads) {
    o_s[(idx / D) * L::kLdO + idx % D] = 0.f;
  }

  float m_r[kRows];
  float l_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }

  // Keys any row of this block can see.
  const int k_end = p.causal ? min(p.Sk, q0 + nq) : p.Sk;
  for (int t0 = 0; t0 < k_end; t0 += BK) {
    const int nk = min(BK, p.Sk - t0);
    __syncthreads();  // the previous tile's p·v no longer reads v_s, p_s
    stage_rows<T, D>(k_s, L::kLdD, k + (long long)t0 * p.k_ss, p.k_ss, BK, nk);
    stage_rows<T, D>(v_s, L::kLdD, v + (long long)t0 * p.v_ss, p.v_ss, BK, nk);
    __syncthreads();
    block_gemm<BQ, BK, D, false, true, false>(s_s, L::kLdS, q_s, L::kLdD, k_s,
                                              L::kLdD);
    __syncthreads();
    // Only the tile that crosses the diagonal masks per element.
    const bool diag = p.causal && t0 + BK - 1 > q0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + kMonoWarps * i;
      const int row = q0 + r;
      const float* s_row = s_s + r * L::kLdS;
      float sv[kCols];
      bool live[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        live[j] = c < nk && (!diag || t0 + c <= row);
        sv[j] = live[j] ? s_row[c] * p.scale : kNegInf;
        mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      const float corr = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = live[j] ? expf(sv[j] - m_new) : 0.f;
        p_s[r * L::kLdP + lane + 32 * j] = from_float<T>(pj);
        sum += pj;
      }
      sum = warp_sum(sum);
      l_r[i] = l_r[i] * corr + sum;
      m_r[i] = m_new;
      float* o_row = o_s + r * L::kLdO;
      for (int d = lane; d < D; d += 32) o_row[d] *= corr;
    }
    __syncthreads();
    block_gemm<BQ, D, BK, false, false, true>(o_s, L::kLdO, p_s, L::kLdP, v_s,
                                              L::kLdD);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kMonoWarps * i;
    if (r >= nq) continue;  // uniform across the warp
    const float l_safe = l_r[i] == 0.f ? 1.f : l_r[i];
    T* o_row = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
               (long long)(q0 + r) * p.o_ss;
    for (int d = lane; d < D; d += 32) {
      o_row[d] = from_float<T>(o_s[r * L::kLdO + d] / l_safe);
    }
    if (lane == 0) {
      p.lse[((long long)b * p.Sq + q0 + r) * p.H + h] = m_r[i] + logf(l_safe);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const MonoFwdParams& p, cudaStream_t stream) {
  using L = FwdLayout<T, D, BQ, BK>;
  auto kernel = flash_fwd_mono_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kMonoThreads, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// fp32: 32-row tiles of the FMA kernel.
inline int dispatch_fp32(int d, const MonoFwdParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<float, 16, 32, 32>(p, stream);
    case 32: return launch<float, 32, 32, 32>(p, stream);
    case 64: return launch<float, 64, 32, 32>(p, stream);
    case 128: return launch<float, 128, 32, 32>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: persistent wgmma + TMA kernel (see the note at the top)
// ---------------------------------------------------------------------------
struct MonoFwdMaps {
  CUtensorMap q, k, v, o;
};

template <int D>
struct MonoFwdTile {
  static constexpr int BQ = 128;  // two consumer warpgroups of 64 rows
  static constexpr int BK = D <= 64 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kThreads = sm90::kSpecThreads;
  static constexpr int kTileQ = sm90::tile_bytes(BQ, D);
  static constexpr int kTileK = sm90::tile_bytes(BK, D);
  static constexpr int kTileO = sm90::tile_bytes(64, D);
  static constexpr int kQ = 0;                         // [2] Q buffers
  static constexpr int kK = kQ + 2 * kTileQ;           // [kStages]
  static constexpr int kV = kK + kStages * kTileK;     // [kStages]
  static constexpr int kO = kV + kStages * kTileK;     // [2] o staging
  static constexpr int kBar = kO + 2 * kTileO;
  // q_full[2], q_empty[2], full[kStages], empty[kStages]; + slack to align
  // the base
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;
};

// Work item `item` of a call: heads inner, query tiles outer, the last
// (heaviest under the causal mask) tiles first. Sets the head, the first
// query row and the number of key tiles the item's rows can see.
template <int D>
__device__ __forceinline__ void mono_fwd_item(const MonoFwdParams& p,
                                              int n_qt, int item, int* b,
                                              int* h, int* q0, int* n_tiles) {
  using L = MonoFwdTile<D>;
  const int bh_n = p.B * p.H;
  const int rank = item / bh_n;
  const int bh = item - rank * bh_n;
  *b = bh / p.H;
  *h = bh - *b * p.H;
  *q0 = (p.causal ? n_qt - 1 - rank : rank) * L::BQ;
  const int k_end = p.causal ? min(p.Sk, min(*q0 + L::BQ, p.Sq)) : p.Sk;
  *n_tiles = (k_end + L::BK - 1) / L::BK;
}

template <int D>
__global__ void __launch_bounds__(MonoFwdTile<D>::kThreads, 1)
    flash_fwd_mono_sm90(const __grid_constant__ MonoFwdMaps maps,
                        const MonoFwdParams p) {
  using L = MonoFwdTile<D>;
  constexpr int BQ = L::BQ;
  constexpr int BK = L::BK;
  constexpr int kStages = L::kStages;
  constexpr int kSw = sm90::swizzle_bytes(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int n_items = p.B * p.H * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&q_full[i], 1);   // the producer's arrive + bytes
      sm90::mbar_init(&q_empty[i], 8);  // the consumer warps
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {
    // Producer warpgroup: one thread issues every load, item after item;
    // the Q buffers and the K/V ring wait only on the consumers' releases.
    sm90::regs_dec<sm90::kProducerRegs>();
    if (warp > 8 || lane != 0) return;
    int it = 0;   // K/V tiles loaded so far (the ring's position)
    int n_q = 0;  // Q tiles loaded so far
    for (int pass = 0;; ++pass) {
      const int item = sm90::snake_item(pass, blockIdx.x, gridDim.x);
      if (item >= n_items) break;
      int b, h, q0, n_tiles;
      mono_fwd_item<D>(p, n_qt, item, &b, &h, &q0, &n_tiles);
      if (n_tiles == 0) continue;
      const int qb = n_q & 1;
      if (n_q >= 2) sm90::mbar_wait(&q_empty[qb], ((n_q >> 1) - 1) & 1);
      sm90::mbar_arrive_tx(&q_full[qb], BQ * D * 2);
      sm90::tma_load_tile<D>(smem + L::kQ + qb * L::kTileQ, &maps.q,
                             &q_full[qb], BQ, h, q0, b);
      ++n_q;
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % kStages;
        if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
        sm90::mbar_arrive_tx(&full[s], 2 * BK * D * 2);
        sm90::tma_load_tile<D>(smem + L::kK + s * L::kTileK, &maps.k,
                               &full[s], BK, h, t * BK, b);
        sm90::tma_load_tile<D>(smem + L::kV + s * L::kTileK, &maps.v,
                               &full[s], BK, h, t * BK, b);
      }
    }
    return;
  }

  // Consumer warpgroup g owns rows q0 + 64g .. + 63 of each item; this
  // thread holds rows r_in and r_in + 8 of them (sm90.cuh's layout).
  sm90::regs_inc<sm90::kConsumerRegs>();
  const int g = warp >> 2;
  const int wg_thread = threadIdx.x & 127;
  const int r_in = 16 * (warp & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float scale_log2 = p.scale * 1.4426950408889634f;
  unsigned char* o_s = smem + L::kO + g * L::kTileO;
  int it = 0, n_q = 0;
  for (int pass = 0;; ++pass) {
    const int item = sm90::snake_item(pass, blockIdx.x, gridDim.x);
    if (item >= n_items) break;
    int b, h, q0, n_tiles;
    mono_fwd_item<D>(p, n_qt, item, &b, &h, &q0, &n_tiles);
    const int wg_first = q0 + 64 * g;  // the warpgroup's first row
    float m[2] = {kNegInf, kNegInf};   // row max of the raw scores
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    if (n_tiles > 0) {
      const int qb = n_q & 1;
      const unsigned char* q_s = smem + L::kQ + qb * L::kTileQ + g * 64 * kSw;
      sm90::mbar_wait(&q_full[qb], (n_q >> 1) & 1);
      ++n_q;
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % kStages;
        const int t0 = t * BK;
        sm90::mbar_wait(&full[s], (it / kStages) & 1);
        float sc[BK / 2];
        sm90::qk_product<BQ, BK, D>(sc, q_s, smem + L::kK + s * L::kTileK);
        if (t == n_tiles - 1) {  // the item's Q tile is read no more
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&q_empty[qb]);
        }
        // Only a tile that crosses the warpgroup's diagonal, or the ragged
        // end of the keys, masks per element.
        const bool inside =
            t0 + BK <= p.Sk && (!p.causal || t0 + BK - 1 <= wg_first);
        if (!inside) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = t0 + 8 * j + col0 + e;
                const int row = wg_first + r_in + 8 * hh;
                if (col >= p.Sk || (p.causal && col > row))
                  sc[4 * j + 2 * hh + e] = kNegInf;
              }
            }
          }
        }
        uint32_t pf[BK / 16][4];
        sm90::softmax_step<BK, D>(sc, m, l, o, scale_log2, pf);
        sm90::pv_product<BK, D>(o, pf, smem + L::kV + s * L::kTileK);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: o = acc / l into the warpgroup's staging tile, stored by
    // TMA (rows past S are dropped); lse = m + log(l). A row that saw no
    // key gets o = 0 and lse = NEG_INF.
    float l_safe[2];
    sm90::row_sums(l, l_safe);
    if (wg_thread == 0) sm90::bulk_wait_read<0>();  // the last store read it
    sm90::named_barrier(2 + g, 128);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(
            o_s + sm90::swizzle_offset<D>(64, r_in + 8 * hh, 8 * j + col0)) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] / l_safe[hh],
                                  o[4 * j + 2 * hh + 1] / l_safe[hh]);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_barrier(2 + g, 128);
    if (wg_thread == 0) {
      sm90::tma_store_tile<D>(&maps.o, o_s, 64, h, wg_first, b);
      sm90::bulk_commit();
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wg_first + r_in + 8 * hh;
        if (row < p.Sq)
          p.lse[((long long)b * p.Sq + row) * p.H + h] =
              sm90::row_lse(m[hh], l_safe[hh], p.scale);
      }
    }
  }
  if (wg_thread == 0) sm90::bulk_wait_read<0>();  // before shared memory goes
}

template <int D>
int launch_sm90(const MonoFwdParams& p, cudaStream_t stream) {
  using L = MonoFwdTile<D>;
  MonoFwdMaps maps;
  int rc = sm90::make_tile_map(&maps.q, p.q, p.B, p.Sq, p.H, D, p.q_sb,
                               p.q_ss, p.q_sh, L::BQ);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.k, p.k, p.B, p.Sk, p.H, D, p.k_sb, p.k_ss,
                             p.k_sh, L::BK);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.v, p.v, p.B, p.Sk, p.H, D, p.v_sb, p.v_ss,
                             p.v_sh, L::BK);
  if (rc == 0)
    rc = sm90::make_tile_map(&maps.o, p.o, p.B, p.Sq, p.H, D, p.o_sb, p.o_ss,
                             p.o_sh, 64);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_mono_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_items = p.B * p.H * ((p.Sq + L::BQ - 1) / L::BQ);
  const int sms = sm90::sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int grid = n_items < sms ? n_items : sms;
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

inline int dispatch_sm90(int d, const MonoFwdParams& p, cudaStream_t stream) {
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
extern "C" int dtpu_flash_fwd_mono(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    void* o, float* lse, int B, int H, int Sq, int Sk, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale,
    void* stream) {
  dtpu::MonoFwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) return 0;
  return dtype == 1 ? dtpu::dispatch_sm90(head_dim, p, s)
                    : dtpu::dispatch_fp32(head_dim, p, s);
}
