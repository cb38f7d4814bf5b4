// Fused flash-attention backward for the monolithic path, for Hopper
// (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_bwd_kernel_mono
// (launched by _mono_bwd_call from _flash_bwd_pallas when _mono_ok holds).
// From q, k, v, do, lse, delta = Σ do·o (computed outside) and the lse
// cotangent dlse it recomputes s = q kᵀ · scale and p = exp(s − lse) ONCE
// per (query tile, key tile) pair and feeds all three gradients from it:
//   dv = pᵀ·do            (p rounded to the input dtype first)
//   dp = do·vᵀ
//   ds = p ∘ (dp − delta + dlse) · scale   (rounded to the input dtype)
//   dq = ds·k,  dk = dsᵀ·q
// with an optional causal mask (p = 0 above the diagonal).
//
// What bounds it on the H100: five products of 2·D FLOPs per live (query,
// key) pair — 10·D in all, 2.5x the forward. At the GPT-2 training shape
// (B=8, S=1024, H=12, D=64, causal) that is 3.2e10 FLOPs over ~75 MB of
// q/k/v/do/lse/delta/dq/dk/dv: above the bf16 ridge, so the roofline bound
// is the operations (~33 us).
//
// What the design does about it (bf16, flash_bwd_mono_sm90). dk and dv sum
// over query tiles while dq sums over key tiles, and CTAs run in no order.
// Each work item is (batch·head, 128 keys): a CTA keeps the item's K and V
// tiles and its fp32 dk, dv in registers and walks the query tiles of 64
// rows that see its keys (causal: from its diagonal tile on), adding its
// share of dq into an fp32 [B, S, H, D] workspace. At S <= 1448 an item
// walks at most 23 query tiles, so the kernel is persistent:
// - a grid of one CTA a SM walks the items, key tile 0 (the longest causal
//   walk) first, dealt out in snake order (sm90.cuh `snake_item`);
// - each CTA runs flash_bwd_blocked.cu's warp-specialised design: two
//   consumer warpgroups of 64 keys and a producer warp that loads K and V
//   by TMA into one of two buffers (one at D = 128, for shared memory)
//   and streams q/do tiles with their lse/delta/dlse rows through a
//   3-stage ring; buffers and ring run across item boundaries, so the next
//   item's loads overlap this item's last tiles and its dk/dv stores;
// - all five products are wgmma with fp32 accumulators in registers
//   (bwd_sm90.cuh, shared with flash_bwd_blocked.cu): Sᵀ = K·Qᵀ and
//   dPᵀ = V·doᵀ put the keys on M, so Pᵀ and dSᵀ feed dv and dk from
//   registers; dSᵀ goes through shared memory to dq_tile = dS·K, which one
//   warpgroup (alternating by tile) adds into the workspace with vector
//   reductions; only a tile that crosses the causal diagonal, or a ragged
//   edge, masks per element;
// - the wrapper zeroes the workspace before and casts it after (the
//   kernels phase of chip_smoke.py times both). Folding the cast in — a
//   counter per (batch·head, query tile) whose last contributor writes the
//   tile in bf16 — was built and ran slower on the H100: the release
//   before each count waits for the warpgroup's reductions to drain. The
//   order of the fp32 additions changes from run to run: dq is not bitwise
//   deterministic.
// The fp32 path keeps the FMA kernel below (flash_bwd_mono_kernel,
// mono_tiles.cuh; one block per (batch·head, key tile), dq by fp32 atomics
// into the output itself): a tensor-core fp32 product would round to TF32.
#include "bwd_sm90.cuh"
#include "mono_tiles.cuh"

namespace dtpu {

struct MonoBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Sq, H]
  const float* delta;  // [B, Sq, H]
  const float* dlse;   // [B, Sq, H] or null (zeros)
  float* dq;           // [B, Sq, H, D] fp32 workspace, zeroed
  void* dk;            // [B, Sk, H, D]
  void* dv;            // [B, Sk, H, D]
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int causal;
  float scale;
};

template <typename T, int D, int BQ, int BK>
struct BwdLayout {
  static constexpr int kLdD = ld_of<T>(D);       // q, k, v, do tiles
  static constexpr int kLdP = ld_of<T>(BK);      // p, ds tiles
  static constexpr int kLdS = ld_of<float>(BK);  // fp32 s, dp
  static constexpr int kLdF = ld_of<float>(D);   // fp32 dq, dk, dv
  static constexpr int kK = 0;
  static constexpr int kV = kK + tile_bytes<T>(BK, D);
  static constexpr int kQ = kV + tile_bytes<T>(BK, D);
  static constexpr int kDo = kQ + tile_bytes<T>(BQ, D);
  // s and dp; once ds is formed the same bytes hold the dq tile.
  static constexpr int kS = kDo + tile_bytes<T>(BQ, D);
  static constexpr int kDp = kS + tile_bytes<float>(BQ, BK);
  static constexpr int kSBytes =
      2 * tile_bytes<float>(BQ, BK) > tile_bytes<float>(BQ, D)
          ? 2 * tile_bytes<float>(BQ, BK)
          : tile_bytes<float>(BQ, D);
  static constexpr int kP = kS + kSBytes;
  static constexpr int kDs = kP + tile_bytes<T>(BQ, BK);
  static constexpr int kDk = kDs + tile_bytes<T>(BQ, BK);
  static constexpr int kDv = kDk + tile_bytes<float>(BK, D);
  static constexpr int kRows = kDv + tile_bytes<float>(BK, D);
  static constexpr int kBytes = kRows + 3 * BQ * 4;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kMonoThreads)
    flash_bwd_mono_kernel(const MonoBwdParams p) {
  using L = BwdLayout<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem + L::kK);
  T* v_s = reinterpret_cast<T*>(smem + L::kV);
  T* q_s = reinterpret_cast<T*>(smem + L::kQ);
  T* do_s = reinterpret_cast<T*>(smem + L::kDo);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem + L::kDp);
  float* dq_s = s_s;  // reuses the s/dp bytes after ds is formed
  T* p_s = reinterpret_cast<T*>(smem + L::kP);
  T* ds_s = reinterpret_cast<T*>(smem + L::kDs);
  float* dk_s = reinterpret_cast<float*>(smem + L::kDk);
  float* dv_s = reinterpret_cast<float*>(smem + L::kDv);
  float* lse_s = reinterpret_cast<float*>(smem + L::kRows);
  float* delta_s = lse_s + BQ;
  float* dlse_s = delta_s + BQ;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BK;  // key tile 0 (the heaviest) first
  const int nk = min(BK, p.Sk - k0);

  stage_rows<T, D>(k_s, L::kLdD,
                   static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                       (long long)k0 * p.k_ss,
                   p.k_ss, BK, nk);
  stage_rows<T, D>(v_s, L::kLdD,
                   static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
                       (long long)k0 * p.v_ss,
                   p.v_ss, BK, nk);
  for (int idx = threadIdx.x; idx < BK * D; idx += kMonoThreads) {
    const int r = idx / D;
    dk_s[r * L::kLdF + idx - r * D] = 0.f;
    dv_s[r * L::kLdF + idx - r * D] = 0.f;
  }

  // Query rows that can see a key of this tile: causal, from row k0 on.
  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < p.Sq; q0 += BQ) {
    const int nq = min(BQ, p.Sq - q0);
    __syncthreads();  // the previous tile's dq atomics read dq_s no more
    stage_rows<T, D>(q_s, L::kLdD,
                     static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                         (long long)q0 * p.q_ss,
                     p.q_ss, BQ, nq);
    stage_rows<T, D>(do_s, L::kLdD,
                     static_cast<const T*>(p.dout) + b * p.do_sb +
                         h * p.do_sh + (long long)q0 * p.do_ss,
                     p.do_ss, BQ, nq);
    for (int r = threadIdx.x; r < BQ; r += kMonoThreads) {
      const long long at = ((long long)b * p.Sq + q0 + r) * p.H + h;
      const bool ok = r < nq;
      lse_s[r] = ok ? p.lse[at] : 0.f;
      delta_s[r] = ok ? p.delta[at] : 0.f;
      dlse_s[r] = ok && p.dlse != nullptr ? p.dlse[at] : 0.f;
    }
    __syncthreads();
    block_gemm<BQ, BK, D, false, true, false>(s_s, L::kLdS, q_s, L::kLdD, k_s,
                                              L::kLdD);
    block_gemm<BQ, BK, D, false, true, false>(dp_s, L::kLdS, do_s, L::kLdD,
                                              v_s, L::kLdD);
    __syncthreads();
    const bool diag = p.causal && k0 + BK - 1 > q0;
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kMonoThreads) {
      const int r = idx / BK;
      const int c = idx - r * BK;
      const bool live = r < nq && c < nk && (!diag || k0 + c <= q0 + r);
      const float pv =
          live ? expf(s_s[r * L::kLdS + c] * p.scale - lse_s[r]) : 0.f;
      const float ds =
          pv * (dp_s[r * L::kLdS + c] - delta_s[r] + dlse_s[r]) * p.scale;
      p_s[r * L::kLdP + c] = from_float<T>(pv);
      ds_s[r * L::kLdP + c] = from_float<T>(ds);
    }
    __syncthreads();
    block_gemm<BK, D, BQ, true, false, true>(dv_s, L::kLdF, p_s, L::kLdP,
                                             do_s, L::kLdD);
    block_gemm<BK, D, BQ, true, false, true>(dk_s, L::kLdF, ds_s, L::kLdP,
                                             q_s, L::kLdD);
    block_gemm<BQ, D, BK, false, false, false>(dq_s, L::kLdF, ds_s, L::kLdP,
                                               k_s, L::kLdD);
    __syncthreads();
    float* dq = p.dq + (((long long)b * p.Sq + q0) * p.H + h) * D;
    for (int idx = threadIdx.x; idx < nq * D; idx += kMonoThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      atomicAdd(dq + (long long)r * p.H * D + d, dq_s[r * L::kLdF + d]);
    }
  }
  __syncthreads();

  const long long out0 = (((long long)b * p.Sk + k0) * p.H + h) * D;
  T* dk = static_cast<T*>(p.dk) + out0;
  T* dv = static_cast<T*>(p.dv) + out0;
  for (int idx = threadIdx.x; idx < nk * D; idx += kMonoThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dk[(long long)r * p.H * D + d] = from_float<T>(dk_s[r * L::kLdF + d]);
    dv[(long long)r * p.H * D + d] = from_float<T>(dv_s[r * L::kLdF + d]);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const MonoBwdParams& p, cudaStream_t stream) {
  using L = BwdLayout<T, D, BQ, BK>;
  auto kernel = flash_bwd_mono_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sk + BK - 1) / BK, p.B * p.H);
  kernel<<<grid, kMonoThreads, L::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// fp32: 32-row tiles of the FMA kernel.
inline int dispatch_fp32(int d, const MonoBwdParams& p, cudaStream_t stream) {
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
struct MonoBwdMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
struct MonoBwdTile {
  static constexpr int BK = 128;  // two consumer warpgroups of 64 keys
  static constexpr int BQ = sm90::kBwdBQ;
  static constexpr int kStages = 3;
  static constexpr int kKvBufs = D <= 64 ? 2 : 1;
  static constexpr int kThreads = sm90::kSpecThreads;
  static constexpr int kTileK = sm90::tile_bytes(BK, D);
  static constexpr int kTileQ = sm90::tile_bytes(BQ, D);
  static constexpr int kK = 0;                            // [kKvBufs]
  static constexpr int kV = kK + kKvBufs * kTileK;        // [kKvBufs]
  static constexpr int kQ = kV + kKvBufs * kTileK;        // [kStages]
  static constexpr int kDo = kQ + kStages * kTileQ;       // [kStages]
  static constexpr int kDs = kDo + kStages * kTileQ;      // [2][BK][BQ] bf16
  static constexpr int kRows = kDs + 2 * BK * BQ * 2;     // [kStages][3][BQ]
  static constexpr int kBar = kRows + kStages * 3 * BQ * 4;
  // kv_full[kKvBufs], kv_empty[kKvBufs], full[kStages], empty[kStages];
  // + slack to align the base
  static constexpr int kBytes = kBar + 8 * (2 * kKvBufs + 2 * kStages) + 1024;
};

// Work item `item` of a call: heads inner, key tiles outer, key tile 0 (the
// longest causal walk) first. Sets the head, the first key and the range
// of query tiles [t_first, t_first + n_tiles) that see the item's keys.
template <int D>
__device__ __forceinline__ void mono_bwd_item(const MonoBwdParams& p,
                                              int item, int* b, int* h,
                                              int* k0, int* t_first,
                                              int* n_tiles) {
  using L = MonoBwdTile<D>;
  const int bh_n = p.B * p.H;
  const int rank = item / bh_n;
  const int bh = item - rank * bh_n;
  *b = bh / p.H;
  *h = bh - *b * p.H;
  *k0 = rank * L::BK;
  const int lo = p.causal ? *k0 : 0;  // the first row that sees a key
  *t_first = lo / L::BQ;
  *n_tiles = lo < p.Sq ? (p.Sq - 1) / L::BQ - *t_first + 1 : 0;
}

template <int D>
__global__ void __launch_bounds__(MonoBwdTile<D>::kThreads, 1)
    flash_bwd_mono_sm90(const __grid_constant__ MonoBwdMaps maps,
                        const MonoBwdParams p) {
  using L = MonoBwdTile<D>;
  constexpr int BK = L::BK;
  constexpr int BQ = L::BQ;
  constexpr int kStages = L::kStages;
  constexpr int kKvBufs = L::kKvBufs;
  constexpr int kSw = sm90::swizzle_bytes(D);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_empty = kv_full + kKvBufs;
  uint64_t* full = kv_empty + kKvBufs;
  uint64_t* empty = full + kStages;
  const int n_kt = (p.Sk + BK - 1) / BK;
  const int n_items = p.B * p.H * n_kt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kKvBufs; ++i) {
      sm90::mbar_init(&kv_full[i], 1);   // the producer's arrive + bytes
      sm90::mbar_init(&kv_empty[i], 8);  // the consumer warps
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer warp's lanes
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {
    // Producer warpgroup; its first warp loads, item after item, K and V
    // (lane 0, by TMA), then the query tiles that see them: q and do by
    // TMA, lse / delta / dlse staged by the lanes.
    sm90::regs_dec<sm90::kProducerRegs>();
    if (warp > 8) return;
    int it = 0;    // query tiles loaded so far (the ring's position)
    int n_kv = 0;  // K/V tiles loaded so far
    for (int pass = 0;; ++pass) {
      const int item = sm90::snake_item(pass, blockIdx.x, gridDim.x);
      if (item >= n_items) break;
      int b, h, k0, t_first, n_tiles;
      mono_bwd_item<D>(p, item, &b, &h, &k0, &t_first, &n_tiles);
      if (n_tiles == 0) continue;
      const int kb = n_kv % kKvBufs;
      if (n_kv >= kKvBufs)
        sm90::mbar_wait(&kv_empty[kb], (n_kv / kKvBufs - 1) & 1);
      ++n_kv;
      if (lane == 0) {
        sm90::mbar_arrive_tx(&kv_full[kb], 2 * BK * D * 2);
        sm90::tma_load_tile<D>(smem + L::kK + kb * L::kTileK, &maps.k,
                               &kv_full[kb], BK, h, k0, b);
        sm90::tma_load_tile<D>(smem + L::kV + kb * L::kTileK, &maps.v,
                               &kv_full[kb], BK, h, k0, b);
      }
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % kStages;
        const int q0 = (t_first + t) * BQ;
        if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
        float* rows = reinterpret_cast<float*>(smem + L::kRows) + s * 3 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int row = q0 + r;
          const bool ok = row < p.Sq;
          const long long at = ((long long)b * p.Sq + row) * p.H + h;
          rows[r] = ok ? p.lse[at] : 0.f;
          rows[BQ + r] = ok ? p.delta[at] : 0.f;
          rows[2 * BQ + r] = ok && p.dlse != nullptr ? p.dlse[at] : 0.f;
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
    }
    return;
  }

  // Consumer warpgroup g owns keys k0 + 64g .. + 63 of each item; this
  // thread holds keys r_in and r_in + 8 of them (rows of the Sᵀ
  // accumulator) and, in the dq product, query rows r_in and r_in + 8 of
  // the tile.
  sm90::regs_inc<sm90::kConsumerRegs>();
  const int g = warp >> 2;
  const int r_in = 16 * (warp & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const long long row_stride = (long long)p.H * D;  // of the dq workspace
  int it = 0, n_kv = 0;
  for (int pass = 0;; ++pass) {
    const int item = sm90::snake_item(pass, blockIdx.x, gridDim.x);
    if (item >= n_items) break;
    int b, h, k0, t_first, n_tiles;
    mono_bwd_item<D>(p, item, &b, &h, &k0, &t_first, &n_tiles);
    const int kg0 = k0 + 64 * g;
    int key[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) key[hh] = kg0 + r_in + 8 * hh;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const long long head = ((long long)b * p.Sq * p.H + h) * D;  // dq row 0

    if (n_tiles > 0) {
      const int kb = n_kv % kKvBufs;
      const unsigned char* k_tile = smem + L::kK + kb * L::kTileK;
      const unsigned char* v_tile = smem + L::kV + kb * L::kTileK;
      sm90::mbar_wait(&kv_full[kb], (n_kv / kKvBufs) & 1);
      ++n_kv;
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % kStages;
        const int q0 = (t_first + t) * BQ;
        const unsigned char* q_s = smem + L::kQ + s * L::kTileQ;
        const unsigned char* do_s = smem + L::kDo + s * L::kTileQ;
        unsigned char* ds_s = smem + L::kDs + (it & 1) * BK * BQ * 2;
        const float* rows =
            reinterpret_cast<const float*>(smem + L::kRows) + s * 3 * BQ;
        sm90::mbar_wait(&full[s], (it / kStages) & 1);

        float st[BQ / 2], dpt[BQ / 2];
        sm90::st_dpt_products<BK, D>(st, dpt, k_tile + g * 64 * kSw,
                                     v_tile + g * 64 * kSw, q_s, do_s);
        // Only a tile that crosses the causal diagonal, or a ragged edge,
        // masks per element.
        const bool inside = (!p.causal || q0 >= kg0 + 63) &&
                            q0 + BQ <= p.Sq && kg0 + 64 <= p.Sk;
        sm90::p_ds(st, dpt, rows, scale_log2, p.scale, !inside, col0,
                   [&](int r, int hh) {
                     const int row = q0 + r;
                     return row < p.Sq && key[hh] < p.Sk &&
                            (!p.causal || row >= key[hh]);
                   });
        uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
        sm90::pack_p_ds(st, dpt, pf, dsf, ds_s, 64 * g + r_in, col0);
        sm90::dkdv_products<D>(dv, dk, pf, dsf, do_s, q_s);
        sm90::named_barrier(1, 256);  // both warpgroups' dSᵀ are in place
        sm90::wgmma_wait<0>();
        sm90::reg_fence(dv);
        sm90::reg_fence(dk);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
        // One warpgroup, alternating by tile, adds dq_tile = dS·K into the
        // fp32 workspace.
        if ((it & 1) == g)
          sm90::dq_reduce<BK, D>(ds_s, k_tile, p.dq + head, row_stride, q0,
                                 p.Sq, r_in, col0);
      }
      __syncwarp();  // the item's K and V tiles are read no more
      if (lane == 0) sm90::mbar_arrive(&kv_empty[kb]);
    }

    // Epilogue: dk, dv of this warpgroup's keys in bf16 (zeros for keys no
    // row sees).
    long long at[2];
    bool key_ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      at[hh] = (((long long)b * p.Sk + key[hh]) * p.H + h) * D;
      key_ok[hh] = key[hh] < p.Sk;
    }
    sm90::store_dkdv<D>(dk, dv, p.dk, p.dv, at, key_ok, col0);
  }
}

template <int D>
int launch_sm90(const MonoBwdParams& p, cudaStream_t stream) {
  using L = MonoBwdTile<D>;
  MonoBwdMaps maps;
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
  auto kernel = flash_bwd_mono_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_items = p.B * p.H * ((p.Sk + L::BK - 1) / L::BK);
  const int sms = sm90::sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int grid = n_items < sms ? n_items : sms;
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

inline int dispatch_sm90(int d, const MonoBwdParams& p, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_sm90<16>(p, stream);
    case 32: return launch_sm90<32>(p, stream);
    case 64: return launch_sm90<64>(p, stream);
    case 128: return launch_sm90<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtpu

// dtype: 0 = float32, 1 = bfloat16. q/k/v/do strides are in elements with
// the head dim contiguous; lse/delta/dlse are contiguous [B, Sq, H] fp32,
// dq a zeroed contiguous fp32 [B, Sq, H, D] workspace (the wrapper casts
// it), dk/dv contiguous [B, Sk, H, D] in the input dtype. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dtpu_flash_bwd_mono(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const float* dlse,
    float* dq, void* dk, void* dv, int B, int H, int Sq, int Sk,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    int causal, float scale, void* stream) {
  dtpu::MonoBwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = lse; p.delta = delta; p.dlse = dlse;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0 || B * H <= 0) return 0;
  return dtype == 1 ? dtpu::dispatch_sm90(head_dim, p, s)
                    : dtpu::dispatch_fp32(head_dim, p, s);
}
