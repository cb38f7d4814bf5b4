// Paged decode attention for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/paged_attention.py::_paged_kernel (launched
// by paged_attention, with _page_index as its K/V index map): decode
// attention that reads K/V straight out of the page pool through each
// slot's page table. Row r of slot b sits at position lengths[b] + r and
// sees pool positions <= lengths[b] + min(r, q_lens[b] - 1); rows past
// q_lens are padding clamped onto the last real row's mask. Inactive
// slots read nothing and write zeros.
//
// What bounds it on the H100: a decode step does ~4·Dh FLOPs per cached
// key per query row against 2·Dh·itemsize bytes of K/V per cached key, so
// at q_rows = 1 it is bound by the bytes of the live K/V pages (about one
// FLOP per byte, far below the 295 FLOP/byte ridge). The only lever is to
// keep more bytes in flight on more SMs.
//
// What the design does about it:
// - The page walk is split. Each (slot, head) gets a thread block cluster
//   of C = min(4, P) CTAs (P = page-table width); rank c walks the live
//   pages c, c + C, ... and keeps its own (m, l, acc) in fp32. Four ranks
//   beat eight on the H100 both at the engine's decode batch and where
//   bytes set the time (fewer, longer CTAs; PERF.md). The TPU's
//   scalar prefetch becomes each CTA loading its own page_table row,
//   lengths, q_lens and active; the bound on live pages, (lengths + q_lens
//   − 1) // page_size, is read on the device, so a dead page-table entry
//   is never dereferenced and the host never syncs.
// - The partials are merged inside the cluster through distributed shared
//   memory: after a cluster barrier, rank c reads every rank's partial of
//   the query rows r ≡ c (mod C) and merges them in rank order, so the
//   result is deterministic; no workspace, no atomics, one launch. A rank
//   with no live page holds m = −1e30, l = 0 and adds nothing.
// - bf16: pages stream by TMA. One map covers the pool [num_pages,
//   page_size, H, D] as a [B, S, H, D] tensor (sm90.cuh make_tile_map), so
//   a 64-key box of one head of one page is one load; TMA zero-fills keys
//   past page_size, so a ragged page needs no other path. A producer warp
//   keeps a ring of ~32 KB of K/V stages in flight under full/empty
//   mbarriers while four consumer warps compute; tiles stay bf16 in the
//   swizzled layout TMA writes. The slot's scalars and the first page-table
//   entry are loaded together, so the first TMA waits on one load, not
//   three in a row.
// - bf16 products: every warp works at q_rows = 1. The keys of a tile are
//   split over the four warps (16 each), not the rows: each warp runs
//   S = Q·Kᵀ and O += P·V with mma.sync m16n8k16, whose M = 16 is exactly
//   the 16 (zero-padded) query rows a launch takes. wgmma would need 64
//   rows and a warpgroup per key slice; at ~1 FLOP per byte the padding is
//   free either way, and mma.sync lets each warp own its keys. Q lives in
//   registers as A fragments, K and V come by ldmatrix from the swizzled
//   tiles, the S accumulator becomes P's A fragment in registers (p
//   rounded to bf16 before P·V, as the TPU kernel rounds it), and the four
//   warps' online-softmax states are merged in warp order in shared
//   memory before the cluster merge.
// - fp32 keeps the block-wide tiles of attn_common.cuh (attend_tile; a
//   tensor-core fp32 product would round to TF32) under the same split and
//   merge.
// p is zeroed where masked, never left to exp underflow.
#include <cooperative_groups.h>

#include <utility>

#include "sm90.cuh"

namespace dtpu {

namespace cg = cooperative_groups;

constexpr int kPagedRows = 16;  // query rows a launch takes
constexpr int kMaxRanks = 4;    // CTAs of a cluster at most
constexpr int kPagedBK = 64;    // keys of a bf16 tile (one TMA box)

struct PagedParams {
  const void* q;        // [B, q_rows, H, D] through strides
  const void* k_pool;   // [num_pages, page_size, H, D] contiguous
  const void* v_pool;
  const int* page_table;  // [B, P]
  const int* lengths;     // [B]
  const int* q_lens;      // [B]
  const int* active;      // [B]
  void* o;                // [B, q_rows, H, D] contiguous
  int q_rows, H, page_size, P, num_pages;
  long long q_sb, q_sr, q_sh;
  float scale;
};

// One CTA's online-softmax state of the launch's query rows: m in log2
// units (scores · scale · log2 e), l and acc unnormalised.
template <int D>
struct PagedPartial {
  float m[kPagedRows];
  float l[kPagedRows];
  float acc[kPagedRows * D];
};

// The slot's live window: its last visible position and live pages.
struct SlotWindow {
  int length, q_live, last_pos, n_pages;
  __device__ SlotWindow(const PagedParams& p, int length_, int q_live_)
      : length(length_), q_live(q_live_) {
    last_pos = length + q_live - 1;
    n_pages = min(last_pos / p.page_size + 1, p.P);
  }
};

// Inactive slot: the cluster writes zeros (rank c the rows r ≡ c mod C)
// and reads nothing.
template <typename T, int D>
__device__ __forceinline__ void zero_rows(const PagedParams& p, T* o_slot,
                                          int rank, int n_ranks) {
  const long long row_stride = (long long)p.H * D;
  for (int r = rank; r < p.q_rows; r += n_ranks)
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      o_slot[r * row_stride + d] = from_float<T>(0.f);
}

// Merge the cluster's partials: rank c writes o for the rows r ≡ c (mod
// C), summing the ranks in rank order. Every thread of every CTA of the
// cluster calls it; it starts with the barrier that publishes `part` and
// ends with the one that keeps it alive until every rank has read it.
template <typename T, int D>
__device__ __forceinline__ void merge_ranks(const PagedParams& p,
                                            PagedPartial<D>* part, T* o_slot,
                                            int rank, int n_ranks) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const long long row_stride = (long long)p.H * D;
  for (int r = rank; r < p.q_rows; r += n_ranks) {
    float m = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxRanks; ++c)
      if (c < n_ranks) m = fmaxf(m, cluster.map_shared_rank(part, c)->m[r]);
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float l = 0.f, acc = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxRanks; ++c) {
        if (c >= n_ranks) break;
        const PagedPartial<D>* pc = cluster.map_shared_rank(part, c);
        const float w = exp2f(pc->m[r] - m);
        l = fmaf(pc->l[r], w, l);
        acc = fmaf(pc->acc[r * D + d], w, acc);
      }
      o_slot[r * row_stride + d] = from_float<T>(l == 0.f ? 0.f : acc / l);
    }
  }
  cluster.sync();
}

// -- bf16: TMA ring + mma.sync ----------------------------------------------
struct PagedMaps {
  CUtensorMap k, v;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  if (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(sm90::smem_u32(p))
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(sm90::smem_u32(p))
        : "memory");
  }
}

// d += a·b, m16n8k16, bf16 inputs, fp32 accumulators. Fragments (lane l,
// g = l / 4, t = l % 4): a[0..3] = A(g, 2t..), A(g+8, 2t..), A(g, 2t+8..),
// A(g+8, 2t+8..); b0 = B(2t.., g), b1 = B(2t+8.., g); d = D(g, 2t..),
// D(g+8, 2t..).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct PagedTile {
  static constexpr int BK = kPagedBK;   // 16 keys a consumer warp
  static constexpr int kConsumers = 4;  // consumer warps; one producer warp
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kTile = sm90::tile_bytes(BK, D);
  // About 32 KB of K/V in flight a CTA (a page of 128 keys at D 64), 2
  // to 4 stages: small enough for four CTAs an SM.
  static constexpr int kStages =
      16384 / kTile < 2 ? 2 : 16384 / kTile > 4 ? 4 : 16384 / kTile;
  static constexpr int kK = 0;                       // [kStages]
  static constexpr int kV = kK + kStages * kTile;    // [kStages]
  // After the walk the ring holds the consumer warps' partials.
  static constexpr int kPart = kV + kStages * kTile;  // the CTA's partial
  static constexpr int kBar =
      kPart + (int)(sizeof(PagedPartial<D>) + 7) / 8 * 8;
  // full[kStages], empty[kStages]; + slack to align the base
  static constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;
  static_assert(kConsumers * sizeof(PagedPartial<D>) <= kPart,
                "the warps' partials fit over the ring");
};

template <int D>
__global__ void __launch_bounds__(PagedTile<D>::kThreads, D > 64 ? 2 : 4)
    paged_kernel_sm90(const __grid_constant__ PagedMaps maps,
                      const PagedParams p) {
  using L = PagedTile<D>;
  using T = __nv_bfloat16;
  constexpr int BK = L::BK;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  auto* part = reinterpret_cast<PagedPartial<D>*>(smem + L::kPart);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;

  const int rank = blockIdx.x;
  const int n_ranks = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // The slot's scalars and this rank's first table entry, all loaded at
  // once (the entry is used only if its page is live): under a saturated
  // memory system each dependent load before the first TMA costs
  // microseconds.
  const int active = p.active[b];
  const int length = p.lengths[b];
  const int q_live = p.q_lens[b];
  const bool producer = warp == L::kConsumers && lane == 0;
  const int page0 = producer ? p.page_table[(long long)b * p.P + rank] : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], L::kConsumers);
    }
    sm90::fence_barrier_init();
  }
  T* o_slot = static_cast<T*>(p.o) + ((long long)b * p.q_rows * p.H + h) * D;
  if (active == 0) {  // uniform over the cluster
    zero_rows<T, D>(p, o_slot, rank, n_ranks);
    return;
  }
  const SlotWindow win(p, length, q_live);
  __syncthreads();

  const int g = lane >> 2;
  const int t = lane & 3;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (warp == L::kConsumers) {
    // Producer: lane 0 streams this rank's tiles (pages rank, rank + C,
    // ...; 64-key tiles up to the last visible position) into the ring.
    if (producer) {
      int it = 0;
      for (int pg = rank; pg < win.n_pages; pg += n_ranks) {
        const int page =
            pg == rank ? page0 : p.page_table[(long long)b * p.P + pg];
        for (int off = 0; off < p.page_size &&
                          pg * p.page_size + off <= win.last_pos;
             off += BK, ++it) {
          const int s = it % kStages;
          if (it >= kStages)
            sm90::mbar_wait(&empty[s], (it / kStages - 1) & 1);
          sm90::mbar_arrive_tx(&full[s], 2 * BK * D * 2);
          sm90::tma_load_tile<D>(smem + L::kK + s * L::kTile, &maps.k,
                                 &full[s], BK, h, off, page);
          sm90::tma_load_tile<D>(smem + L::kV + s * L::kTile, &maps.v,
                                 &full[s], BK, h, off, page);
        }
      }
    }
  } else {
    // Consumer warp `warp` owns keys 16·warp .. + 15 of every tile. Q as
    // the A fragments of the 16 rows (rows past q_rows are zeros).
    uint32_t qa[D / 16][4];
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + 8 * (i & 1);
        const int col = 16 * kk + 2 * t + 8 * (i >> 1);
        uint32_t lo = 0, hi = 0;
        if (row < p.q_rows) {
          lo = __bfloat16_as_ushort(qb[row * p.q_sr + col]);
          hi = __bfloat16_as_ushort(qb[row * p.q_sr + col + 1]);
        }
        qa[kk][i] = lo | (hi << 16);
      }
    }
    const int bound[2] = {win.length + min(g, win.q_live - 1),
                          win.length + min(g + 8, win.q_live - 1)};
    const float scale_log2 = p.scale * 1.4426950408889634f;
    const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
    int it = 0;
    for (int pg = rank; pg < win.n_pages; pg += n_ranks) {
      for (int off = 0;
           off < p.page_size && pg * p.page_size + off <= win.last_pos;
           off += BK, ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&full[s], (it / kStages) & 1);
        const int key0 = off + 16 * warp;        // in the page
        const int pos0 = pg * p.page_size + key0;  // in the sequence
        if (key0 < p.page_size && pos0 <= win.last_pos) {
          const unsigned char* k_t = smem + L::kK + s * L::kTile;
          const unsigned char* v_t = smem + L::kV + s * L::kTile;
          // S = Q·Kᵀ over the warp's keys: n-tiles of keys 0-7 and 8-15.
          float sc[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t kb[4];
            ldmatrix_x4(kb,
                        k_t + sm90::swizzle_offset<D>(
                                  BK, 16 * warp + (mi >> 1) * 8 + (lane & 7),
                                  16 * kk + (mi & 1) * 8),
                        false);
            mma_16816(sc[0], qa[kk], kb[0], kb[1]);
            mma_16816(sc[1], qa[kk], kb[2], kb[3]);
          }
          // Interior: every key inside the page and visible to row 0, the
          // row with the tightest bound.
          const bool interior =
              key0 + 16 <= p.page_size && pos0 + 15 <= win.length;
          bool live[2][4];
          float mx[2] = {kNegInf, kNegInf};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kin = 8 * j + 2 * t + (e & 1);
              live[j][e] = interior || (key0 + kin < p.page_size &&
                                        pos0 + kin <= bound[e >> 1]);
              sc[j][e] = live[j][e] ? sc[j][e] * scale_log2 : kNegInf;
              mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
            }
          }
          float corr[2];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
            mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
            const float m_new = fmaxf(m[hr], mx[hr]);
            corr[hr] = sm90::ex2(m[hr] - m_new);
            m[hr] = m_new;
            l[hr] *= corr[hr];
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pv =
                  live[j][e] ? sm90::ex2(sc[j][e] - m[e >> 1]) : 0.f;
              sc[j][e] = pv;
              l[e >> 1] += pv;
            }
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[j][0] *= corr[0];
            acc[j][1] *= corr[0];
            acc[j][2] *= corr[1];
            acc[j][3] *= corr[1];
          }
          // P (bf16) as the A fragment of the warp's 16 keys; O += P·V with
          // V through ldmatrix.trans, two 8-column n-tiles at a time.
          const uint32_t pa[4] = {sm90::pack_bf16(sc[0][0], sc[0][1]),
                                  sm90::pack_bf16(sc[0][2], sc[0][3]),
                                  sm90::pack_bf16(sc[1][0], sc[1][1]),
                                  sm90::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
          for (int jj = 0; jj < D / 16; ++jj) {
            uint32_t vb[4];
            ldmatrix_x4(vb,
                        v_t + sm90::swizzle_offset<D>(
                                  BK, 16 * warp + (mi & 1) * 8 + (lane & 7),
                                  16 * jj + (mi >> 1) * 8),
                        true);
            mma_16816(acc[2 * jj], pa, vb[0], vb[1]);
            mma_16816(acc[2 * jj + 1], pa, vb[2], vb[3]);
          }
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
  }
  __syncthreads();  // every tile consumed: the ring is free

  // The consumer warps' partials over the ring, then the CTA's partial:
  // the warps merged in warp order, for the rows a launch writes.
  auto* wpart = reinterpret_cast<PagedPartial<D>*>(smem);
  if (warp < L::kConsumers) {
    PagedPartial<D>* mine = wpart + warp;
    if (t == 0) {
      mine->m[g] = m[0];
      mine->m[g + 8] = m[1];
      mine->l[g] = l[0];
      mine->l[g + 8] = l[1];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      mine->acc[g * D + col] = acc[j][0];
      mine->acc[g * D + col + 1] = acc[j][1];
      mine->acc[(g + 8) * D + col] = acc[j][2];
      mine->acc[(g + 8) * D + col + 1] = acc[j][3];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < p.q_rows * D; idx += L::kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < L::kConsumers; ++w) mm = fmaxf(mm, wpart[w].m[r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < L::kConsumers; ++w) {
      const float wt = exp2f(wpart[w].m[r] - mm);
      ll = fmaf(wpart[w].l[r], wt, ll);
      aa = fmaf(wpart[w].acc[r * D + d], wt, aa);
    }
    part->acc[r * D + d] = aa;
    if (d == 0) {
      part->m[r] = mm;
      part->l[r] = ll;
    }
  }
  merge_ranks<T, D>(p, part, o_slot, rank, n_ranks);
}

// -- fp32: attend_tile under the same split and merge -----------------------
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
    paged_kernel_fp32(const PagedParams p) {
  using T = float;
  constexpr int kRowsPerWarp = kPagedRows / kWarps;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kPagedRows][D]
  float* k_s = q_s + kPagedRows * D;  // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D]
  auto* part = reinterpret_cast<PagedPartial<D>*>(v_s + BK * D);

  const int rank = blockIdx.x;
  const int n_ranks = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)p.H * D;  // pool rows
  T* o_slot = static_cast<T*>(p.o) + ((long long)b * p.q_rows * p.H + h) * D;
  if (p.active[b] == 0) {  // uniform over the cluster
    zero_rows<T, D>(p, o_slot, rank, n_ranks);
    return;
  }
  const SlotWindow win(p, p.lengths[b], p.q_lens[b]);
  const int warp = threadIdx.x >> 5;
  load_rows<T, D>(q_s, D,
                  static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_sr, kPagedRows, p.q_rows);
  RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  const T* k_pool = static_cast<const T*>(p.k_pool);
  const T* v_pool = static_cast<const T*>(p.v_pool);
  for (int pg = rank; pg < win.n_pages; pg += n_ranks) {
    const long long page = p.page_table[(long long)b * p.P + pg];
    for (int off = 0; off < p.page_size; off += BK) {
      const int col0 = pg * p.page_size + off;
      if (col0 > win.last_pos) break;
      const int nk =
          min(min(BK, p.page_size - off), win.last_pos - col0 + 1);
      const long long base = (page * p.page_size + off) * row_stride + h * D;
      __syncthreads();  // the previous tile is no longer read
      load_rows<T, D>(k_s, D + 1, k_pool + base, row_stride, BK, nk);
      load_rows<T, D>(v_s, D, v_pool + base, row_stride, BK, nk);
      __syncthreads();
      // Interior: every key of the tile is visible to row 0, the row
      // with the tightest bound, hence to every row.
      const bool masked = col0 + nk - 1 > win.length;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        if (r >= p.q_rows) break;  // uniform across the warp
        const int bound = win.length + min(r, win.q_live - 1);
        auto visible = [&](int j) { return col0 + j <= bound; };
        attend_tile<D, BK>(st[i], q_s + r * D, k_s, v_s, nk, p.scale, masked,
                           visible);
      }
    }
  }

  // This CTA's partial, m in log2 units as the merge takes it.
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= p.q_rows) break;
    if (lane == 0) {
      part->m[r] = st[i].m * 1.4426950408889634f;
      part->l[r] = st[i].l;
    }
#pragma unroll
    for (int j = 0; j < RowState<D>::kPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) part->acc[r * D + d] = st[i].acc[j];
    }
  }
  merge_ranks<T, D>(p, part, o_slot, rank, n_ranks);
}

// -- launch ------------------------------------------------------------------
// Launch `kernel` on a grid (C, H, B) in clusters of (C, 1, 1).
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int n_ranks,
                    const PagedParams& p, int B, int threads, int smem,
                    cudaStream_t stream, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ranks, p.H, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The K and V pools' tensor maps: [num_pages, page_size, H, D] as the
// [B, S, H, D] of make_tile_map, a box of kPagedBK keys of one head.
int paged_maps(PagedMaps* maps, const PagedParams& p, int D) {
  const long long ss = (long long)p.H * D;
  const long long sb = (long long)p.page_size * ss;
  const int rc = sm90::make_tile_map(&maps->k, p.k_pool, p.num_pages,
                                     p.page_size, p.H, D, sb, ss, D, kPagedBK);
  if (rc != 0) return rc;
  return sm90::make_tile_map(&maps->v, p.v_pool, p.num_pages, p.page_size,
                             p.H, D, sb, ss, D, kPagedBK);
}

template <int D>
int launch_bf16(const PagedParams& p, int B, int n_ranks,
                cudaStream_t stream) {
  PagedMaps maps;
  const int rc = paged_maps(&maps, p, D);
  if (rc != 0) return rc;
  using L = PagedTile<D>;
  return launch_clusters(paged_kernel_sm90<D>, n_ranks, p, B, L::kThreads,
                         L::kBytes, stream, maps, p);
}

template <int D>
int launch_fp32(const PagedParams& p, int B, int n_ranks,
                cudaStream_t stream) {
  constexpr int BK = D <= 64 ? 64 : 32;
  const int smem = (kPagedRows * D + BK * (D + 1) + BK * D) * sizeof(float) +
                   (int)sizeof(PagedPartial<D>);
  return launch_clusters(paged_kernel_fp32<D, BK>, n_ranks, p, B, kThreads,
                         smem, stream, p);
}

template <int D>
int launch(int dtype, const PagedParams& p, int B, int n_ranks,
           cudaStream_t stream) {
  return dtype == 1 ? launch_bf16<D>(p, B, n_ranks, stream)
                    : launch_fp32<D>(p, B, n_ranks, stream);
}

}  // namespace dtpu

// dtype: 0 = float32, 1 = bfloat16. q strides in elements (head dim
// contiguous); pools [num_pages, page_size, H, D] and o contiguous; in
// bf16 the pools' base is 16-byte aligned (TMA). q_rows <= 16. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dtpu_paged_attention(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const int* page_table, const int* lengths,
    const int* q_lens, const int* active, void* o, int B, int q_rows, int H,
    int page_size, int P, int num_pages, long long q_sb, long long q_sr,
    long long q_sh, float scale, void* stream) {
  if (q_rows < 1 || q_rows > dtpu::kPagedRows || P < 1)
    return (int)cudaErrorInvalidValue;
  dtpu::PagedParams p;
  p.q = q; p.k_pool = k_pool; p.v_pool = v_pool;
  p.page_table = page_table; p.lengths = lengths; p.q_lens = q_lens;
  p.active = active; p.o = o;
  p.q_rows = q_rows; p.H = H; p.page_size = page_size; p.P = P;
  p.num_pages = num_pages;
  p.q_sb = q_sb; p.q_sr = q_sr; p.q_sh = q_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const int n_ranks = P < dtpu::kMaxRanks ? P : dtpu::kMaxRanks;
  switch (head_dim) {
    case 16: return dtpu::launch<16>(dtype, p, B, n_ranks, s);
    case 32: return dtpu::launch<32>(dtype, p, B, n_ranks, s);
    case 64: return dtpu::launch<64>(dtype, p, B, n_ranks, s);
    case 128: return dtpu::launch<128>(dtype, p, B, n_ranks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
