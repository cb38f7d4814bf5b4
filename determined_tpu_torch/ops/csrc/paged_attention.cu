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
// FLOP per byte, far below the 295 FLOP/byte ridge).
//
// What the design does about it:
// - Only live pages are read. The TPU kernel's scalar prefetch becomes a
//   block loading its own page_table row, lengths, q_lens and active; the
//   page loop runs over 0..(lengths + q_lens - 1) // page_size only, so a
//   dead page-table entry is never even dereferenced (the TPU version
//   clamped dead grid steps onto the last live page to elide their DMA).
//   Within the boundary page, the tile stops at the last live position.
// - One block per (slot, head): each K/V tile is read once and reused by
//   all of the slot's query rows from shared memory.
// - Pages interior to every real row's visible range skip the element
//   mask; the boundary band applies the per-row bound.
// page_size needs no alignment here: a page is walked in BK-key tiles and
// the last tile of a page may be short (the TPU's 128-lane rule is gone).
#include "attn_common.cuh"

namespace dtpu {

struct PagedParams {
  const void* q;        // [B, q_rows, H, D] through strides
  const void* k_pool;   // [num_pages, page_size, H, D] contiguous
  const void* v_pool;
  const int* page_table;  // [B, P]
  const int* lengths;     // [B]
  const int* q_lens;      // [B]
  const int* active;      // [B]
  void* o;                // [B, q_rows, H, D] contiguous
  int q_rows, H, page_size, P;
  long long q_sb, q_sr, q_sh;
  float scale;
};

template <typename T, int D, int BK, int MAX_ROWS>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const PagedParams p) {
  constexpr int kRowsPerWarp = MAX_ROWS / kWarps;
  extern __shared__ float smem[];
  float* q_s = smem;                // [MAX_ROWS][D]
  float* k_s = q_s + MAX_ROWS * D;  // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);  // [BK][D]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long row_stride = (long long)p.H * D;  // o and pool rows
  T* o = static_cast<T*>(p.o) + ((long long)b * p.q_rows * p.H + h) * D;
  if (p.active[b] == 0) {
    for (int idx = threadIdx.x; idx < p.q_rows * D; idx += kThreads)
      o[(idx / D) * row_stride + idx % D] = from_float<T>(0.f);
    return;
  }
  const int length = p.lengths[b];
  const int q_live = p.q_lens[b];
  const int last_pos = length + q_live - 1;
  const int n_pages = min(last_pos / p.page_size + 1, p.P);
  const int warp = threadIdx.x >> 5;

  load_rows<T, D>(q_s, D,
                  static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_sr, MAX_ROWS, p.q_rows);
  RowState<D> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  const T* k_pool = static_cast<const T*>(p.k_pool);
  const T* v_pool = static_cast<const T*>(p.v_pool);
  for (int pg = 0; pg < n_pages; ++pg) {
    const long long page = p.page_table[(long long)b * p.P + pg];
    for (int off = 0; off < p.page_size; off += BK) {
      const int col0 = pg * p.page_size + off;
      if (col0 > last_pos) break;
      const int nk = min(min(BK, p.page_size - off), last_pos - col0 + 1);
      const long long base = (page * p.page_size + off) * row_stride + h * D;
      __syncthreads();  // the previous tile is no longer read
      load_rows<T, D>(k_s, D + 1, k_pool + base, row_stride, BK, nk);
      load_rows<T, D>(v_s, D, v_pool + base, row_stride, BK, nk);
      __syncthreads();
      // Interior: every key of the tile is visible to row 0, the row
      // with the tightest bound, hence to every row.
      const bool masked = col0 + nk - 1 > length;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        if (r >= p.q_rows) break;  // uniform across the warp
        const int bound = length + min(r, q_live - 1);
        auto visible = [&](int j) { return col0 + j <= bound; };
        attend_tile<D, BK>(st[i], q_s + r * D, k_s, v_s, nk, p.scale, masked,
                           visible);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= p.q_rows) break;
    write_row<T, D>(st[i], o + r * row_stride, nullptr);
  }
}

template <typename T, int D>
int launch(const PagedParams& p, int B, cudaStream_t stream) {
  constexpr int BK = D <= 64 ? 64 : 32;
  constexpr int MAX_ROWS = 16;
  const size_t smem = (MAX_ROWS * D + BK * (D + 1) + BK * D) * sizeof(float);
  auto kernel = paged_kernel<T, D, BK, MAX_ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int d, const PagedParams& p, int B,
                      cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtpu

// dtype: 0 = float32, 1 = bfloat16. q strides in elements (head dim
// contiguous); pools and o contiguous. q_rows <= 16. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dtpu_paged_attention(
    int dtype, int head_dim, const void* q, const void* k_pool,
    const void* v_pool, const int* page_table, const int* lengths,
    const int* q_lens, const int* active, void* o, int B, int q_rows, int H,
    int page_size, int P, long long q_sb, long long q_sr, long long q_sh,
    float scale, void* stream) {
  if (q_rows < 1 || q_rows > 16) return (int)cudaErrorInvalidValue;
  dtpu::PagedParams p;
  p.q = q; p.k_pool = k_pool; p.v_pool = v_pool;
  p.page_table = page_table; p.lengths = lengths; p.q_lens = q_lens;
  p.active = active; p.o = o;
  p.q_rows = q_rows; p.H = H; p.page_size = page_size; p.P = P;
  p.q_sb = q_sb; p.q_sr = q_sr; p.q_sh = q_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  return dtype == 1
             ? dtpu::dispatch_head_dim<__nv_bfloat16>(head_dim, p, B, s)
             : dtpu::dispatch_head_dim<float>(head_dim, p, B, s);
}
