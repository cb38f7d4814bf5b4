// Blocked flash-attention forward for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd_pallas): online-softmax attention with the band mask (causal,
// sliding `window`, `kv_offset`) and packed-sequence segment ids, giving o
// (input dtype) and lse (fp32).
//
// What bounds it on the H100: the work is the two score-matrix products,
// 4·Dh FLOPs per live (query, key) pair. At the serving prefill shape
// (B=4, S=512, H=12, Dh=64, causal) that is about S/4 = 128 FLOPs per byte
// of q/k/v/o read once — below the card's 295 FLOP/byte bf16 ridge, and
// packed documents cut the live pairs further — so the roofline bound is
// the bytes. This first kernel, though, runs the products as fp32 FMAs
// from shared memory (no tensor cores): its own limit is that arithmetic
// and the shared-memory reads feeding it, far above the bound;
// mma/wgmma tiles are later work.
//
// What the design does about it:
// - Work that the mask proves dead is never done. The TPU kernel's DMA
//   remap of dead grid steps (_remap_k_index) becomes the bounds of the
//   K/V tile loop: a block walks only the key tiles its rows can see
//   (causal: up to its last row; window: from its first row's band
//   start). Inside that range, a tile fully inside the band skips the
//   per-element band test (the interior regime of _mask_dispatch); edge
//   tiles apply it. Segment ids are tested per element whenever given.
// - Each K/V tile is read from device memory once per block and reused by
//   all BQ query rows of the block from shared memory.
// - One block per (batch·head, BQ query rows); q/k/v/o are addressed
//   through strides, so the [B, S, 3, H, Dh] QKV projection feeds the
//   kernel without a transpose or copy.
#include "attn_common.cuh"

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
  return dtype == 1 ? dtpu::dispatch_head_dim<__nv_bfloat16>(head_dim, p, s)
                    : dtpu::dispatch_head_dim<float>(head_dim, p, s);
}
