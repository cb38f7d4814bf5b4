// Shared pieces of the blocked flash-attention backward kernels
// (flash_bwd_blocked.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu): the launch
// parameters, the mask model and the live tile ranges, and for their fp32
// paths the shared-memory layout and the p / ds formula (the bf16 paths
// are the sm90 kernels: bwd_blocked_sm90.cuh, flash_bwd_dq.cu).
//
// The mask model is the forward's (flash_fwd.cu): query row r sits at
// position g = r + kv_offset of the key frame; with `causal` it sees keys
// c <= g, with a `window` W also only keys c > g − W, and with segment ids
// only keys of its own id. The TPU kernels sort every (query tile, key
// tile) pair into skip / edge / interior (_mask_dispatch); here the skip
// regime is the bounds of the tile loops (a k-major block walks only the
// query tiles that can see its key tile, a q-major block only the key
// tiles its rows can see), and an interior pair skips the per-element
// band test. Segment ids are tested per element whenever given.
//
// A row that sees no key at all carries lse ≈ −1e30, where exp(s − lse)
// would resurrect its masked entries as 1: p is zeroed wherever the mask
// is false, never left to exp underflow.
#pragma once

#include "mono_tiles.cuh"

namespace dtpu {

struct BlockedBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Sq, H]
  const float* delta;  // [B, Sq, H]
  const float* dlse;   // [B, Sq, H] or null (zeros)
  const int* qseg;     // [B, Sq] or null
  const int* kseg;     // [B, Sk] or null
  void* dq;            // see each kernel's entry point
  void* dk;            // [B, Sk, H, D] input dtype
  void* dv;            // [B, Sk, H, D] input dtype
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int causal;
  int window;  // <= 0: no window
  int kv_offset;
  float scale;
};

// Shared memory of one block: BQ query rows and BK keys of one (batch,
// head). Input tiles in the input dtype, the s and dp tiles in fp32, p
// and ds in the input dtype (the roundings of the TPU kernels), two fp32
// accumulator tiles (dk and dv, or dq), the per-row lse/delta/dlse and the
// segment ids of both tiles. The fused kernel's dq tile reuses the s/dp
// bytes once ds is formed.
template <typename T, int D, int BQ, int BK>
struct BlockedLayout {
  static_assert(BQ == BK, "the accumulator tiles are sized for BQ == BK");
  static constexpr int kLdD = ld_of<T>(D);       // q, k, v, do tiles
  static constexpr int kLdP = ld_of<T>(BK);      // p, ds tiles
  static constexpr int kLdS = ld_of<float>(BK);  // fp32 s, dp
  static constexpr int kLdF = ld_of<float>(D);   // fp32 accumulators
  static constexpr int kK = 0;
  static constexpr int kV = kK + tile_bytes<T>(BK, D);
  static constexpr int kQ = kV + tile_bytes<T>(BK, D);
  static constexpr int kDo = kQ + tile_bytes<T>(BQ, D);
  static constexpr int kS = kDo + tile_bytes<T>(BQ, D);
  static constexpr int kDp = kS + tile_bytes<float>(BQ, BK);
  static constexpr int kSBytes =
      2 * tile_bytes<float>(BQ, BK) > tile_bytes<float>(BQ, D)
          ? 2 * tile_bytes<float>(BQ, BK)
          : tile_bytes<float>(BQ, D);
  static constexpr int kP = kS + kSBytes;
  static constexpr int kDs = kP + tile_bytes<T>(BQ, BK);
  static constexpr int kAcc0 = kDs + tile_bytes<T>(BQ, BK);
  static constexpr int kAcc1 = kAcc0 + tile_bytes<float>(BK, D);
  static constexpr int kRows = kAcc1 + tile_bytes<float>(BK, D);
  static constexpr int kSegs = kRows + 3 * BQ * 4;
  static constexpr int kBytes = kSegs + (BQ + BK) * 4;
};

// Query rows [lo, hi] that can see a key of the tile [k0, k0 + nk): with
// causal masking from the first row whose position reaches k0, with a
// window up to the last row whose band still reaches the tile's last key.
// Empty when lo > hi.
__device__ __forceinline__ void rows_seeing(const BlockedBwdParams& p, int k0,
                                            int nk, int* lo, int* hi) {
  *lo = p.causal ? max(0, k0 - p.kv_offset) : 0;
  *hi = p.Sq - 1;
  if (p.window > 0)
    *hi = min(*hi, k0 + nk - 1 + p.window - 1 - p.kv_offset);
}

// Keys [lo, hi] that a row of the tile [q0, q0 + nq) can see (the
// forward's range). Empty when lo > hi.
__device__ __forceinline__ void keys_seen(const BlockedBwdParams& p, int q0,
                                          int nq, int* lo, int* hi) {
  const int first_q = q0 + p.kv_offset;
  const int last_q = q0 + nq - 1 + p.kv_offset;
  *lo = 0;
  *hi = p.Sk - 1;
  if (p.causal) *hi = min(*hi, last_q);
  if (p.window > 0) *lo = max(*lo, first_q - (p.window - 1));
}

// Every (row, key) pair of the two tiles lies inside the band: only
// segment ids (if any) mask elements.
__device__ __forceinline__ bool tile_inside(const BlockedBwdParams& p, int q0,
                                            int nq, int k0, int nk) {
  const int first_q = q0 + p.kv_offset;
  const int last_q = q0 + nq - 1 + p.kv_offset;
  bool inside = true;
  if (p.causal) inside = inside && k0 + nk - 1 <= first_q;
  if (p.window > 0) inside = inside && k0 >= last_q - (p.window - 1);
  return inside;
}

// Stage the block's query-side rows: q and do tiles, lse / delta / dlse
// (zeros past the sequence) and the query segment ids.
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void stage_query_tile(const BlockedBwdParams& p,
                                                 unsigned char* smem, int b,
                                                 int h, int q0, int nq) {
  using L = BlockedLayout<T, D, BQ, BK>;
  stage_rows<T, D>(reinterpret_cast<T*>(smem + L::kQ), L::kLdD,
                   static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                       (long long)q0 * p.q_ss,
                   p.q_ss, BQ, nq);
  stage_rows<T, D>(reinterpret_cast<T*>(smem + L::kDo), L::kLdD,
                   static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
                       (long long)q0 * p.do_ss,
                   p.do_ss, BQ, nq);
  float* lse_s = reinterpret_cast<float*>(smem + L::kRows);
  int* qseg_s = reinterpret_cast<int*>(smem + L::kSegs);
  for (int r = threadIdx.x; r < BQ; r += kMonoThreads) {
    const long long at = ((long long)b * p.Sq + q0 + r) * p.H + h;
    const bool ok = r < nq;
    lse_s[r] = ok ? p.lse[at] : 0.f;
    lse_s[BQ + r] = ok ? p.delta[at] : 0.f;
    lse_s[2 * BQ + r] = ok && p.dlse != nullptr ? p.dlse[at] : 0.f;
    if (p.qseg != nullptr)
      qseg_s[r] = ok ? p.qseg[(long long)b * p.Sq + q0 + r] : 0;
  }
}

// Stage the block's key-side rows: k and v tiles and the key segment ids.
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void stage_key_tile(const BlockedBwdParams& p,
                                               unsigned char* smem, int b,
                                               int h, int k0, int nk) {
  using L = BlockedLayout<T, D, BQ, BK>;
  stage_rows<T, D>(reinterpret_cast<T*>(smem + L::kK), L::kLdD,
                   static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
                       (long long)k0 * p.k_ss,
                   p.k_ss, BK, nk);
  stage_rows<T, D>(reinterpret_cast<T*>(smem + L::kV), L::kLdD,
                   static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
                       (long long)k0 * p.v_ss,
                   p.v_ss, BK, nk);
  int* kseg_s = reinterpret_cast<int*>(smem + L::kSegs) + BQ;
  if (p.kseg != nullptr) {
    for (int c = threadIdx.x; c < BK; c += kMonoThreads)
      kseg_s[c] = c < nk ? p.kseg[(long long)b * p.Sk + k0 + c] : 0;
  }
}

// From the staged tiles: s = q kᵀ and dp = do vᵀ (fp32), then per element
// p = exp(s · scale − lse), zeroed where masked, and
// ds = p (dp − delta + dlse) · scale, both rounded to the input dtype into
// the p and ds tiles. Block-wide; ends synchronised.
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void form_p_ds(const BlockedBwdParams& p,
                                          unsigned char* smem, int q0, int nq,
                                          int k0, int nk) {
  using L = BlockedLayout<T, D, BQ, BK>;
  const T* q_s = reinterpret_cast<const T*>(smem + L::kQ);
  const T* do_s = reinterpret_cast<const T*>(smem + L::kDo);
  const T* k_s = reinterpret_cast<const T*>(smem + L::kK);
  const T* v_s = reinterpret_cast<const T*>(smem + L::kV);
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  float* dp_s = reinterpret_cast<float*>(smem + L::kDp);
  T* p_s = reinterpret_cast<T*>(smem + L::kP);
  T* ds_s = reinterpret_cast<T*>(smem + L::kDs);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kRows);
  const int* qseg_s = reinterpret_cast<const int*>(smem + L::kSegs);
  const int* kseg_s = qseg_s + BQ;

  block_gemm<BQ, BK, D, false, true, false>(s_s, L::kLdS, q_s, L::kLdD, k_s,
                                            L::kLdD);
  block_gemm<BQ, BK, D, false, true, false>(dp_s, L::kLdS, do_s, L::kLdD, v_s,
                                            L::kLdD);
  __syncthreads();
  const bool segs = p.qseg != nullptr;
  const bool band = !tile_inside(p, q0, nq, k0, nk);
  for (int idx = threadIdx.x; idx < BQ * BK; idx += kMonoThreads) {
    const int r = idx / BK;
    const int c = idx - r * BK;
    bool live = r < nq && c < nk;
    if (band) {
      const int g = q0 + r + p.kv_offset;
      const int col = k0 + c;
      if (p.causal) live = live && g >= col;
      if (p.window > 0) live = live && g - col < p.window;
    }
    if (segs) live = live && qseg_s[r] == kseg_s[c];
    const float pv =
        live ? expf(s_s[r * L::kLdS + c] * p.scale - lse_s[r]) : 0.f;
    const float ds = pv *
                     (dp_s[r * L::kLdS + c] - lse_s[BQ + r] +
                      lse_s[2 * BQ + r]) *
                     p.scale;
    p_s[r * L::kLdP + c] = from_float<T>(pv);
    ds_s[r * L::kLdP + c] = from_float<T>(ds);
  }
  __syncthreads();
}

// Zero an fp32 accumulator tile of `rows` x D.
template <int D>
__device__ __forceinline__ void zero_acc(float* acc, int ld, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kMonoThreads) {
    const int r = idx / D;
    acc[r * ld + idx - r * D] = 0.f;
  }
}

// Write `n` rows of an fp32 accumulator tile to a contiguous [B, S, H, D]
// output in the input dtype, starting at row `row0` of (b, h).
template <typename T, int D>
__device__ __forceinline__ void write_acc(void* out, const float* acc, int ld,
                                          int b, int h, int S, int H,
                                          int row0, int n) {
  T* o = static_cast<T*>(out) + (((long long)b * S + row0) * H + h) * D;
  for (int idx = threadIdx.x; idx < n * D; idx += kMonoThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    o[(long long)r * H * D + d] = from_float<T>(acc[r * ld + d]);
  }
}

// Set the attribute for the layout's dynamic shared memory and launch one
// block of kMonoThreads per (grid.x tile, batch·head).
template <typename Kernel>
int launch_blocked(Kernel kernel, int bytes, int tiles,
                   const BlockedBwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, p.B * p.H);
  kernel<<<grid, kMonoThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The fp32 kernels: Launch<float, D, 32, 32>::run for the head dim (32-row
// tiles, as the mono backward's fp32 path).
template <template <typename, int, int, int> class Launch>
int dispatch_blocked_fp32(int d, const BlockedBwdParams& p,
                          cudaStream_t stream) {
  switch (d) {
    case 16: return Launch<float, 16, 32, 32>::run(p, stream);
    case 32: return Launch<float, 32, 32, 32>::run(p, stream);
    case 64: return Launch<float, 64, 32, 32>::run(p, stream);
    case 128: return Launch<float, 128, 32, 32>::run(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The entry points' parameters from their C arguments.
inline BlockedBwdParams make_blocked_params(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* dlse, const int* qseg,
    const int* kseg, void* dq, void* dk, void* dv, int B, int H, int Sq,
    int Sk, const long long* strides, int causal, int window, int kv_offset,
    float scale) {
  BlockedBwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = lse; p.delta = delta; p.dlse = dlse;
  p.qseg = qseg; p.kseg = kseg;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.do_sb = strides[9]; p.do_ss = strides[10]; p.do_sh = strides[11];
  p.causal = causal; p.window = window; p.kv_offset = kv_offset;
  p.scale = scale;
  return p;
}

}  // namespace dtpu

// The C signature shared by the three entry points. Strides are in
// elements with the head dim contiguous: q, k, v, do as (batch, seq,
// head) triples, 12 values. lse/delta/dlse are contiguous [B, Sq, H] fp32
// (dlse may be null), segment ids contiguous int32 [B, S] (both null
// without segments). Returns cudaGetLastError() after the launch (0 =
// launched).
#define DTPU_BLOCKED_BWD_ARGS                                               \
  int dtype, int head_dim, const void *q, const void *k, const void *v,     \
      const void *dout, const float *lse, const float *delta,               \
      const float *dlse, const int *qseg, const int *kseg, void *dq,        \
      void *dk, void *dv, int B, int H, int Sq, int Sk,                     \
      const long long *strides, int causal, int window, int kv_offset,      \
      float scale, void *stream
