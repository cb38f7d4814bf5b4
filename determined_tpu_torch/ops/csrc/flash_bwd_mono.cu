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
// What the design does about it. dk and dv sum over query tiles while dq
// sums over key tiles, and blocks run in no order. Of the two designs on
// offer — (a) one block per (batch, head) walking key tiles outer with dq
// in a private fp32 workspace, deterministic but only B·H = 96 blocks for
// 132 SMs at the training shape, or (b) one block per (batch, head, key
// tile) with dq through fp32 atomics — this kernel takes (b): B·H·S/64 =
// 1536 blocks at that shape keep every SM busy. Each block keeps its key
// tile's k, v and fp32 dk, dv accumulators in shared memory and walks the
// query tiles that can see it (causal: from its diagonal tile down); per
// query tile it adds ds·k into an fp32 [B, S, H, D] workspace with
// atomicAdd, which the wrapper casts to the input dtype. The order of
// those fp32 additions changes from run to run: dq is not bitwise
// deterministic (about 1e-6 relative at fp32). All five products run on
// the tensor cores for bf16 (wmma, fp32 accumulation) and as fp32 FMAs
// for fp32 (mono_tiles.cuh). wgmma, TMA and register-resident
// accumulators are later work.
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

template <typename T>
int dispatch_head_dim(int d, const MonoBwdParams& p, cudaStream_t stream) {
  // 64-row tiles for bf16 up to D = 64 (125 KB of shared memory at
  // D = 64); 32 rows for fp32 and for D = 128.
  constexpr bool kWide = std::is_same<T, __nv_bfloat16>::value;
  switch (d) {
    case 16: return launch<T, 16, kWide ? 64 : 32, kWide ? 64 : 32>(p, stream);
    case 32: return launch<T, 32, kWide ? 64 : 32, kWide ? 64 : 32>(p, stream);
    case 64: return launch<T, 64, kWide ? 64 : 32, kWide ? 64 : 32>(p, stream);
    case 128: return launch<T, 128, 32, 32>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dtpu

// dtype: 0 = float32, 1 = bfloat16. q/k/v/do strides are in elements with
// the head dim contiguous; lse/delta/dlse are contiguous [B, Sq, H] fp32,
// dq a zeroed contiguous fp32 [B, Sq, H, D], dk/dv contiguous
// [B, Sk, H, D] in the input dtype. Returns cudaGetLastError() after the
// launch (0 = launched).
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
  if (Sk <= 0 || B * H <= 0) return 0;
  return dtype == 1 ? dtpu::dispatch_head_dim<__nv_bfloat16>(head_dim, p, s)
                    : dtpu::dispatch_head_dim<float>(head_dim, p, s);
}
