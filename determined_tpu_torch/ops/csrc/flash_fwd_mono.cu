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
// What the design does about it: the TPU kernel holds the whole [S, S]
// fp32 score matrix in VMEM (4 MB at S = 1024); a Hopper block has 227 KB.
// So here "mono" is the specialisation _mono_ok guarantees, not one tile:
// - one block per (batch·head, 64 query rows) walks the key tiles its rows
//   can see, the causal ones up to the diagonal tile only; only that
//   diagonal tile tests the mask per element, and there are no segment
//   ids, window or offset to load or test;
// - softmax is online over the key tiles (running max, sum and a rescaled
//   fp32 accumulator in shared memory); masked entries give p = 0;
// - q·kᵀ and p·v run on the tensor cores for bf16 (wmma, fp32
//   accumulation; mono_tiles.cuh) and as fp32 FMAs for fp32;
// - q/k/v/o are addressed through strides, so the [B, S, 3, H, D] QKV
//   projection feeds the kernel without a copy; the heaviest (last) query
//   tiles of a causal call are scheduled first.
// wgmma, TMA and a pipelined tile ring are later work.
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

template <typename T>
int dispatch_head_dim(int d, const MonoFwdParams& p, cudaStream_t stream) {
  // 64-row tiles where they fit beside each other (bf16, D <= 64); 32
  // rows for the wider fp32 tiles.
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
  if (Sq <= 0 || B * H <= 0) return 0;
  return dtype == 1 ? dtpu::dispatch_head_dim<__nv_bfloat16>(head_dim, p, s)
                    : dtpu::dispatch_head_dim<float>(head_dim, p, s);
}
