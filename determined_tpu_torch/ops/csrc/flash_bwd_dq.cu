// Two-pass flash-attention backward, dq pass, for Hopper (sm_90a).
//
// Replaces determined_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (launched by _flash_bwd_pallas past _FUSED_BWD_PARTIALS_CAP, beside the
// dk/dv pass of flash_bwd_dkv.cu): per live (query tile, key tile) pair
// it recomputes s = q kᵀ · scale and p = exp(s − lse) and sums
//   dq += ds·k,  ds = p ∘ (do·vᵀ − delta + dlse) · scale  (rounded to the
//                                                          input dtype)
// over the key tiles, under the full mask model (blocked_bwd.cuh).
//
// What bounds it on the H100: three products of 2·D FLOPs per live pair,
// 6·D in all. At the 32k training shape (B=1, S=32768, H=12, D=64,
// causal) that is 2.5e12 FLOPs over ~60 MB: the operations bound it
// (~2.5 ms at 989 TFLOP/s bf16).
//
// What the design does about it. q-major, as the TPU kernel: one block per
// (batch·head, query tile) stages its q, do rows and lse/delta/dlse once,
// keeps the fp32 dq accumulator in shared memory and walks only the key
// tiles its rows can see (keys_seen: the forward's range), then writes dq
// in the input dtype: every sum stays in the block, so dq is
// deterministic and needs no workspace. Products on the tensor cores for
// bf16 (wmma), fp32 FMAs for fp32 (mono_tiles.cuh).
#include "blocked_bwd.cuh"

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

}  // namespace dtpu

// dq: contiguous [B, Sq, H, D] in the input dtype; dk, dv: unused (null).
extern "C" int dtpu_flash_bwd_dq(DTPU_BLOCKED_BWD_ARGS) {
  return dtpu::blocked_entry<dtpu::DqLaunch>(DTPU_BLOCKED_BWD_NAMES);
}
